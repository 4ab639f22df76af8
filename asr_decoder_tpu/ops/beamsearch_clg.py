"""CLG-on-the-fly batched beam search: decode CLG ⊗ HMM without HCLG.

Device-side re-design of the reference's CLG decoder
(ref: src/my-decoder/online-clg-decoder-mempool-base.h:31-206 +
clg-fst.h:9-189).  The reference nests clg-arc × hmm-arc loops inside
ProcessEmitting; on the device the composite is flattened into the uniform
virtual automaton of ``fst/clg.py`` (HMM entry/exit as ε hops), so each
stage stays a fixed-lane row-gather + relax over flat-2D candidates —
the same shape as the HCLG kernel:

  * emitting stage: only HMM virtual states expand; the arc row is found
    by *table indirection* — ``row = hmm_row_base[arcid] + hmmstate`` —
    instead of a per-virtual-state table (the whole point of CLG is not
    to materialise the expansion).  Destinations are arithmetic:
    self-loop → v, forward → v + offset
    (ref MapClgTokenStateId, clg-fst.h:146-151).
  * ε stage: CLG-resident tokens expand CLG ε arcs + HMM entry hops from
    one padded per-CLG-state record table; HMM-resident tokens get one
    exit-hop lane (``dst = clg_dst[arcid]``, ref :140-144); plus the
    stay block.

Virtual ids stay in i32 (``offset·(H+2) < 2³¹`` checked at load, ref
clg-fst.h:26 asserts the same bound).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.clg import ClgFst
from asr_decoder_tpu.fst.fst import EPSILON
from asr_decoder_tpu.ops.beamsearch import (ARC_STAY, INF, NO_STATE,
                                            _bits_to_f32, _lane_iota,
                                            _relax_and_prune)
from asr_decoder_tpu.ops.gather import batched_table_gather

ARC_EXIT = -3   # log sentinel: HMM exit hop (no arc table entry)


class ClgGraphArrays(NamedTuple):
    clg_eps_rec: jax.Array   # i32[S_clg, 3·Ae] flat field-major rows:
                             #   dst_virtual | w-bits | eidx
    arc_tab: jax.Array       # i32[num_arcs+1, 2]: hmm_row_base | clg_dst
    hmm_em_rec: jax.Array    # i32[R, 3·Ah]: delta | pdf | w-bits
    hmm_exit: jax.Array      # i32[R, 2]: has_exit | w-bits
    start: jax.Array
    final_state: jax.Array


def make_clg_graph_arrays(g: ClgFst, ilabel2pdf: np.ndarray):
    """(device arrays, host decode tables): pack the composite for the
    kernel.  Host tables: ``eps_arc`` (eidx → CLG arc id, = identity) and
    ``hmm_il[R, Ah]`` (emitting aid → HMM ilabel)."""
    clg = g.clg
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    S = clg.num_states
    offset = g.offset

    # --- per-CLG-state ε record rows (real ε + entry hops) ---------------
    # vectorized: arc i of state s lands on lane (i - state_offset[s]);
    # dst is the CLG ε destination for real ε arcs, the virtual HMM-entry
    # id (i + offset) otherwise
    deg = np.diff(clg.state_offset)
    Ae = max(int(deg.max()) if S else 0, 1)
    eps_rec = np.zeros((S, 3, Ae), np.int32)
    eps_rec[:, 0, :] = -1
    if clg.num_arcs:
        arc_i = np.arange(clg.num_arcs, dtype=np.int64)
        src = np.repeat(np.arange(S, dtype=np.int64), deg)
        lane = arc_i - clg.state_offset[:-1][src]
        is_real_eps = arc_i < clg.state_eps_end[src]
        dst = np.where(is_real_eps, clg.arc_dst.astype(np.int64),
                       arc_i + offset)
        eps_rec[src, 0, lane] = dst.astype(np.int32)
        eps_rec[src, 1, lane] = clg.arc_weight.astype(np.float32) \
            .view(np.int32)
        eps_rec[src, 2, lane] = arc_i.astype(np.int32)

    # --- HMM row block: unique HMMs concatenated --------------------------
    used = sorted(set(int(x) for x in clg.arc_ilabel[clg.arc_ilabel !=
                                                     EPSILON]))
    row_start = {}
    R = 0
    Ah = 1
    for il in used:
        row_start[il] = R
        h = g.hmms[il]
        R += h.num_states
        em_deg = (np.diff(h.state_offset) -
                  (h.state_eps_end - h.state_offset[:-1]))
        if len(em_deg):
            Ah = max(Ah, int(em_deg.max()))
    R = max(R, 1)
    hmm_em = np.zeros((R, 3, Ah), np.int32)
    hmm_em[:, 0, :] = -1
    hmm_il = np.zeros((R, Ah), np.int32)
    hmm_exit = np.zeros((R, 2), np.int32)
    for il in used:
        h = g.hmms[il]
        base = row_start[il]
        for s in range(h.num_states):
            r = base + s
            ee = int(h.state_eps_end[s])
            lo, hi = h.arc_range(s)
            lane = 0
            exit_w = np.inf
            for i in range(lo, hi):
                if int(h.arc_ilabel[i]) == EPSILON:
                    exit_w = min(exit_w, float(h.arc_weight[i]))
                    continue
                d = int(h.arc_dst[i])
                hmm_em[r, 0, lane] = 0 if d == s else 1
                hmm_em[r, 1, lane] = ilabel2pdf[int(h.arc_ilabel[i])]
                hmm_em[r, 2, lane] = np.float32(h.arc_weight[i]) \
                    .view(np.int32)
                hmm_il[r, lane] = h.arc_ilabel[i]
                lane += 1
            if np.isfinite(exit_w):
                hmm_exit[r, 0] = 1
                hmm_exit[r, 1] = np.float32(exit_w).view(np.int32)

    arc_tab = np.zeros((clg.num_arcs + 1, 2), np.int32)
    if clg.num_arcs:
        row_lut = np.zeros(int(clg.arc_ilabel.max()) + 1, np.int32)
        for il, r in row_start.items():
            row_lut[il] = r
        arc_tab[:-1, 0] = row_lut[clg.arc_ilabel]
        arc_tab[:-1, 1] = clg.arc_dst

    arrays = ClgGraphArrays(
        clg_eps_rec=jnp.asarray(eps_rec.reshape(S, 3 * Ae)),
        arc_tab=jnp.asarray(arc_tab),
        hmm_em_rec=jnp.asarray(hmm_em.reshape(R, 3 * Ah)),
        hmm_exit=jnp.asarray(hmm_exit),
        start=jnp.int32(clg.start), final_state=jnp.int32(clg.final_state))
    return arrays, hmm_il


def _split_tokens(state, *, offset):
    """(in_hmm bool[B,K], arcid i32[B,K], row-local hmm state i32[B,K])."""
    valid = state != NO_STATE
    in_hmm = valid & (state >= offset)
    v_safe = jnp.where(in_hmm, state, offset)
    arcid = v_safe % offset
    hs = v_safe // offset - 1
    return valid, in_hmm, arcid, hs


def _emit_stage(g: ClgGraphArrays, state, cost, ll, *, cfg):
    """Emitting expansion from HMM virtual states: two-level indirection
    (arc → hmm row → arc lanes) replaces the reference's nested loops
    (ref online-clg-decoder-mempool-base.h:120-204)."""
    K, Ah = cfg["K"], cfg["Ah"]
    offset = cfg["offset"]
    B = state.shape[0]
    N = K * Ah
    valid, in_hmm, arcid, hs = _split_tokens(state, offset=offset)
    atab = g.arc_tab[arcid]                                 # [B,K,2]
    row = jnp.where(in_hmm, atab[:, :, 0] + hs, 0)
    rows = g.hmm_em_rec[row]                                # [B,K,3*Ah]
    delta = rows[:, :, 0 * Ah:1 * Ah].reshape(B, N)
    pdf = rows[:, :, 1 * Ah:2 * Ah].reshape(B, N)
    w = _bits_to_f32(rows[:, :, 2 * Ah:3 * Ah]).reshape(B, N)
    in_hmmN = jnp.repeat(in_hmm, Ah, axis=1)
    costN = jnp.repeat(cost, Ah, axis=1)
    vN = jnp.repeat(state, Ah, axis=1)
    amask = in_hmmN & (delta >= 0)
    dstN = jnp.where(amask, vN + delta * offset, 0)
    am = batched_table_gather(ll, jnp.where(amask, pdf, 0))
    candN = jnp.where(amask, costN + w - cfg["acoustic_scale"] * am, INF)
    rowN = jnp.repeat(row, Ah, axis=1)
    state, cost, win, keep = _relax_and_prune(
        dstN, candN, K=K, beam=cfg["beam"], min_active=cfg["min_active"])
    prev = jnp.where(keep, win // Ah, 0)
    aid = jnp.where(keep,
                    batched_table_gather(rowN, win) * Ah
                    + win % Ah,
                    ARC_STAY)
    return state, cost, prev, aid


def _eps_stage(g: ClgGraphArrays, state, cost, *, cfg):
    """One bounded ε sweep: CLG ε arcs + entry hops (CLG tokens), exit
    hops (HMM tokens), stay block."""
    K, Ae = cfg["K"], cfg["Ae"]
    offset = cfg["offset"]
    B = state.shape[0]
    N = K * Ae
    valid, in_hmm, arcid, hs = _split_tokens(state, offset=offset)
    in_clg = valid & ~in_hmm
    s_safe = jnp.where(in_clg, state, 0)
    rows = g.clg_eps_rec[s_safe]                            # [B,K,3*Ae]
    dstE = rows[:, :, 0 * Ae:1 * Ae].reshape(B, N)
    wE = _bits_to_f32(rows[:, :, 1 * Ae:2 * Ae]).reshape(B, N)
    eidx = rows[:, :, 2 * Ae:3 * Ae].reshape(B, N)
    in_clgN = jnp.repeat(in_clg, Ae, axis=1)
    costN = jnp.repeat(cost, Ae, axis=1)
    emask = in_clgN & (dstE >= 0)
    candE = jnp.where(emask, costN + wE, INF)
    dstE = jnp.where(emask, dstE, 0)

    # exit lane per token
    atab = g.arc_tab[arcid]
    row = jnp.where(in_hmm, atab[:, :, 0] + hs, 0)
    ex = g.hmm_exit[row]                                    # [B,K,2]
    xmask = in_hmm & (ex[:, :, 0] > 0)
    dstX = jnp.where(xmask, atab[:, :, 1], 0)
    candX = jnp.where(xmask, cost + _bits_to_f32(ex[:, :, 1]), INF)

    slot = jnp.broadcast_to(_lane_iota(K), (B, K))
    srcE = jnp.broadcast_to(_lane_iota(N), (B, N)) // Ae
    dst_all = jnp.concatenate(
        [dstE, dstX, jnp.where(valid, state, 0)], axis=1)
    cand_all = jnp.concatenate(
        [candE, candX, jnp.where(valid, cost, INF)], axis=1)
    src_all = jnp.concatenate([srcE, slot, slot], axis=1)
    aid_all = jnp.concatenate(
        [eidx, jnp.full((B, K), ARC_EXIT, jnp.int32),
         jnp.full((B, K), ARC_STAY, jnp.int32)], axis=1)
    state, cost, win, keep = _relax_and_prune(
        dst_all, cand_all, K=K, beam=cfg["beam"],
        min_active=cfg["min_active"])
    prev = jnp.where(keep, batched_table_gather(src_all, win), 0)
    aid = jnp.where(keep, batched_table_gather(aid_all, win), ARC_STAY)
    return state, cost, prev, aid


def _eps_stages(g, state, cost, *, cfg):
    K = cfg["K"]
    B = state.shape[0]
    prevs, aids = [], []
    for _ in range(cfg["E"]):
        state, cost, prev, aid = _eps_stage(g, state, cost, cfg=cfg)
        prevs.append(prev)
        aids.append(aid)
    if prevs:
        log = (jnp.stack(prevs), jnp.stack(aids))
    else:
        log = (jnp.zeros((0, B, K), jnp.int32),
               jnp.zeros((0, B, K), jnp.int32))
    return state, cost, log


@partial(jax.jit, static_argnums=(1, 2))
def _init_fn(g: ClgGraphArrays, batch: int, static_cfg: tuple):
    cfg = dict(static_cfg)
    K = cfg["K"]
    state = jnp.full((batch, K), NO_STATE, jnp.int32)
    cost = jnp.full((batch, K), INF, jnp.float32)
    state = state.at[:, 0].set(g.start)
    cost = cost.at[:, 0].set(0.0)
    state, cost, (prev, aid) = _eps_stages(g, state, cost, cfg=cfg)
    return (state, cost), (prev, aid, state, cost)


@partial(jax.jit, static_argnums=(3,))
def _advance_fn(g: ClgGraphArrays, state, inputs, static_cfg: tuple):
    cfg = dict(static_cfg)
    loglikes, frame_mask = inputs
    K = cfg["K"]

    def scan_body(carry, xs):
        st, co = carry
        ll, mask = xs
        ns, nc, prev0, aid0 = _emit_stage(g, st, co, ll, cfg=cfg)
        ns, nc, (eprev, eaid) = _eps_stages(g, ns, nc, cfg=cfg)
        prev = jnp.concatenate([prev0[None], eprev], axis=0)
        aid = jnp.concatenate([aid0[None], eaid], axis=0)
        slot_id = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (1, 1, K), 2), prev.shape)
        m = mask[:, None]
        ns = jnp.where(m, ns, st)
        nc = jnp.where(m, nc, co)
        m3 = mask[None, :, None]
        prev = jnp.where(m3, prev, slot_id)
        aid = jnp.where(m3, aid, ARC_STAY)
        ys = [prev, aid]
        if cfg["log_snapshots"]:
            ys += [ns, nc]
        else:
            ys += [jnp.zeros((ns.shape[0], 0), jnp.int32),
                   jnp.zeros((ns.shape[0], 0), jnp.float32)]
        return (ns, nc), tuple(ys)

    lls = jnp.swapaxes(loglikes, 0, 1)
    masks = jnp.swapaxes(frame_mask, 0, 1)
    (st, co), (prevs, aids, toks, costs) = jax.lax.scan(
        scan_body, state, (lls, masks))
    return (st, co), (prevs, aids, toks, costs)


class TpuClgBeamSearch:
    """Jit-compiled batched CLG-composite beam search — the ``clg`` graph
    type of the session layer (ref decoder selection,
    src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:250-284)."""

    def __init__(self, g: ClgFst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None):
        self.config = config or DecoderConfig()
        self.config.check()
        self.g = g
        self.graph, self._hmm_il = make_clg_graph_arrays(g, ilabel2pdf)
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
        eps_iters = self.config.eps_iters or g.eps_depth()
        K = min(self.config.beam_width, self.config.max_active)
        self._static = tuple(sorted(dict(
            K=K,
            Ah=int(self.graph.hmm_em_rec.shape[1]) // 3,
            Ae=int(self.graph.clg_eps_rec.shape[1]) // 3,
            E=eps_iters,
            offset=g.offset,
            beam=float(self.config.beam),
            min_active=int(self.config.min_active),
            acoustic_scale=float(self.config.acoustic_scale),
            log_snapshots=bool(self.config.log_snapshots),
        ).items()))
        self.beam_width = K
        self.num_stages = 1 + eps_iters

    def init_state(self, batch: int):
        return _init_fn(self.graph, batch, self._static)

    def advance(self, state, loglikes, frame_mask=None):
        loglikes = jnp.asarray(loglikes, jnp.float32)
        B, T, _ = loglikes.shape
        if frame_mask is None:
            frame_mask = jnp.ones((B, T), bool)
        return _advance_fn(self.graph, state,
                           (loglikes, jnp.asarray(frame_mask)),
                           self._static)

    def decode(self, loglikes, frame_mask=None):
        B = loglikes.shape[0]
        state, init_log = self.init_state(B)
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    def token_sets(self, init_log, logs, b: int,
                   num_frames: int | None = None) -> list[dict[int, float]]:
        """Per-frame surviving-token sets {virtual_state: cost} for
        utterance ``b`` (index 0 = post-init ε-closure)."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        T = np.asarray(logs[2]).shape[0]
        if num_frames is None:
            num_frames = T
        snaps = [(np.asarray(init_log[2][b]), np.asarray(init_log[3][b]))]
        snaps += [(np.asarray(logs[2][t, b]), np.asarray(logs[3][t, b]))
                  for t in range(num_frames)]
        out = []
        for st, co in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict[int, float] = {}
            for s, c in zip(st[ok], co[ok]):
                s, c = int(s), float(c)
                if c < toks.get(s, np.inf):
                    toks[s] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log, logs, loglikes, frame_mask=None):
        """Raw lattices over the virtual composite (ilabels = HMM arc
        inputs, olabels = CLG words) — the CLG decoder's GetRawLattice
        (ref: src/my-decoder/online-decoder-base-inl.h:869-977 inherited
        by the CLG variant)."""
        from asr_decoder_tpu.decoder.raw_lattice import (
            ClgExpander, lattice_from_token_sets_generic)
        loglikes = np.asarray(loglikes)
        B, T = loglikes.shape[:2]
        lens = (np.asarray(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        exp = ClgExpander(self.g)
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets_generic(
                    exp, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    def traceback(self, state, init_log, logs):
        """Best path per utterance: words from CLG arc olabels (ε/entry
        hops), ilabels from the emitting HMM arcs.  ``logs``: merged log
        tuple or a list of per-chunk logs (walked without concatenation)."""
        tok_state, tok_cost = (np.asarray(state[0]), np.asarray(state[1]))
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(np.asarray(c[0]), np.asarray(c[1])) for c in chunks]
        iprev, iaid = (np.asarray(init_log[0]), np.asarray(init_log[1]))
        clg = self.g.clg
        final_id = int(clg.final_state)
        Ah = int(self.graph.hmm_em_rec.shape[1]) // 3
        results = []
        for b in range(tok_state.shape[0]):
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                slot = int(finals[np.argmin(tok_cost[b, finals])])
                total = float(tok_cost[b, slot])
                reached_final = True
            else:
                slot = int(np.argmin(tok_cost[b]))
                total = float(tok_cost[b, slot])
                reached_final = False

            words_rev, il_rev = [], []

            def eat(stage: int, a: int):
                if a < 0:
                    return
                if stage == 0:      # emitting: a = hmm_row*Ah + lane
                    il = int(self._hmm_il[a // Ah, a % Ah])
                    if il:
                        il_rev.append(il)
                else:               # ε stage: a = CLG arc id
                    ol = int(clg.arc_olabel[a])
                    if ol:
                        words_rev.append(ol)

            for prevs, aids in reversed(chunks):
                for t in range(prevs.shape[0] - 1, -1, -1):
                    for s in range(prevs.shape[1] - 1, -1, -1):
                        eat(s, int(aids[t, s, b, slot]))
                        slot = int(prevs[t, s, b, slot])
            for s in range(iprev.shape[0] - 1, -1, -1):
                eat(s + 1, int(iaid[s, b, slot]))
                slot = int(iprev[s, b, slot])
            results.append(dict(words=words_rev[::-1],
                                ilabels=il_rev[::-1], cost=total,
                                reached_final=reached_final))
        return results
