"""BigLM in-search decoding: batched (fst_state, lm_state) pair beam search.

Device-side re-design of the reference's flagship decoder variant
``OnlineLatticeDecoderMempoolBaseBiglm``
(ref: src/my-decoder/online-decoder-mempool-base-biglm.h:12-574): during the
search every word-olabel arc additionally advances a *difference LM*
(lm2·G₂ − lm1·G₁, ref DiffArpaLm src/newlm/diff-lm.h) and folds its score
into the graph cost, so the big LM shapes pruning instead of rescoring a
pruned lattice after the fact.

Where the reference keys its token hash by ``PairId = fst_state |
(lm_state << 32)`` (ref :77-90), this search carries the two component LM
states as extra beam lanes (``tok_lm1/tok_lm2 i32[B,K]``) and merges
candidates on the composite (dst, lm1, lm2) key — the ``extra_keys``
path of ``_relax_and_prune``.

LM lookups are the expensive part: every candidate with a word olabel needs
a backoff-chased probe into both LMs (``lm/device_lm.py``).  Word olabels
are sparse in HCLG arcs, so candidates are *compacted* first — one stable
sort by has-word brings all word candidates to the front, the LM is probed
on the first ``lm_lanes`` lanes only, and the relax simply consumes the
permuted candidate arrays (relaxation is order-free).  Overflow (more word
candidates than lanes) is logged per frame and those candidates are dropped
— size ``lm_lanes`` to the graph (tests run with lm_lanes = K·A ⇒ exact).

ε-arcs can carry word olabels too (the reference's ProcessNonemitting also
queries the LM, ref :405-469), so BigLM decoding always runs in ``sweeps``
ε mode — the precomputed closure would collapse multi-word ε-paths.

Final costs add the difference LM's sentence-end cost
(ref ComputeFinalCosts :161-216) — applied host-side in ``traceback`` over
the K final candidates.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.lm.device_lm import DeviceDiffLm, lm_get_arc_tables
from asr_decoder_tpu.ops.beamsearch import (
    ARC_STAY, INF, NO_STATE, _bits_to_f32, _lane_iota, _pack_records,
    _relax_and_prune)
from asr_decoder_tpu.ops.gather import batched_table_gather


class BigLmGraphArrays(NamedTuple):
    em_rec: jax.Array       # i32[S, 5·A] flat field-major rows:
                            #   dst | pdf | w-bits | arcid | olabel
    eps_rec: jax.Array      # i32[S, 4·Ae]: dst | w-bits | eps-idx | olabel
    start: jax.Array
    final_state: jax.Array


class BigLmBeamState(NamedTuple):
    tok_state: jax.Array    # i32[B,K]
    tok_cost: jax.Array     # f32[B,K]
    tok_lm1: jax.Array      # i32[B,K]
    tok_lm2: jax.Array      # i32[B,K]


class BigLmFrameLog(NamedTuple):
    prev_slot: jax.Array    # i32[stages,B,K]  (advance: [T,stages,B,K])
    arc_id: jax.Array       # i32[stages,B,K]
    overflow: jax.Array     # bool[B] (advance: [T,B]) — word cands dropped
    # post-frame surviving-token snapshots (log_snapshots; zero-width off):
    # pair-state identity (fst, lm1, lm2) + cost — all the host needs for
    # exact raw-lattice reconstruction over the pair automaton
    tok_state: jax.Array    # i32[B,K]  (advance: [T,B,K])
    tok_cost: jax.Array     # f32[B,K]
    tok_lm1: jax.Array      # i32[B,K]
    tok_lm2: jax.Array      # i32[B,K]


def make_biglm_graph_arrays(dev: DeviceFst,
                            ilabel2pdf: np.ndarray) -> BigLmGraphArrays:
    """Padded record tables with the olabel field the pair search needs."""
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    em_pdf = ilabel2pdf[dev.em_ilabel]
    A = max(dev.max_em_degree, 1)
    em_idx = np.arange(len(dev.em_dst), dtype=np.int32)
    em_rec = _pack_records(dev.em_offset, dev.em_count, A,
                           dev.em_dst, em_pdf, dev.em_weight, em_idx,
                           dev.em_olabel)
    Ae = max(dev.max_eps_degree, 1)
    eps_idx = np.arange(len(dev.eps_dst), dtype=np.int32)
    eps_rec = _pack_records(dev.eps_offset, dev.eps_count, Ae,
                            dev.eps_dst, dev.eps_weight, eps_idx,
                            dev.eps_olabel) \
        if len(dev.eps_dst) else np.zeros((dev.num_states, 0), np.int32)
    return BigLmGraphArrays(
        em_rec=jnp.asarray(em_rec), eps_rec=jnp.asarray(eps_rec),
        start=jnp.int32(dev.start), final_state=jnp.int32(dev.final_state))


def _lm_tables(difflm: DeviceDiffLm):
    """The traced-operand half of the diff LM (static bounds ride in cfg)."""
    return ((difflm.lm1.table, difflm.lm1.uni, difflm.lm1.backoff),
            (difflm.lm2.table, difflm.lm2.uni, difflm.lm2.backoff))


def _diff_advance(lm_tabs, l1, l2, w, *, cfg):
    n1, c1 = lm_get_arc_tables(*lm_tabs[0], l1, w, mask=cfg["lm1_mask"],
                               levels=cfg["lm1_levels"],
                               max_probes=cfg["lm1_probes"])
    n2, c2 = lm_get_arc_tables(*lm_tabs[1], l2, w, mask=cfg["lm2_mask"],
                               levels=cfg["lm2_levels"],
                               max_probes=cfg["lm2_probes"])
    return n1, n2, cfg["lm2_scale"] * c2 - cfg["lm1_scale"] * c1


def _apply_lm(lm_tabs, ol, l1, l2, dst, cand, src, aid, *, cfg):
    """Advance the diff LM on word candidates; returns (dst, cand, l1, l2,
    src, aid, overflow) — possibly permuted (word candidates first) when
    compaction is on (lm_lanes < N).  ``overflow[b]`` = some word candidate
    fell past the LM lanes and was dropped (cand → INF)."""
    B, N = ol.shape
    M = min(cfg["lm_lanes"], N)
    is_word = (ol > 0) & jnp.isfinite(cand)
    if M >= N:
        wq = jnp.where(is_word, ol, 0)
        n1, n2, dc = _diff_advance(lm_tabs, l1, l2, wq, cfg=cfg)
        cand = cand + jnp.where(is_word, dc, 0.0)
        return dst, cand, n1, n2, src, aid, jnp.zeros((B,), bool)
    key = (~is_word).astype(jnp.int32)
    key, ol, l1, l2, dst, cand, src, aid = jax.lax.sort(
        (key, ol, l1, l2, dst, cand, src, aid), num_keys=1, is_stable=True)
    overflow = key[:, M] == 0 if M < N else jnp.zeros((B,), bool)
    is_word_m = key[:, :M] == 0
    wq = jnp.where(is_word_m, ol[:, :M], 0)
    n1m, n2m, dcm = _diff_advance(lm_tabs, l1[:, :M], l2[:, :M], wq, cfg=cfg)
    l1 = jnp.concatenate([n1m, l1[:, M:]], axis=1)
    l2 = jnp.concatenate([n2m, l2[:, M:]], axis=1)
    dc = jnp.concatenate([jnp.where(is_word_m, dcm, 0.0),
                          jnp.zeros((B, N - M), jnp.float32)], axis=1)
    cand = cand + dc
    # drop overflowed word candidates (beyond the LM lanes)
    lane = jnp.broadcast_to(_lane_iota(N), (B, N))
    dropped = (key == 0) & (lane >= M)
    cand = jnp.where(dropped, INF, cand)
    return dst, cand, l1, l2, src, aid, overflow


def _relax_pair(dst, cand, l1, l2, src, aid, *, cfg):
    """Shared tail of both stages: min-merge on (dst, lm1, lm2), prune,
    gather back the per-winner backpointers."""
    state, cost, win, keep, l1k, l2k = _relax_and_prune(
        dst, cand, K=cfg["K"], beam=cfg["beam"],
        min_active=cfg["min_active"],
        extra_keys=(l1, l2))
    prev = jnp.where(keep, batched_table_gather(src, win), 0)
    aidk = jnp.where(keep, batched_table_gather(aid, win), ARC_STAY)
    return state, cost, l1k, l2k, prev, aidk


def _emit_stage(g: BigLmGraphArrays, lm_tabs, state, cost, l1, l2, ll, *,
                cfg):
    """ProcessEmitting with per-word-arc LM advance
    (ref online-decoder-mempool-base-biglm.h:316-402)."""
    K, A = cfg["K"], cfg["A"]
    B = state.shape[0]
    N = K * A
    valid = state != NO_STATE
    s_safe = jnp.where(valid, state, 0)
    rows = g.em_rec[s_safe]                                # [B,K,5*A]
    dstN = rows[:, :, 0 * A:1 * A].reshape(B, N)
    pdf = rows[:, :, 1 * A:2 * A].reshape(B, N)
    w = _bits_to_f32(rows[:, :, 2 * A:3 * A]).reshape(B, N)
    aidN = rows[:, :, 3 * A:4 * A].reshape(B, N)
    olN = rows[:, :, 4 * A:5 * A].reshape(B, N)
    validN = jnp.repeat(valid, A, axis=1)
    costN = jnp.repeat(cost, A, axis=1)
    l1N = jnp.repeat(l1, A, axis=1)
    l2N = jnp.repeat(l2, A, axis=1)
    amask = validN & (dstN >= 0)
    am = batched_table_gather(ll, jnp.where(amask, pdf, 0))
    candN = jnp.where(amask, costN + w - cfg["acoustic_scale"] * am, INF)
    dstN = jnp.where(amask, dstN, 0)
    olN = jnp.where(amask, olN, 0)
    srcN = jnp.broadcast_to(_lane_iota(N), (B, N)) // A
    dstN, candN, l1N, l2N, srcN, aidN, ovf = _apply_lm(
        lm_tabs, olN, l1N, l2N, dstN, candN, srcN, aidN, cfg=cfg)
    state, cost, l1, l2, prev, aid = _relax_pair(
        dstN, candN, l1N, l2N, srcN, aidN, cfg=cfg)
    return state, cost, l1, l2, prev, aid, ovf


def _eps_stage(g: BigLmGraphArrays, lm_tabs, state, cost, l1, l2, *, cfg):
    """One bounded ε-relaxation sweep with LM advance on word-olabel ε arcs
    (ref ProcessNonemitting :405-469) + a stay block."""
    K = cfg["K"]
    B = state.shape[0]
    L = g.eps_rec.shape[1] // 4
    N = K * L
    valid = state != NO_STATE
    s_safe = jnp.where(valid, state, 0)
    rows = g.eps_rec[s_safe]                               # [B,K,4*L]
    d = rows[:, :, 0 * L:1 * L].reshape(B, N)
    w = _bits_to_f32(rows[:, :, 1 * L:2 * L]).reshape(B, N)
    eidxN = rows[:, :, 2 * L:3 * L].reshape(B, N)
    olN = rows[:, :, 3 * L:4 * L].reshape(B, N)
    validN = jnp.repeat(valid, L, axis=1)
    costN = jnp.repeat(cost, L, axis=1)
    l1N = jnp.repeat(l1, L, axis=1)
    l2N = jnp.repeat(l2, L, axis=1)
    emask = validN & (d >= 0)
    candN = jnp.where(emask, costN + w, INF)
    dN = jnp.where(emask, d, 0)
    olN = jnp.where(emask, olN, 0)
    srcN = jnp.broadcast_to(_lane_iota(N), (B, N)) // L
    dN, candN, l1N, l2N, srcN, eidxN, ovf = _apply_lm(
        lm_tabs, olN, l1N, l2N, dN, candN, srcN, eidxN, cfg=cfg)
    # stay block: keep each token unchanged (state, cost, lm lanes)
    slot = jnp.broadcast_to(_lane_iota(K), (B, K))
    dst_all = jnp.concatenate([dN, jnp.where(valid, state, 0)], axis=1)
    cand_all = jnp.concatenate([candN, jnp.where(valid, cost, INF)], axis=1)
    l1_all = jnp.concatenate([l1N, l1], axis=1)
    l2_all = jnp.concatenate([l2N, l2], axis=1)
    src_all = jnp.concatenate([srcN, slot], axis=1)
    aid_all = jnp.concatenate([eidxN, jnp.full((B, K), ARC_STAY,
                                               jnp.int32)], axis=1)
    state, cost, l1, l2, prev, aid = _relax_pair(
        dst_all, cand_all, l1_all, l2_all, src_all, aid_all, cfg=cfg)
    return state, cost, l1, l2, prev, aid, ovf


def _eps_stages(g, lm_tabs, state, cost, l1, l2, *, cfg):
    K = cfg["K"]
    B = state.shape[0]
    prevs, aids = [], []
    ovf = jnp.zeros((B,), bool)
    for _ in range(cfg["E"]):
        state, cost, l1, l2, prev, aid, o = _eps_stage(
            g, lm_tabs, state, cost, l1, l2, cfg=cfg)
        prevs.append(prev)
        aids.append(aid)
        ovf = ovf | o
    if prevs:
        log = (jnp.stack(prevs), jnp.stack(aids))
    else:
        log = (jnp.zeros((0, B, K), jnp.int32),
               jnp.zeros((0, B, K), jnp.int32))
    return state, cost, l1, l2, log, ovf


@partial(jax.jit, static_argnums=(2, 3))
def _init_fn(g: BigLmGraphArrays, lm_tabs, batch: int, static_cfg: tuple):
    cfg = dict(static_cfg)
    K = cfg["K"]
    state = jnp.full((batch, K), NO_STATE, jnp.int32)
    cost = jnp.full((batch, K), INF, jnp.float32)
    l1 = jnp.zeros((batch, K), jnp.int32)
    l2 = jnp.zeros((batch, K), jnp.int32)
    state = state.at[:, 0].set(g.start)
    cost = cost.at[:, 0].set(0.0)
    l1 = l1.at[:, 0].set(cfg["lm1_start"])
    l2 = l2.at[:, 0].set(cfg["lm2_start"])
    state, cost, l1, l2, (prev, aid), ovf = _eps_stages(
        g, lm_tabs, state, cost, l1, l2, cfg=cfg)
    return (BigLmBeamState(state, cost, l1, l2),
            BigLmFrameLog(prev, aid, ovf, state, cost, l1, l2))


@partial(jax.jit, static_argnums=(4,))
def _advance_fn(g: BigLmGraphArrays, lm_tabs, state: BigLmBeamState,
                inputs, static_cfg: tuple):
    cfg = dict(static_cfg)
    loglikes, frame_mask = inputs
    K = cfg["K"]

    def scan_body(carry, xs):
        st, co, l1, l2 = carry
        ll, mask = xs
        ns, nc, n1, n2, prev0, aid0, ovf0 = _emit_stage(
            g, lm_tabs, st, co, l1, l2, ll, cfg=cfg)
        ns, nc, n1, n2, (eprev, eaid), ovfe = _eps_stages(
            g, lm_tabs, ns, nc, n1, n2, cfg=cfg)
        prev = jnp.concatenate([prev0[None], eprev], axis=0)
        aid = jnp.concatenate([aid0[None], eaid], axis=0)
        ovf = ovf0 | ovfe
        slot_id = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (1, 1, K), 2), prev.shape)
        m = mask[:, None]
        ns = jnp.where(m, ns, st)
        nc = jnp.where(m, nc, co)
        n1 = jnp.where(m, n1, l1)
        n2 = jnp.where(m, n2, l2)
        m3 = mask[None, :, None]
        prev = jnp.where(m3, prev, slot_id)
        aid = jnp.where(m3, aid, ARC_STAY)
        ovf = ovf & mask
        ys = [prev, aid, ovf]
        if cfg["log_snapshots"]:
            ys += [ns, nc, n1, n2]
        else:
            z = jnp.zeros((ns.shape[0], 0), jnp.int32)
            ys += [z, jnp.zeros((ns.shape[0], 0), jnp.float32), z, z]
        return (ns, nc, n1, n2), tuple(ys)

    lls = jnp.swapaxes(loglikes, 0, 1)
    masks = jnp.swapaxes(frame_mask, 0, 1)
    carry0 = (state.tok_state, state.tok_cost, state.tok_lm1, state.tok_lm2)
    (st, co, l1, l2), ys = jax.lax.scan(scan_body, carry0, (lls, masks))
    return (BigLmBeamState(st, co, l1, l2), BigLmFrameLog(*ys))


class TpuBigLmBeamSearch:
    """Jit-compiled batched pair (fst × diff-LM) beam search.

    Same DecoderItf surface as ``TpuBeamSearch``; lattice output is served
    by the post-pass rescoring path (lm/compose.py) — in-search BigLM is the
    *pruning-quality* variant (ref decoder selection `biglm-hclg`,
    src/kaldi-nnet3/kaldi-online-nnet3-my-decoder.h:250-284).

    ``lm_lanes`` (DecoderConfig): number of compacted word-candidate lanes
    probed against the LMs per stage; ≥ K·A disables compaction (exact).
    """

    def __init__(self, dev: DeviceFst, ilabel2pdf: np.ndarray,
                 difflm: DeviceDiffLm, config: DecoderConfig | None = None):
        self.config = config or DecoderConfig()
        self.config.check()
        self.dev = dev
        self.difflm = difflm
        cfg = self.config
        assert dev.max_em_degree <= cfg.arc_lanes
        eps_iters = cfg.eps_iters or dev.eps_depth
        assert eps_iters >= 0, \
            "epsilon-cyclic graph: BigLM search needs bounded sweeps"
        self.graph = make_biglm_graph_arrays(dev, ilabel2pdf)
        self._lm_tabs = _lm_tables(difflm)
        K = min(cfg.beam_width, cfg.max_active)
        # Validate the LM candidate-compaction width against a graph-derived
        # worst case: a relax stage has at most K tokens × (max per-state
        # word-arc out-degree) word candidates; lm_lanes ≥ that bound can
        # never drop a candidate (the reference never drops,
        # ref: online-decoder-mempool-base-biglm.h:316-402).  Undersized
        # lanes stay legal (a throughput/exactness trade) but must be loud —
        # per-utterance drops are also surfaced as ``overflowed`` in
        # traceback results and served to clients.
        A = int(self.graph.em_rec.shape[1]) // 5
        em_src = np.repeat(np.arange(dev.num_states), dev.em_count)
        eps_src = np.repeat(np.arange(dev.num_states), dev.eps_count)
        wdeg = 0
        if len(em_src):
            m = dev.em_olabel > 0
            if m.any():
                wdeg = int(np.bincount(em_src[m]).max())
        if len(eps_src):
            m = dev.eps_olabel > 0
            if m.any():
                wdeg = max(wdeg, int(np.bincount(eps_src[m]).max()))
        self.lm_lanes_bound = min(K * max(wdeg, 1), K * A)
        if cfg.lm_lanes < self.lm_lanes_bound:
            import logging
            logging.getLogger(__name__).warning(
                "biglm: lm_lanes=%d < worst-case word candidates %d "
                "(K=%d × max word out-degree %d): overflowing word "
                "candidates will be DROPPED from the search; raise "
                "DecoderConfig.lm_lanes to ≥%d for exactness",
                cfg.lm_lanes, self.lm_lanes_bound, K, max(wdeg, 1),
                self.lm_lanes_bound)
        self._static = tuple(sorted(dict(
            K=K,
            A=int(self.graph.em_rec.shape[1]) // 5,
            E=eps_iters,
            beam=float(cfg.beam),
            min_active=int(cfg.min_active),
            acoustic_scale=float(cfg.acoustic_scale),
            lm_lanes=int(cfg.lm_lanes),
            lm1_start=difflm.lm1.start, lm2_start=difflm.lm2.start,
            lm1_mask=difflm.lm1.mask, lm2_mask=difflm.lm2.mask,
            lm1_levels=difflm.lm1.levels, lm2_levels=difflm.lm2.levels,
            lm1_probes=difflm.lm1.max_probes,
            lm2_probes=difflm.lm2.max_probes,
            lm1_scale=float(difflm.lm1_scale),
            lm2_scale=float(difflm.lm2_scale),
            log_snapshots=bool(cfg.log_snapshots),
        ).items()))
        self.beam_width = K
        self.num_stages = 1 + eps_iters
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)

    def init_state(self, batch: int):
        return _init_fn(self.graph, self._lm_tabs, batch, self._static)

    def advance(self, state: BigLmBeamState, loglikes, frame_mask=None):
        loglikes = jnp.asarray(loglikes, jnp.float32)
        B, T, _ = loglikes.shape
        if frame_mask is None:
            frame_mask = jnp.ones((B, T), bool)
        return _advance_fn(self.graph, self._lm_tabs, state,
                           (loglikes, jnp.asarray(frame_mask)), self._static)

    def decode(self, loglikes, frame_mask=None):
        B = loglikes.shape[0]
        state, init_log = self.init_state(B)
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    def token_sets(self, init_log: BigLmFrameLog, logs: BigLmFrameLog,
                   b: int, num_frames: int | None = None) -> list[dict]:
        """Per-frame surviving pair-token sets
        {(orig_fst_state, lm1, lm2): cost} for utterance ``b``
        (index 0 = post-init ε-closure); split continuation states fold
        back to their source state."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        orig = self.dev.orig_state
        T = np.asarray(logs.tok_state).shape[0]
        if num_frames is None:
            num_frames = T
        snaps = [(np.asarray(init_log.tok_state[b]),
                  np.asarray(init_log.tok_cost[b]),
                  np.asarray(init_log.tok_lm1[b]),
                  np.asarray(init_log.tok_lm2[b]))]
        snaps += [(np.asarray(logs.tok_state[t, b]),
                   np.asarray(logs.tok_cost[t, b]),
                   np.asarray(logs.tok_lm1[t, b]),
                   np.asarray(logs.tok_lm2[t, b]))
                  for t in range(num_frames)]
        out = []
        for st, co, l1, l2 in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict = {}
            for s, c, a, bb in zip(orig[st[ok]], co[ok], l1[ok], l2[ok]):
                key = (int(s), int(a), int(bb))
                c = float(c)
                if c < toks.get(key, np.inf):
                    toks[key] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log: BigLmFrameLog, logs: BigLmFrameLog,
                     loglikes, fst, frame_mask=None):
        """Raw lattices over the pair automaton: HCLG arcs with the
        difference-LM score folded into graph costs, LM sentence-end cost
        as final weights (ref GetRawLattice inherited by the biglm
        decoder, online-decoder-mempool-base-biglm.h + base-inl.h:869)."""
        from asr_decoder_tpu.decoder.raw_lattice import (
            BigLmExpander, lattice_from_token_sets_generic)
        lm1, lm2 = self.difflm.lm1.fsa, self.difflm.lm2.fsa
        s1, s2 = self.difflm.lm1_scale, self.difflm.lm2_scale

        def lm_advance(l1_, l2_, w):
            n1, c1 = lm1.get_arc(l1_, w)
            n2, c2 = lm2.get_arc(l2_, w)
            return n1, n2, s2 * c2 - s1 * c1

        exp = BigLmExpander(fst, lm_advance, self.difflm.final_host)
        loglikes = np.asarray(loglikes)
        B, T = loglikes.shape[:2]
        lens = (np.asarray(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets_generic(
                    exp, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    def _decode_stage_arcs(self, stage: int, a: int) -> list[int]:
        if a < 0:
            return []
        if stage == 0:
            return [int(self.dev.em_arcid[a])]
        aid = int(self.dev.eps_arcid[a])
        return [aid] if aid >= 0 else []

    def traceback(self, state: BigLmBeamState, init_log: BigLmFrameLog,
                  logs, fst_arcs=None):
        """Best path per utterance; final-token choice includes the diff
        LM's sentence-end cost (ref ComputeFinalCosts,
        online-decoder-mempool-base-biglm.h:161-216).  ``logs``: merged
        BigLmFrameLog or a list of per-chunk logs."""
        tok_state = np.asarray(state.tok_state)
        tok_cost = np.asarray(state.tok_cost)
        tok_l1 = np.asarray(state.tok_lm1)
        tok_l2 = np.asarray(state.tok_lm2)
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(np.asarray(c[0]), np.asarray(c[1]), np.asarray(c[2]))
                  for c in chunks]
        iprev = np.asarray(init_log.prev_slot)
        iaid = np.asarray(init_log.arc_id)
        final_id = int(self.dev.final_state)
        results = []
        for b in range(tok_state.shape[0]):
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                fc = np.array([
                    tok_cost[b, k] + self.difflm.final_host(
                        int(tok_l1[b, k]), int(tok_l2[b, k]))
                    for k in finals])
                slot = int(finals[np.argmin(fc)])
                total = float(fc.min())
                reached_final = True
            else:
                slot = int(np.argmin(tok_cost[b]))
                total = float(tok_cost[b, slot])
                reached_final = False
            arcs_rev: list[int] = []
            for prevs, aids, _ in reversed(chunks):
                for t in range(prevs.shape[0] - 1, -1, -1):
                    for s in range(prevs.shape[1] - 1, -1, -1):
                        arcs_rev.extend(self._decode_stage_arcs(
                            s, int(aids[t, s, b, slot])))
                        slot = int(prevs[t, s, b, slot])
            for s in range(iprev.shape[0] - 1, -1, -1):
                arcs_rev.extend(self._decode_stage_arcs(
                    s + 1, int(iaid[s, b, slot])))
                slot = int(iprev[s, b, slot])
            arc_ids = arcs_rev[::-1]
            res = dict(arc_ids=arc_ids, cost=total,
                       reached_final=reached_final,
                       overflowed=any(bool(ov[:, b].any())
                                      for _, _, ov in chunks))
            if fst_arcs is not None:
                ol = fst_arcs.arc_olabel[arc_ids]
                il = fst_arcs.arc_ilabel[arc_ids]
                res["words"] = [int(x) for x in ol[ol != 0]]
                res["ilabels"] = [int(x) for x in il[il != 0]]
            results.append(res)
        return results
