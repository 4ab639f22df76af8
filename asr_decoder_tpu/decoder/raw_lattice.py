"""Raw-lattice reconstruction from per-frame surviving-token sets.

The reference builds lattices by storing ForwardLink records per token during
search and walking them in ``GetRawLattice``
(ref: src/my-decoder/online-decoder-base-inl.h:869-977) after extra-cost
pruning (``PruneForwardLinks``, inl.h:483-577).  Materializing links on
the device would blow device memory and serialize the search, so this module exploits a
structural fact instead: *the link set is a pure function of the per-frame
surviving token sets* — every link the reference records and keeps connects
two surviving tokens via a graph arc, and every graph arc between surviving
tokens was expanded.  The device therefore logs only token snapshots
(``FrameLog.tok_state/tok_cost``, O(T·K) ints), and this host pass re-derives
links from the CSR graph + loglikes, then applies the reference's
lattice-beam extra-cost pruning exactly.

Used identically by the gold decoder and the device decoder, so lattice
semantics match by construction.
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.fst import EPSILON, StdFst
from asr_decoder_tpu.fst.lattice import Lattice, LatticeArc
from asr_decoder_tpu.fst.semiring import INF, LatticeWeight


def _member_idx(q: np.ndarray, sorted_arr: np.ndarray):
    """For each q: index into sorted_arr if present, else -1."""
    if len(sorted_arr) == 0:
        return np.full(len(q), -1, np.int64)
    pos = np.searchsorted(sorted_arr, q)
    pos = np.minimum(pos, len(sorted_arr) - 1)
    ok = sorted_arr[pos] == q
    return np.where(ok, pos, -1)


def _expand_frame(fst: StdFst, states: np.ndarray):
    """All arcs leaving ``states``: returns (src_rep, arc_idx, is_eps)."""
    lo = fst.state_offset[states]
    hi = fst.state_offset[states + 1]
    eo = fst.state_eps_end[states]
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, bool)
    starts = np.cumsum(cnt) - cnt
    arc_idx = np.repeat(lo, cnt) + (np.arange(total) - np.repeat(starts, cnt))
    src_rep = np.repeat(states, cnt)
    is_eps = arc_idx < np.repeat(eo, cnt)
    return src_rep, arc_idx, is_eps


def lattice_from_token_sets(
        fst: StdFst,
        frame_toks: list[dict[int, float]],
        loglikes: np.ndarray,
        ilabel2pdf: np.ndarray,
        cfg: DecoderConfig) -> Lattice | None:
    """Build the pruned raw lattice.

    ``frame_toks[t]`` = {state: forward cost} of tokens surviving frame t
    (index 0 = after initial ε-closure); ``loglikes`` f32[T, V] with
    T = len(frame_toks) - 1.
    """
    scale = cfg.acoustic_scale
    ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
    T = len(frame_toks) - 1
    final_id = fst.final_state

    # ---- node table: per frame, sorted state array -----------------------
    node_states = [np.array(sorted(toks), np.int64) for toks in frame_toks]
    node_off = np.zeros(T + 2, np.int64)
    np.cumsum([len(s) for s in node_states], out=node_off[1:])
    n_nodes = int(node_off[-1])
    if n_nodes == 0:
        return None
    alpha = np.empty(n_nodes, np.float64)
    for t, sts in enumerate(node_states):
        alpha[node_off[t]:node_off[t + 1]] = [frame_toks[t][int(s)]
                                              for s in sts]

    # ---- re-derive links per frame ---------------------------------------
    # per frame t: ε-links within frame t; emitting links into frame t+1
    e_src, e_dst = [], []        # node ids
    e_il, e_ol = [], []
    e_gw, e_am = [], []
    e_frame = []                 # src frame (for the backward pass)
    e_is_eps = []
    for t in range(T + 1):
        sts = node_states[t]
        if len(sts) == 0:
            continue
        src_rep, arc_idx, is_eps = _expand_frame(fst, sts)
        if len(arc_idx) == 0:
            continue
        dsts = fst.arc_dst[arc_idx].astype(np.int64)
        # ε within frame t
        em = ~is_eps
        di = _member_idx(dsts[is_eps], sts)
        keep = di >= 0
        if keep.any():
            ai = arc_idx[is_eps][keep]
            e_src.append(node_off[t] +
                         _member_idx(src_rep[is_eps][keep], sts))
            e_dst.append(node_off[t] + di[keep])
            e_il.append(np.zeros(keep.sum(), np.int64))
            e_ol.append(fst.arc_olabel[ai].astype(np.int64))
            e_gw.append(fst.arc_weight[ai].astype(np.float64))
            e_am.append(np.zeros(keep.sum()))
            e_frame.append(np.full(keep.sum(), t, np.int64))
            e_is_eps.append(np.ones(keep.sum(), bool))
        # emitting into frame t+1
        if t < T and len(node_states[t + 1]):
            nxt = node_states[t + 1]
            di = _member_idx(dsts[em], nxt)
            keep = di >= 0
            if keep.any():
                ai = arc_idx[em][keep]
                il = fst.arc_ilabel[ai].astype(np.int64)
                e_src.append(node_off[t] +
                             _member_idx(src_rep[em][keep], sts))
                e_dst.append(node_off[t + 1] + di[keep])
                e_il.append(il)
                e_ol.append(fst.arc_olabel[ai].astype(np.int64))
                e_gw.append(fst.arc_weight[ai].astype(np.float64))
                e_am.append(-scale *
                            loglikes[t, ilabel2pdf[il]].astype(np.float64))
                e_frame.append(np.full(keep.sum(), t, np.int64))
                e_is_eps.append(np.zeros(keep.sum(), bool))
    if not e_src:
        return None
    links = (np.concatenate(e_src), np.concatenate(e_dst),
             np.concatenate(e_il), np.concatenate(e_ol),
             np.concatenate(e_gw), np.concatenate(e_am),
             np.concatenate(e_frame), np.concatenate(e_is_eps))

    # finals: super-final node gets final cost 0; none present → all-0
    # fallback (ref ComputeFinalCosts fallback, inl.h:671-724)
    fi = _member_idx(np.array([final_id], np.int64), node_states[T])[0]
    beta_last = np.full(node_off[T + 1] - node_off[T], INF)
    if fi >= 0:
        beta_last[fi] = 0.0
    si = _member_idx(np.array([fst.start], np.int64), node_states[0])[0]
    start_node = int(node_off[0] + si) if si >= 0 else -1
    return _finish_lattice(node_off, alpha, links, T, beta_last,
                           start_node, cfg)


def _finish_lattice(node_off, alpha, links, T, beta_last, start_node,
                    cfg: DecoderConfig) -> Lattice | None:
    """Backward pass + lattice-beam pruning + assembly, shared by the
    vectorized StdFst builder and the generic expander builder.

    ``beta_last``: final cost per last-frame node (INF = not final); all-INF
    falls back to all-0 (ref ComputeFinalCosts fallback, inl.h:671-724).
    ``start_node``: global node id of (frame 0, start state), or -1.
    """
    (e_src, e_dst, e_il, e_ol, e_gw, e_am, e_frame, e_is_eps) = links
    n_nodes = len(alpha)
    e_cost = e_gw + e_am

    beta = np.full(n_nodes, INF)
    if np.isfinite(beta_last).any():
        beta[node_off[T]:node_off[T + 1]] = beta_last
    else:
        beta[node_off[T]:node_off[T + 1]] = 0.0

    # ---- backward best-cost-to-final over the token DAG ------------------
    # frames descending; within a frame, relax ε edges to fixpoint
    by_frame_em = {}
    by_frame_eps = {}
    order = np.argsort(e_frame, kind="stable")
    for name, mask in (("em", ~e_is_eps), ("eps", e_is_eps)):
        sel = order[mask[order]]
        d = by_frame_em if name == "em" else by_frame_eps
        bounds = np.searchsorted(e_frame[sel], np.arange(T + 2))
        for t in range(T + 1):
            seg = sel[bounds[t]:bounds[t + 1]]
            if len(seg):
                d[t] = seg
    for t in range(T, -1, -1):
        seg = by_frame_em.get(t)
        if seg is not None:
            np.minimum.at(beta, e_src[seg], e_cost[seg] + beta[e_dst[seg]])
        seg = by_frame_eps.get(t)
        if seg is not None:
            while True:
                nb = e_cost[seg] + beta[e_dst[seg]]
                old = beta[e_src[seg]].copy()
                np.minimum.at(beta, e_src[seg], nb)
                if np.array_equal(beta[e_src[seg]], old):
                    break

    total = alpha + beta
    finite = np.isfinite(total)
    if not finite.any():
        return None
    best_total = total[finite].min()

    # ---- lattice-beam pruning (ref PruneForwardLinks extra-cost) ---------
    lat_beam = cfg.lattice_beam
    kept_node = finite & (total <= best_total + lat_beam)
    link_extra = alpha[e_src] + e_cost + beta[e_dst] - best_total
    kept_link = (kept_node[e_src] & kept_node[e_dst] &
                 (link_extra <= lat_beam))

    # ---- assemble --------------------------------------------------------
    lat = Lattice()
    ids = np.full(n_nodes, -1, np.int64)
    for n in np.nonzero(kept_node)[0]:
        ids[n] = lat.add_state()
    for k in np.nonzero(kept_link)[0]:
        lat.add_arc(int(ids[e_src[k]]), LatticeArc(
            int(e_il[k]), int(e_ol[k]),
            LatticeWeight(float(e_gw[k]), float(e_am[k])),
            int(ids[e_dst[k]])))
    # start node: (0, start state), else best kept frame-0 node
    if start_node < 0 or not kept_node[start_node]:
        f0 = np.arange(node_off[0], node_off[1])
        f0 = f0[kept_node[f0]]
        if len(f0) == 0:
            return None
        start_node = int(f0[np.argmin(alpha[f0])])
    lat.set_start(int(ids[start_node]))
    had_final = np.isfinite(beta_last).any()
    for i in range(node_off[T + 1] - node_off[T]):
        n = node_off[T] + i
        if kept_node[n] and (np.isfinite(beta_last[i]) or not had_final):
            w = LatticeWeight(float(beta_last[i]), 0.0) if had_final \
                else LatticeWeight.one()
            lat.set_final(int(ids[n]), w)
    lat.connect()
    if lat.num_states == 0 or lat.start < 0:
        return None
    return lat


class ClgExpander:
    """Expansion view of the CLG⊗HMM virtual composite for the generic
    lattice builder (host mirror of the device kernel's two-level
    indirection; ref CLG GetRawLattice inherits the base
    online-decoder-base-inl.h:869-977 over virtual states)."""

    def __init__(self, clgfst):
        self.g = clgfst

    @property
    def start_key(self):
        return self.g.start()

    def final_cost(self, key) -> float:
        return 0.0 if self.g.is_final(key) else float(INF)

    def expand(self, key):
        """Yield (dst_key, il, ol, graph_w, is_eps)."""
        for dst, w, ol, _kind, _arc in self.g.eps_expand(key):
            yield dst, 0, ol, w, True
        for dst, w, il in self.g.emit_expand(key):
            yield dst, il, 0, w, False


class BigLmExpander:
    """Expansion view of the HCLG ⊗ (G₂−G₁) pair automaton: token keys are
    (fst_state, lm1_state, lm2_state); word-olabel arcs fold the
    difference-LM score into the graph cost (ref ProcessEmitting LM fold,
    online-decoder-mempool-base-biglm.h:316-402) and final pair states add
    the LM sentence-end cost (ref ComputeFinalCosts :161-216)."""

    def __init__(self, fst: StdFst, lm_advance, lm_final):
        """``lm_advance(l1, l2, word) -> (n1, n2, cost)``;
        ``lm_final(l1, l2) -> cost``."""
        self.fst = fst
        self.lm_advance = lm_advance
        self.lm_final = lm_final

    @property
    def start_key(self):
        return None     # start handled by token sets (pair start varies)

    def final_cost(self, key) -> float:
        s, l1, l2 = key
        if s != self.fst.final_state:
            return float(INF)
        return float(self.lm_final(l1, l2))

    def expand(self, key):
        s, l1, l2 = key
        fst = self.fst
        lo, hi = int(fst.state_offset[s]), int(fst.state_offset[s + 1])
        ee = int(fst.state_eps_end[s])
        for i in range(lo, hi):
            il = int(fst.arc_ilabel[i])
            ol = int(fst.arc_olabel[i])
            w = float(fst.arc_weight[i])
            d = int(fst.arc_dst[i])
            if ol:
                n1, n2, lc = self.lm_advance(l1, l2, ol)
                yield (d, int(n1), int(n2)), il, ol, w + float(lc), i < ee
            else:
                yield (d, l1, l2), il, ol, w, i < ee


def lattice_from_token_sets_generic(
        expander, frame_toks: list[dict], loglikes: np.ndarray,
        ilabel2pdf: np.ndarray, cfg: DecoderConfig) -> Lattice | None:
    """Generic raw-lattice reconstruction over arbitrary hashable token
    keys (virtual CLG states, BigLM pair states, ...).  Same semantics as
    ``lattice_from_token_sets``; per-token host expansion instead of the
    vectorized CSR pass (token sets are beam-bounded, so this is O(T·K·A))."""
    scale = cfg.acoustic_scale
    ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
    T = len(frame_toks) - 1

    node_idx: list[dict] = []
    alpha_l: list[float] = []
    node_off = np.zeros(T + 2, np.int64)
    for t, toks in enumerate(frame_toks):
        d = {}
        for k in sorted(toks):
            d[k] = len(alpha_l)
            alpha_l.append(toks[k])
        node_idx.append(d)
        node_off[t + 1] = len(alpha_l)
    n_nodes = len(alpha_l)
    if n_nodes == 0:
        return None
    alpha = np.array(alpha_l, np.float64)

    e_src, e_dst, e_il, e_ol = [], [], [], []
    e_gw, e_am, e_frame, e_is_eps = [], [], [], []
    for t in range(T + 1):
        cur = node_idx[t]
        nxt = node_idx[t + 1] if t < T else None
        for key, src_id in cur.items():
            for dk, il, ol, gw, is_eps in expander.expand(key):
                if is_eps:
                    j = cur.get(dk)
                    if j is None:
                        continue
                    am = 0.0
                elif nxt is None:
                    continue
                else:
                    j = nxt.get(dk)
                    if j is None:
                        continue
                    am = -scale * float(loglikes[t, ilabel2pdf[il]])
                e_src.append(src_id)
                e_dst.append(j)
                e_il.append(0 if is_eps else il)
                e_ol.append(ol)
                e_gw.append(gw)
                e_am.append(am)
                e_frame.append(t)
                e_is_eps.append(is_eps)
    if not e_src:
        return None
    links = (np.array(e_src, np.int64), np.array(e_dst, np.int64),
             np.array(e_il, np.int64), np.array(e_ol, np.int64),
             np.array(e_gw, np.float64), np.array(e_am, np.float64),
             np.array(e_frame, np.int64), np.array(e_is_eps, bool))

    last_keys = sorted(frame_toks[T])
    beta_last = np.array([expander.final_cost(k) for k in last_keys],
                         np.float64) if last_keys else np.zeros(0)
    start_node = -1
    sk = expander.start_key
    if sk is not None and sk in node_idx[0]:
        start_node = node_idx[0][sk]
    return _finish_lattice(node_off, alpha, links, T, beta_last,
                           start_node, cfg)
