"""Batched frame-synchronous WFST Viterbi beam search on the device.

This is a data-parallel re-design of the reference decoder's hot loop —
``ProcessEmitting`` / ``ProcessNonemitting`` / ``GetCutoff`` / ``FindOrAddToken``
(ref: src/my-decoder/online-decoder-base-inl.h:139-437).  Where the reference
chases a HashList of token pointers per frame, this implementation keeps a
dense fixed-width token beam per utterance and turns each frame into a few
large gathers, one sort, and one top-k — all batched over utterances and
compiled by XLA into a single fused device program (``lax.scan`` over frames).

Layout rule: every tensor on the hot path is 2-D ``[B, N]`` with the
candidate axis flattened into the minor dimension (``[B, K*A]`` rather than
``[B, K, A]`` with A = 8 arc lanes minor).

Shapes (B = batch of utterances, K = beam width, A = arc lanes):
  * token arrays: ``tok_state i32[B,K]``, ``tok_cost f32[B,K]``
  * emitting expansion: flat ``[B, K*A]`` candidates — arc-table gathers,
    ``cost + graph_w − scale·loglike`` (ref inl.h:291-300)
  * relaxation (``FindOrAddToken`` min-merge, ref inl.h:89-137) is a
    3-operand ``lax.sort`` by (dst, cost) + first-of-segment mask — a
    segmented scatter-min without atomics — then top-K by cost with an
    adaptive beam mask (``GetCutoff``, ref inl.h:139-245)
  * ε-handling (ref ProcessNonemitting worklist, inl.h:354-437) has two
    exact device modes:
      - **closure** (default): the per-state ε-closure (best ε-path to every
        ε-reachable state) is precomputed at graph load
        (``DeviceFst.build_closure``), so each frame needs ONE extra
        relaxation stage over ``[B, K*(1+C)]`` candidates.  Tolerates
        non-negative ε-cycles.
      - **sweeps**: E bounded relaxation sweeps (E = the graph's exact
        ε-depth) for graphs whose closure fan-out is too wide.

Per-frame backpointers (slot + arc id per stage) are logged to HBM so the
host can reconstruct the best path and lattice links without device pointer
chasing; token snapshots allow exact raw-lattice reconstruction
(ref GetRawLattice inl.h:869-977).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.ops.gather import (batched_table_gather,
                                        fetch_state_records)

INF = jnp.inf
NO_STATE = -1
BIG_STATE = 2**31 - 1   # sort key for dead candidates
ARC_STAY = -2           # log sentinel: token carried, no arc taken
CLO_BIT = 1 << 30       # v3 dst marker: destination state has ε-closure
                        # entries (graphs must have < 2^30 states)


class GraphArrays(NamedTuple):
    """Device-resident graph: padded per-state arc-record tables.

    Random arc access is the search's hot memory op, so each state's
    out-arcs live in one fixed-width **flat 2-D** row, field-major (field f
    at lanes [f·L, (f+1)·L)): one row gather per beam token reads them all.

      * ``em_rec  i32[S, 4·A]`` — emitting arcs: (dst | pdf | weight-bits |
        em-block arc index); padding lanes have dst = -1.
      * ``eps_rec i32[S, 3·Ae]`` — ε arcs (sweeps mode): (dst | weight-bits |
        ε-block arc index).
      * ``clo_rec i32[S, 3·C]`` — ε-closure entries (closure mode):
        (dst | weight-bits | closure-entry index).
    """
    em_rec: jax.Array      # i32[S, 4*A]
    eps_rec: jax.Array     # i32[S, 3*Aeps]  (zero-width in closure mode)
    clo_rec: jax.Array     # i32[S, 3*C]     (zero-width in sweeps mode)
    start: jax.Array       # i32 scalar
    final_state: jax.Array # i32 scalar


class PackedGraph(NamedTuple):
    """v3 (relax_impl=topk) device graph: each state's full record —
    emitting arcs AND ε-closure entries, field-major — in one row of a
    ``[S, lanes]`` table, so ONE row fetch per relax stage serves both the
    emit and the closure expansion.  Lane layout per state (A = arc lanes,
    C = closure lanes): [em_dst·A | em_pdf·A | em_w·A | clo_dst·C | clo_w·C],
    dst padding = -1.  Arc/entry ids are NOT stored — the host traceback
    re-derives them from (state, lane) via the DeviceFst CSR offsets."""
    records: jax.Array     # i32[S, lanes]
    start: jax.Array       # i32 scalar
    final_state: jax.Array # i32 scalar


class BeamState(NamedTuple):
    tok_state: jax.Array   # i32[B,K]
    tok_cost: jax.Array    # f32[B,K]


class FrameLog(NamedTuple):
    """Per-frame search log.

    ``prev_slot``/``arc_id`` are the best-path backpointers per relaxation
    stage (host ``traceback`` ≡ ref GetBestPath).  Stage 0 is the emitting
    stage (``arc_id`` = index into the DeviceFst emitting block); later
    stages are ε stages (closure mode: index into the closure-entry table;
    sweeps mode: index into the ε block); ``ARC_STAY`` = token carried.
    ``tok_state``/``tok_cost`` are post-frame surviving-token snapshots —
    all the host needs to reconstruct the raw lattice exactly
    (ref GetRawLattice, online-decoder-base-inl.h:869-977): ForwardLinks are
    re-derivable from the CSR graph + loglikes, so the device never logs
    links (SURVEY §7 'lattice fidelity').
    """
    prev_slot: jax.Array   # i32[stages,B,K]    (advance: [T,stages,B,K])
    arc_id: jax.Array      # i32[stages,B,K]    (advance: [T,stages,B,K])
    tok_state: jax.Array   # i32[B,K]           (advance: [T,B,K])
    tok_cost: jax.Array    # f32[B,K]           (advance: [T,B,K])


def _pack_records(offset: np.ndarray, count: np.ndarray, lanes: int,
                  *fields: np.ndarray) -> np.ndarray:
    """CSR → padded field-major flat record table i32[S, len(fields)·lanes].

    Row layout per state: (dst lanes | field₁ lanes | field₂ lanes | ...)
    with padding lanes dst = -1; float fields are bit-cast to i32.  The
    first *field* must be the dst array (see GraphArrays)."""
    S = len(offset)
    nf = len(fields)
    rec = np.zeros((S, nf, lanes), np.int32)
    rec[:, 0, :] = -1
    lane = np.arange(lanes)
    mask = lane[None, :] < count[:, None]                    # [S, lanes]
    idx = np.where(mask, offset[:, None] + lane[None, :], 0)
    for f, arr in enumerate(fields):
        if arr.dtype == np.float32:
            arr = arr.view(np.int32)
        vals = arr.astype(np.int32)[idx]
        fill = -1 if f == 0 else 0
        rec[:, f, :] = np.where(mask, vals, fill)
    return rec.reshape(S, nf * lanes)


def make_graph_arrays(dev: DeviceFst, ilabel2pdf: np.ndarray,
                      mode: str) -> GraphArrays:
    """Upload a host DeviceFst as padded record tables; ``ilabel2pdf[i]``
    maps arc input label i to the AM output row scored for it
    (ref: TransitionIdToPdf / ``ilabel-1`` CTC mapping,
    src/nnet/nnet-nnet.h:212-233)."""
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    em_pdf = ilabel2pdf[dev.em_ilabel]
    A = max(dev.max_em_degree, 1)
    em_arc_idx = np.arange(len(dev.em_dst), dtype=np.int32)
    em_rec = _pack_records(dev.em_offset, dev.em_count, A,
                           dev.em_dst, em_pdf, dev.em_weight, em_arc_idx)
    if mode == "closure":
        assert dev.clo_offset is not None, "call dev.build_closure() first"
        C = max(dev.max_closure_size, 0)
        clo_idx = np.arange(len(dev.clo_dst), dtype=np.int32)
        clo_rec = _pack_records(dev.clo_offset, dev.clo_count, max(C, 1),
                                dev.clo_dst, dev.clo_weight, clo_idx) \
            if C else np.zeros((dev.num_states, 0), np.int32)
        eps_rec = np.zeros((dev.num_states, 0), np.int32)
    else:
        Ae = max(dev.max_eps_degree, 1)
        eps_idx = np.arange(len(dev.eps_dst), dtype=np.int32)
        eps_rec = _pack_records(dev.eps_offset, dev.eps_count, Ae,
                                dev.eps_dst, dev.eps_weight, eps_idx) \
            if len(dev.eps_dst) else np.zeros((dev.num_states, 0),
                                              np.int32)
        clo_rec = np.zeros((dev.num_states, 0), np.int32)
    return GraphArrays(
        em_rec=jnp.asarray(em_rec),
        eps_rec=jnp.asarray(eps_rec),
        clo_rec=jnp.asarray(clo_rec),
        start=jnp.int32(dev.start),
        final_state=jnp.int32(dev.final_state),
    )


def _pad_block(offset: np.ndarray, count: np.ndarray, lanes: int,
               vals: np.ndarray, fill) -> np.ndarray:
    """CSR field → padded [S, lanes] block (row s = vals[offset_s:+count_s])."""
    S = len(offset)
    lane = np.arange(lanes)
    mask = lane[None, :] < count[:, None]
    idx = np.where(mask, offset[:, None] + lane[None, :], 0)
    if vals.dtype == np.float32:
        vals = vals.view(np.int32)
    out = np.where(mask, vals.astype(np.int32)[idx], fill)
    return out.astype(np.int32)


def packed_lanes(A: int, C: int) -> int:
    """State-record width for the v3 table (32, 64 or 128 lanes), or 0 if
    the record needs more than 128 lanes."""
    need = 3 * A + 2 * C
    for lanes in (32, 64, 128):
        if need <= lanes:
            return lanes
    return 0


def make_packed_graph(dev: DeviceFst, ilabel2pdf: np.ndarray) -> PackedGraph:
    """Build the v3 ``[S, lanes]`` state-record table."""
    assert dev.clo_offset is not None, "call dev.build_closure() first"
    ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
    A = max(dev.max_em_degree, 1)
    C = dev.max_closure_size
    lanes = packed_lanes(A, C)
    assert lanes, f"state record too wide for a page: A={A} C={C}"
    em_pdf = ilabel2pdf[dev.em_ilabel]
    em_dst = dev.em_dst.astype(np.int32)
    if C:
        # ε-presence marker: tokens landing on a bit-free state skip the
        # closure fetch AND its candidate lanes entirely (most states of
        # a trie/HCLG have no ε out-arcs)
        assert dev.num_states < CLO_BIT, "graph too large for CLO_BIT"
        em_dst = np.where((em_dst >= 0) & (dev.clo_count[em_dst] > 0),
                          em_dst | CLO_BIT, em_dst)
    blocks = [
        _pad_block(dev.em_offset, dev.em_count, A, em_dst, -1),
        _pad_block(dev.em_offset, dev.em_count, A, em_pdf, 0),
        _pad_block(dev.em_offset, dev.em_count, A, dev.em_weight, 0),
    ]
    if C:
        blocks += [
            _pad_block(dev.clo_offset, dev.clo_count, C, dev.clo_dst, -1),
            _pad_block(dev.clo_offset, dev.clo_count, C, dev.clo_weight, 0),
        ]
    records = np.concatenate(blocks, axis=1)
    records = np.pad(records, ((0, 0), (0, lanes - records.shape[1])))
    return PackedGraph(records=jnp.asarray(records),
                       start=jnp.int32(dev.start),
                       final_state=jnp.int32(dev.final_state))


# ----------------------------------------------------------------------
# batched flat-2D building blocks
# ----------------------------------------------------------------------

def _lane_iota(N: int) -> jax.Array:
    return jax.lax.broadcasted_iota(jnp.int32, (1, N), 1)


def _relax_and_prune(dst, cost, *, K, beam, min_active, extra_keys=()):
    """Min-merge flat candidates by destination state, then prune.

    The segmented scatter-min: lexicographic sort by (dst, cost) with the
    flat candidate index as payload; the first candidate of each dst segment
    is that state's best (ties broken by sort stability ⇒ lowest candidate
    index, mirroring the reference's first-writer-wins on exact ties,
    ref FindOrAddToken inl.h:89-137).  Then top-K by cost with an adaptive
    beam mask that never drops the best ``min_active`` tokens
    (ref GetCutoff semantics, online-decoder-base-inl.h:139-245).

    ``extra_keys``: additional i32[B,N] identity lanes (e.g. LM states for
    the BigLM pair search, ref PairId online-decoder-mempool-base-biglm.h:
    77-90) that join dst in the merge key; their pruned [B,K] values are
    returned after the keep mask.

    Returns (state i32[B,K], cost f32[B,K], win i32[B,K] flat candidate
    index, keep bool[B,K] live mask, *extras).
    """
    B, N = dst.shape
    dead = ~jnp.isfinite(cost)
    sort_dst = jnp.where(dead, BIG_STATE, dst)
    idx = jnp.broadcast_to(_lane_iota(N), (B, N))
    # idx joins the key (distinct per lane ⇒ total order) so the cheaper
    # unstable sort is still deterministic and equals the stable
    # (dst, cost)-sort: ties on (dst, cost) break by lowest candidate index
    # (the reference's first-writer-wins, ref FindOrAddToken inl.h:89-137)
    nk = 3 + len(extra_keys)
    sorted_ops = jax.lax.sort(
        (sort_dst, *extra_keys, cost, idx), num_keys=nk, is_stable=False)
    sort_dst, cost_s, idx_s = sorted_ops[0], sorted_ops[-2], sorted_ops[-1]
    extras_s = sorted_ops[1:-2]
    same = sort_dst[:, 1:] == sort_dst[:, :-1]
    for e in extras_s:
        same = same & (e[:, 1:] == e[:, :-1])
    first = jnp.concatenate([jnp.ones((B, 1), bool), ~same], axis=1)
    alive = first & (sort_dst != BIG_STATE)
    cost_s = jnp.where(alive, cost_s, INF)
    neg, tk = jax.lax.top_k(-cost_s, K)          # [B,K]
    cost_k = -neg
    state_k = batched_table_gather(sort_dst, tk)
    win = batched_table_gather(idx_s, tk)
    # adaptive beam: always keep the best min_active slots, beam-prune rest
    best = cost_k[:, :1]
    rank = _lane_iota(K)
    keep = jnp.isfinite(cost_k) & (
        (cost_k <= best + beam) | (rank < min_active))
    cost_k = jnp.where(keep, cost_k, INF)
    state_k = jnp.where(keep, state_k, NO_STATE)
    win = jnp.where(keep, win, 0)
    extras_k = tuple(
        jnp.where(keep, batched_table_gather(e, tk), 0)
        for e in extras_s)
    return (state_k, cost_k, win, keep, *extras_k)


def _bits_to_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _emit_stage(g: GraphArrays, state, cost, ll, *, cfg):
    """ProcessEmitting (ref inl.h:247-352): one row-gather of each beam
    state's packed arc records, flat ``[B, K*A]`` candidates, relax, prune.
    ``ll`` f32[B,V]."""
    with jax.named_scope("search/emit"):
        return _emit_stage_scoped(g, state, cost, ll, cfg=cfg)


def _emit_stage_scoped(g: GraphArrays, state, cost, ll, *, cfg):
    K, A = cfg["K"], cfg["A"]
    B = state.shape[0]
    N = K * A
    valid = state != NO_STATE
    s_safe = jnp.where(valid, state, 0)
    rows = g.em_rec[s_safe]                                # [B,K,4*A]
    dstN = rows[:, :, 0 * A:1 * A].reshape(B, N)
    pdf = rows[:, :, 1 * A:2 * A].reshape(B, N)
    w = _bits_to_f32(rows[:, :, 2 * A:3 * A]).reshape(B, N)
    aidN = rows[:, :, 3 * A:4 * A].reshape(B, N)
    validN = jnp.repeat(valid, A, axis=1)
    costN = jnp.repeat(cost, A, axis=1)
    amask = validN & (dstN >= 0)
    am = batched_table_gather(ll, jnp.where(amask, pdf, 0))
    candN = jnp.where(amask, costN + w - cfg["acoustic_scale"] * am, INF)
    dstN = jnp.where(amask, dstN, 0)
    state, cost, win, keep = _relax_and_prune(
        dstN, candN, K=K, beam=cfg["beam"], min_active=cfg["min_active"])
    prev = jnp.where(keep, win // A, 0)
    aid = jnp.where(keep,
                    batched_table_gather(aidN, win),
                    ARC_STAY)
    return state, cost, prev, aid


def _table_stage(rec, state, cost, *, K, beam, min_active):
    """One ε relaxation stage over a packed flat record table i32[S, 3·L]
    (closure entries or ε arcs): candidates = L table lanes per token plus a
    trailing per-token stay block.  Returns (state, cost, prev, aid) with
    aid = table entry index or ARC_STAY."""
    B = state.shape[0]
    L = rec.shape[1] // 3
    if L == 0:
        # zero-lane table (e.g. eps_iters forced >0 on an ε-free graph):
        # nothing to relax — every token stays put
        prev = jnp.broadcast_to(_lane_iota(K), (B, K))
        aid = jnp.full((B, K), ARC_STAY, jnp.int32)
        return state, cost, prev, aid
    N = K * L
    valid = state != NO_STATE
    s_safe = jnp.where(valid, state, 0)
    rows = rec[s_safe]                                     # [B,K,3*L]
    d = rows[:, :, 0 * L:1 * L].reshape(B, N)
    w = _bits_to_f32(rows[:, :, 1 * L:2 * L]).reshape(B, N)
    eidxN = rows[:, :, 2 * L:3 * L].reshape(B, N)
    validN = jnp.repeat(valid, L, axis=1)
    costN = jnp.repeat(cost, L, axis=1)
    emask = validN & (d >= 0)
    candN = jnp.where(emask, costN + w, INF)
    dN = jnp.where(emask, d, 0)
    # stay block: candidates [K*L, K*L+K) keep each token unchanged
    dst_all = jnp.concatenate([dN, jnp.where(valid, state, 0)], axis=1)
    cand_all = jnp.concatenate([candN, jnp.where(valid, cost, INF)], axis=1)
    state, cost, win, keep = _relax_and_prune(
        dst_all, cand_all, K=K, beam=beam, min_active=min_active)
    is_stay = win >= N
    prev = jnp.where(keep, jnp.where(is_stay, win - N, win // L), 0)
    aid = jnp.where(keep & ~is_stay,
                    batched_table_gather(eidxN, jnp.minimum(win, N - 1)),
                    ARC_STAY)
    return state, cost, prev, aid


def _eps_stages(g: GraphArrays, state, cost, *, cfg):
    """All ε stages for one frame: one closure relaxation (closure mode) or
    E bounded sweeps (sweeps mode).  Returns tokens + stage logs
    ([S_eps,B,K] prev, aid)."""
    K = cfg["K"]
    prevs, aids = [], []
    if cfg["mode"] == "closure":
        if cfg["C"] > 0:
            state, cost, prev, aid = _table_stage(
                g.clo_rec, state, cost, K=K, beam=cfg["beam"],
                min_active=cfg["min_active"])
            prevs.append(prev)
            aids.append(aid)
    else:
        for _ in range(cfg["E"]):
            state, cost, prev, aid = _table_stage(
                g.eps_rec, state, cost, K=K, beam=cfg["beam"],
                min_active=cfg["min_active"])
            prevs.append(prev)
            aids.append(aid)
    B = state.shape[0]
    if prevs:
        log = (jnp.stack(prevs), jnp.stack(aids))
    else:
        log = (jnp.zeros((0, B, K), jnp.int32),
               jnp.zeros((0, B, K), jnp.int32))
    return state, cost, log


def _frame_step(g: GraphArrays, state, cost, ll, *, cfg):
    """One decode frame: emitting stage then ε stage(s); logs [S,B,K]
    (stage 0 = emitting, referencing previous-frame slots)."""
    state, cost, prev0, aid0 = _emit_stage(g, state, cost, ll, cfg=cfg)
    with jax.named_scope("search/eps"):
        state, cost, (eprev, eaid) = _eps_stages(g, state, cost, cfg=cfg)
    prev = jnp.concatenate([prev0[None], eprev], axis=0)
    aid = jnp.concatenate([aid0[None], eaid], axis=0)
    return state, cost, prev, aid


# ----------------------------------------------------------------------
# v3 (relax_impl=topk) stages: one state-record fetch + top-k-first relax
# ----------------------------------------------------------------------

def _relax_topk(dst, cost, *, K, beam, min_active, F, clo_first=False):
    """Top-k-first min-merge + prune (the v3 `FindOrAddToken`+`GetCutoff`).

    Instead of sorting the full [B, N] candidate field by destination
    (v2 ``_relax_and_prune`` — measured sort-bound at production widths),
    this keeps the best K·F candidates by cost (duplicates included), then
    dedups by destination with a NARROW 3-key sort over [B, K·F], then
    re-prunes to the best K distinct states.  Exact vs v2 whenever K·F
    covers every in-beam candidate (the parity suite's regime); at finite
    beam the difference is that duplicate candidates can crowd the K·F
    cut — F (``topk_overfetch``) bounds that, mirroring how the reference
    hash always holds distinct states (ref FindOrAddToken,
    src/my-decoder/online-decoder-base-inl.h:89-137; GetCutoff :139-245).

    Ties: top_k and the (dst, cost, fi) sort both resolve equal costs by
    lowest flat candidate index — the reference's first-writer-wins.

    Returns (state i32[B,K], cost f32[B,K], fi i32[B,K] flat candidate
    index (0 where dead), alive bool[B,K], live i32[B]).  Live tokens form
    a prefix of the beam (dead slots last).
    """
    B, N = dst.shape
    KF = min(K * F, N)
    negc, fi = jax.lax.top_k(-cost, KF)
    cost_k = -negc
    dead = ~jnp.isfinite(cost_k)
    dst_k = batched_table_gather(dst, jnp.where(dead, 0, fi))
    dst_k = jnp.where(dead, BIG_STATE, dst_k)
    # dedup by destination: narrow 3-key sort, first of segment wins
    d_s, c_s, fi_s = jax.lax.sort((dst_k, cost_k, fi), num_keys=3,
                                  is_stable=False)
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), d_s[:, 1:] != d_s[:, :-1]], axis=1)
    c_s = jnp.where(first & (d_s != BIG_STATE), c_s, INF)
    # re-prune to the best K distinct states (= live-prefix compaction)
    # with the adaptive beam at DISTINCT-state rank, as v2 and the gold
    # decoder do (ref GetCutoff): the best min_active states always stay
    negc2, pos = jax.lax.top_k(-c_s, K)
    cost2 = -negc2
    alive = jnp.isfinite(cost2) & (
        (cost2 <= cost2[:, :1] + beam) | (_lane_iota(K) < min_active))
    if clo_first:
        # tokens whose destination carries the CLO_BIT ε-presence marker
        # move to the FRONT of the beam (the closure stage's marked tokens
        # then form a prefix).  This reorders only; the group key is the
        # bare 0/1 bit so it cannot be swamped by cost magnitudes (a
        # cost-weighted key breaks at beam≈1e9)
        bit = batched_table_gather(
            jnp.where(d_s != BIG_STATE, (d_s >> 30) & 1, 0),
            jnp.where(alive, pos, 0))
        _, order = jax.lax.top_k(
            jnp.where(alive, bit.astype(jnp.float32), -INF), K)
        pos = batched_table_gather(pos, order)
        cost2 = batched_table_gather(cost2, order)
        alive = batched_table_gather(alive, order)
    pos = jnp.where(alive, pos, 0)
    state2 = jnp.where(alive,
                       batched_table_gather(d_s, pos),
                       NO_STATE)
    fi2 = jnp.where(alive,
                    batched_table_gather(fi_s, pos), 0)
    cost2 = jnp.where(alive, cost2, INF)
    live = jnp.sum(alive, axis=1, dtype=jnp.int32)
    return state2, cost2, fi2, alive, live


def _emit_stage_v3(pg: PackedGraph, state, cost, ll, *, cfg):
    """ProcessEmitting, v3: ONE row fetch of each active state's packed
    record, then top-k-first relax."""
    with jax.named_scope("search/emit3"):
        K, A = cfg["K"], cfg["A"]
        B = state.shape[0]
        N = K * A
        rows = fetch_state_records(pg.records, state)
        dstN = rows[:, :, 0 * A:1 * A].reshape(B, N)
        pdfN = rows[:, :, 1 * A:2 * A].reshape(B, N)
        wN = _bits_to_f32(rows[:, :, 2 * A:3 * A]).reshape(B, N)
        valid = state != NO_STATE      # dead slots read row 0: mask them
        validN = jnp.repeat(valid, A, axis=1)
        amask = validN & (dstN >= 0)
        am = batched_table_gather(ll, jnp.where(amask, pdfN, 0))
        candN = jnp.where(amask,
                          jnp.repeat(cost, A, axis=1) + wN
                          - cfg["acoustic_scale"] * am, INF)
        dstN = jnp.where(amask, dstN, BIG_STATE)
        state2, cost2, fi, alive, _ = _relax_topk(
            dstN, candN, K=K, beam=cfg["beam"],
            min_active=cfg["min_active"], F=cfg["F"], clo_first=cfg["C"] > 0)
        prev = jnp.where(alive, fi // A, 0)
        aid = jnp.where(alive, fi, ARC_STAY)
        return state2, cost2, prev, aid


def _clo_stage_v3(pg: PackedGraph, state, cost, *, cfg):
    """ProcessNonemitting, v3: fetch the post-emit states' records, relax
    the precomputed ε-closure entries of the tokens whose state carries the
    CLO_BIT ε-presence marker (usually a small fraction on trie/HCLG
    graphs), plus a per-token stay block for every live token."""
    with jax.named_scope("search/eps3"):
        K, A, C = cfg["K"], cfg["A"], cfg["C"]
        B = state.shape[0]
        N = K * C
        valid = state != NO_STATE
        has_clo = valid & ((state >> 30) & 1).astype(bool)
        clean = jnp.where(valid, state & ~CLO_BIT, state)
        rows = fetch_state_records(pg.records, clean)
        dstN = rows[:, :, 3 * A:3 * A + C].reshape(B, N)
        wN = _bits_to_f32(rows[:, :, 3 * A + C:3 * A + 2 * C]).reshape(B, N)
        # bit-free tokens' closure lanes are padding: mask them by the
        # marker
        validN = jnp.repeat(has_clo, C, axis=1)
        emask = validN & (dstN >= 0)
        candN = jnp.where(emask, jnp.repeat(cost, C, axis=1) + wN, INF)
        dstN = jnp.where(emask, dstN, BIG_STATE)
        dst_all = jnp.concatenate(
            [dstN, jnp.where(valid, clean, BIG_STATE)], axis=1)
        cand_all = jnp.concatenate(
            [candN, jnp.where(valid, cost, INF)], axis=1)
        state2, cost2, fi, alive, _ = _relax_topk(
            dst_all, cand_all, K=K, beam=cfg["beam"],
            min_active=cfg["min_active"], F=cfg["F"])
        is_stay = fi >= N
        prev = jnp.where(alive, jnp.where(is_stay, fi - N, fi // C), 0)
        aid = jnp.where(alive & ~is_stay, fi, ARC_STAY)
        return state2, cost2, prev, aid


def _frame_step_v3(pg: PackedGraph, state, cost, ll, *, cfg):
    state, cost, prev0, aid0 = _emit_stage_v3(pg, state, cost, ll, cfg=cfg)
    if cfg["C"] > 0:
        state, cost, prev1, aid1 = _clo_stage_v3(pg, state, cost, cfg=cfg)
        prev = jnp.stack([prev0, prev1])
        aid = jnp.stack([aid0, aid1])
    else:
        prev, aid = prev0[None], aid0[None]
    return state, cost, prev, aid


@partial(jax.jit, static_argnums=(1, 2))
def _init_fn_v3(pg: PackedGraph, batch: int, static_cfg: tuple):
    cfg = dict(static_cfg)
    K = cfg["K"]
    state = jnp.full((batch, K), NO_STATE, jnp.int32)
    cost = jnp.full((batch, K), INF, jnp.float32)
    # unconditional CLO_BIT on the start token: the closure stage fetches
    # its page (harmless if start has no ε; padding lanes are masked)
    state = state.at[:, 0].set(pg.start | (CLO_BIT if cfg["C"] > 0 else 0))
    cost = cost.at[:, 0].set(0.0)
    if cfg["C"] > 0:
        state, cost, prev, aid = _clo_stage_v3(pg, state, cost, cfg=cfg)
        prev, aid = prev[None], aid[None]
    else:
        B = batch
        prev = jnp.zeros((0, B, K), jnp.int32)
        aid = jnp.zeros((0, B, K), jnp.int32)
    return BeamState(state, cost), FrameLog(prev, aid, state, cost)


@partial(jax.jit, static_argnums=(3,))
def _advance_fn_v3(pg: PackedGraph, state: BeamState, inputs,
                   static_cfg: tuple):
    cfg = dict(static_cfg)
    loglikes, frame_mask = inputs
    K = cfg["K"]

    def scan_body(carry, xs):
        st, co = carry
        ll, mask = xs
        slot3 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, K), 2)
        S_log = 1 + int(cfg["C"] > 0)

        def live_frame(args):
            st, co, ll, mask = args
            ns, nc, prev, aid = _frame_step_v3(pg, st, co, ll, cfg=cfg)
            slot_id = jnp.broadcast_to(slot3, prev.shape)
            m = mask[:, None]
            ns = jnp.where(m, ns, st)
            nc = jnp.where(m, nc, co)
            m3 = mask[None, :, None]
            prev = jnp.where(m3, prev, slot_id)
            aid = jnp.where(m3, aid, ARC_STAY)
            return ns, nc, prev, aid

        def dead_frame(args):
            st, co, ll, mask = args
            B = st.shape[0]
            prev = jnp.broadcast_to(slot3, (S_log, B, K))
            aid = jnp.full((S_log, B, K), ARC_STAY, jnp.int32)
            return st, co, prev, aid

        # whole-batch masked frames (blank-skip packed tails, chunk
        # padding) skip the frame step entirely — the analogue of the
        # reference's SkipBlockFrame fast path (ref nnet-nnet.h:265-275)
        ns, nc, prev, aid = jax.lax.cond(
            jnp.any(mask), live_frame, dead_frame, (st, co, ll, mask))
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
        scan_body, (state.tok_state, state.tok_cost), (lls, masks))
    return BeamState(st, co), FrameLog(prevs, aids, toks, costs)


# ----------------------------------------------------------------------
# jitted entry points — module-level and keyed only by the static config +
# array shapes, so decoders over different graphs share compilations
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2))
def _init_fn(g: GraphArrays, batch: int, static_cfg: tuple):
    cfg = dict(static_cfg)
    K = cfg["K"]
    state = jnp.full((batch, K), NO_STATE, jnp.int32)
    cost = jnp.full((batch, K), INF, jnp.float32)
    state = state.at[:, 0].set(g.start)
    cost = cost.at[:, 0].set(0.0)
    state, cost, (prev, aid) = _eps_stages(g, state, cost, cfg=cfg)
    return BeamState(state, cost), FrameLog(prev, aid, state, cost)


@partial(jax.jit, static_argnums=(3,))
def _advance_fn(g: GraphArrays, state: BeamState, inputs, static_cfg: tuple):
    cfg = dict(static_cfg)
    loglikes, frame_mask = inputs
    K = cfg["K"]

    def scan_body(carry, xs):
        st, co = carry
        ll, mask = xs                              # [B,V], [B]
        ns, nc, prev, aid = _frame_step(g, st, co, ll, cfg=cfg)
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

    lls = jnp.swapaxes(loglikes, 0, 1)             # [T,B,V]
    masks = jnp.swapaxes(frame_mask, 0, 1)         # [T,B]
    (st, co), (prevs, aids, toks, costs) = jax.lax.scan(
        scan_body, (state.tok_state, state.tok_cost), (lls, masks))
    # logs: prev/aid [T,S,B,K]; token snapshots [T,B,K]
    return BeamState(st, co), FrameLog(prevs, aids, toks, costs)


class TpuBeamSearch:
    """Jit-compiled batched beam-search decoder over a fixed graph.

    Equivalent surface to the reference ``DecoderItf``
    (ref: src/my-decoder/decoder-itf.h:10-25): ``init_state`` ≡ InitDecoding,
    ``advance`` ≡ AdvanceDecoding (a chunk of frames), host ``traceback``
    ≡ GetBestPath.
    """

    def __init__(self, dev: DeviceFst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None):
        self.config = config or DecoderConfig()
        self.config.check()
        self.dev = dev
        self._ilabel2pdf = np.asarray(ilabel2pdf, np.int32)
        cfg = self.config
        assert dev.max_em_degree <= cfg.arc_lanes, \
            "graph not degree-bounded: rebuild DeviceFst with arc_lanes"

        mode = cfg.eps_mode
        if mode in ("auto", "closure"):
            try:
                dev.build_closure()
                C = dev.max_closure_size
                if mode == "auto" and C > cfg.closure_lanes_max:
                    mode = "sweeps"
                else:
                    mode = "closure"
            except ValueError:
                if mode == "closure":
                    raise
                mode = "sweeps"
        if mode == "sweeps":
            eps_iters = cfg.eps_iters or dev.eps_depth
            assert eps_iters >= 0, \
                "epsilon cycle: sweeps mode unusable (use eps_mode=closure)"
        else:
            eps_iters = 0
        self.mode = mode

        # relax implementation: v3 (topk + packed state records) needs the
        # closure table and a state record of at most 128 lanes
        relax = cfg.relax_impl
        A = max(dev.max_em_degree, 1)
        C = dev.max_closure_size if mode == "closure" else 0
        v3_ok = (mode == "closure"
                 and packed_lanes(A, C) > 0
                 and cfg.log_snapshots)
        if relax == "auto":
            relax = "topk" if v3_ok else "sort"
        elif relax == "topk":
            assert v3_ok, ("relax_impl=topk needs eps_mode=closure, a "
                           "record of 3A+2C<=128 lanes and log_snapshots")
        self.relax_impl = relax

        K = min(cfg.beam_width, cfg.max_active)
        if relax == "topk":
            self.pgraph = make_packed_graph(dev, ilabel2pdf)
            self.graph = None
            self._static = tuple(sorted(dict(
                K=K, A=A, C=C,
                F=int(cfg.topk_overfetch),
                beam=float(cfg.beam),
                min_active=int(cfg.min_active),
                acoustic_scale=float(cfg.acoustic_scale),
                log_snapshots=bool(cfg.log_snapshots),
            ).items()))
            self.num_stages = 1 + int(C > 0)
        else:
            self.pgraph = None
            self.graph = make_graph_arrays(dev, ilabel2pdf, mode)
            self._static = tuple(sorted(dict(
                K=K,
                A=int(self.graph.em_rec.shape[1]) // 4,
                E=eps_iters,
                C=C,
                mode=mode,
                beam=float(cfg.beam),
                min_active=int(cfg.min_active),
                acoustic_scale=float(cfg.acoustic_scale),
                log_snapshots=bool(cfg.log_snapshots),
            ).items()))
            self.num_stages = 1 + (eps_iters if mode == "sweeps"
                                   else int(C > 0))
        self.beam_width = K

    # -- InitDecoding ------------------------------------------------------
    def init_state(self, batch: int) -> tuple[BeamState, FrameLog]:
        if self.relax_impl == "topk":
            return _init_fn_v3(self.pgraph, batch, self._static)
        return _init_fn(self.graph, batch, self._static)

    # -- AdvanceDecoding over a chunk of frames ----------------------------
    def advance(self, state: BeamState, loglikes, frame_mask=None):
        """loglikes f32[B,T,V]; frame_mask bool[B,T] (False = padding)."""
        loglikes = jnp.asarray(loglikes, jnp.float32)
        B, T, _ = loglikes.shape
        if frame_mask is None:
            frame_mask = jnp.ones((B, T), bool)
        if self.relax_impl == "topk":
            return _advance_fn_v3(self.pgraph, state,
                                  (loglikes, jnp.asarray(frame_mask)),
                                  self._static)
        return _advance_fn(self.graph, state,
                           (loglikes, jnp.asarray(frame_mask)), self._static)

    def decode(self, loglikes, frame_mask=None):
        """Full utterance decode: init + advance.  Returns
        (final BeamState, init FrameLog, frame FrameLogs)."""
        B = loglikes.shape[0]
        state, init_log = self.init_state(B)
        state, logs = self.advance(state, loglikes, frame_mask)
        return state, init_log, logs

    # -- host-side raw lattice (ref GetRawLattice inl.h:869-977) -----------
    def token_sets(self, init_log: FrameLog, logs: FrameLog, b: int,
                   num_frames: int | None = None) -> list[dict[int, float]]:
        """Per-frame surviving-token sets {orig_state: cost} for utterance
        ``b``, folding split continuation states back to their source state
        (they are ε-0 copies, so min-merge is exact)."""
        if not self.config.log_snapshots:
            raise RuntimeError(
                "lattice reconstruction needs DecoderConfig.log_snapshots="
                "True (token snapshots were not recorded)")
        orig = self.dev.orig_state
        T = logs.tok_state.shape[0]
        if num_frames is None:
            num_frames = T
        out = []
        snaps = [(np.asarray(init_log.tok_state[b]),
                  np.asarray(init_log.tok_cost[b]))]
        snaps += [(np.asarray(logs.tok_state[t, b]),
                   np.asarray(logs.tok_cost[t, b]))
                  for t in range(num_frames)]
        for st, co in snaps:
            ok = (st >= 0) & np.isfinite(co)
            toks: dict[int, float] = {}
            for s, c in zip(orig[st[ok]], co[ok]):
                s = int(s)
                c = float(c)
                if c < toks.get(s, np.inf):
                    toks[s] = c
            out.append(toks)
        return out

    def get_lattices(self, init_log: FrameLog, logs: FrameLog,
                     loglikes, fst, frame_mask=None):
        """Reconstruct pruned raw lattices for every utterance from the
        device token snapshots (see decoder/raw_lattice.py).  ``fst`` is the
        source StdFst; ``loglikes`` f32[B,T,V] as given to ``advance``."""
        from asr_decoder_tpu.decoder.raw_lattice import \
            lattice_from_token_sets
        loglikes = np.asarray(loglikes)
        B, T = loglikes.shape[:2]
        lens = (np.asarray(frame_mask).sum(axis=1).astype(int)
                if frame_mask is not None else np.full(B, T))
        i2p = np.asarray(self._ilabel2pdf, np.int64)
        return [lattice_from_token_sets(
                    fst, self.token_sets(init_log, logs, b, int(lens[b])),
                    loglikes[b, :int(lens[b])], i2p, self.config)
                for b in range(B)]

    # -- host-side best path (ref GetBestPath / TraceBackBestPath,
    #    online-decoder-base-inl.h:1072-1161) ------------------------------
    def _decode_stage_arcs(self, stage: int, a: int) -> list[int]:
        """Map a logged per-stage arc id to original StdFst arc ids
        (reversed, for backward accumulation)."""
        if a < 0:
            return []
        if stage == 0:                       # emitting block index
            return [int(self.dev.em_arcid[a])]
        if self.mode == "closure":           # closure entry index
            # backward-ordered ε-path arc ids, ragged CSR
            return [int(x) for x in self.dev.clo_paths(a)]
        aid = int(self.dev.eps_arcid[a])     # ε block index
        return [aid] if aid >= 0 else []     # skip split-chain links

    def traceback(self, state: BeamState, init_log: FrameLog,
                  logs, fst_arcs=None):
        """Returns per-utterance dicts with arc ids, words, ilabels, cost.

        ``logs``: one merged FrameLog OR a list of per-chunk FrameLogs —
        the list form walks chunks in reverse without concatenating them,
        so streaming partials stay O(T) per call (the reference's
        TraceBackBestPath is the same single backward walk,
        ref: online-decoder-base-inl.h:1097-1161).
        ``fst_arcs``: the source StdFst (for olabel/ilabel lookup); if None,
        only arc ids and cost are returned.
        """
        if self.relax_impl == "topk":
            return self._traceback_v3(state, init_log, logs, fst_arcs)
        tok_state = np.asarray(state.tok_state)
        tok_cost = np.asarray(state.tok_cost)
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(np.asarray(c[0]), np.asarray(c[1])) for c in chunks]
        iprev = np.asarray(init_log.prev_slot)  # [S_eps,B,K]
        iaid = np.asarray(init_log.arc_id)
        final_id = int(self.dev.final_state)
        results = []
        for b in range(tok_state.shape[0]):
            # prefer the super-final token; else the best live token
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                slot = int(finals[np.argmin(tok_cost[b][finals])])
                reached_final = True
            else:
                slot = int(np.argmin(tok_cost[b]))
                reached_final = False
            total = float(tok_cost[b, slot])
            arcs_rev: list[int] = []
            for prevs, aids in reversed(chunks):
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
                       reached_final=reached_final)
            if fst_arcs is not None:
                ol = fst_arcs.arc_olabel[arc_ids]
                il = fst_arcs.arc_ilabel[arc_ids]
                res["words"] = [int(x) for x in ol[ol != 0]]
                res["ilabels"] = [int(x) for x in il[il != 0]]
            results.append(res)
        return results

    def _traceback_v3(self, state: BeamState, init_log: FrameLog,
                      logs, fst_arcs=None):
        """v3 traceback: the device logs only (prev_slot, flat candidate
        index); arc ids are re-derived host-side as
        ``em_arcid[em_offset[prev_state] + lane]`` (and closure entries as
        ``clo_offset[post_emit_state] + lane``) using the logged token-state
        snapshots — same backward walk as the reference TraceBackBestPath
        (ref: online-decoder-base-inl.h:1097-1161)."""
        dev = self.dev
        cfg = dict(self._static)
        A, C = cfg["A"], cfg["C"]
        K = cfg["K"]
        tok_state = np.asarray(state.tok_state)
        tok_cost = np.asarray(state.tok_cost)
        chunks = logs if isinstance(logs, list) else [logs]
        chunks = [(np.asarray(c.prev_slot), np.asarray(c.arc_id),
                   np.asarray(c.tok_state)) for c in chunks]
        init_snap = np.asarray(init_log.tok_state)
        iprev = np.asarray(init_log.prev_slot)
        iaid = np.asarray(init_log.arc_id)
        final_id = int(self.dev.final_state)
        results = []
        for b in range(tok_state.shape[0]):
            finals = np.where(tok_state[b] == final_id)[0]
            if len(finals):
                slot = int(finals[np.argmin(tok_cost[b][finals])])
                reached_final = True
            else:
                slot = int(np.argmin(tok_cost[b]))
                reached_final = False
            total = float(tok_cost[b, slot])
            arcs_rev: list[int] = []

            def emit_resolve(aids, prevs, t, slot, prev_state_of):
                """Resolve the emit stage at (t, slot): appends the emit
                arc, returns (prev slot, post-emit state or -1)."""
                fi = int(aids[t, 0, b, slot])
                p = int(prevs[t, 0, b, slot])
                if fi < 0:
                    return p, -1
                lane = fi % A
                ps = prev_state_of(int(fi // A))
                ai = int(dev.em_offset[ps]) + lane
                arcs_rev.append(int(dev.em_arcid[ai]))
                return int(fi // A), int(dev.em_dst[ai])

            def peek_emit_dst(aids, prevs, t, slot, prev_state_of):
                """Post-emit state at (t, slot) without appending arcs."""
                fi = int(aids[t, 0, b, slot])
                assert fi >= 0, "closure entry above a stay emit slot"
                ps = prev_state_of(int(fi // A))
                return int(dev.em_dst[int(dev.em_offset[ps]) + fi % A])

            for ci in range(len(chunks) - 1, -1, -1):
                prevs, aids, snaps = chunks[ci]
                T = prevs.shape[0]
                for t in range(T - 1, -1, -1):
                    if t > 0:
                        prior = snaps[t - 1]
                    elif ci > 0:
                        prior = chunks[ci - 1][2][-1]
                    else:
                        prior = init_snap

                    def prev_state_of(p, prior=prior):
                        return int(prior[b, p])

                    if C > 0:
                        fi1 = int(aids[t, 1, b, slot])
                        slot = int(prevs[t, 1, b, slot])
                        if fi1 >= 0:
                            # ε-path arcs follow the emit arc on the
                            # forward path ⇒ in backward accumulation they
                            # come first; clo_paths rows are already
                            # backward-ordered (last edge at level 0)
                            s_emit = peek_emit_dst(
                                aids, prevs, t, slot, prev_state_of)
                            entry = int(dev.clo_offset[s_emit]) + fi1 % C
                            arcs_rev.extend(
                                int(x) for x in dev.clo_paths(entry))
                    slot, _ = emit_resolve(aids, prevs, t, slot,
                                           prev_state_of)
            # init closure stage: pre-closure beam = [start] at slot 0
            if iprev.shape[0]:
                fi1 = int(iaid[0, b, slot])
                p1 = int(iprev[0, b, slot])
                slot = p1
                if fi1 >= 0:
                    entry = int(dev.clo_offset[int(dev.start)]) + fi1 % C
                    arcs_rev.extend(int(x) for x in dev.clo_paths(entry))
            arc_ids = arcs_rev[::-1]
            res = dict(arc_ids=arc_ids, cost=total,
                       reached_final=reached_final)
            if fst_arcs is not None:
                ol = fst_arcs.arc_olabel[arc_ids]
                il = fst_arcs.arc_ilabel[arc_ids]
                res["words"] = [int(x) for x in ol[ol != 0]]
                res["ilabels"] = [int(x) for x in il[il != 0]]
            results.append(res)
        return results
