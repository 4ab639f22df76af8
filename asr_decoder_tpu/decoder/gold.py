"""Host reference decoder: exact token-passing beam search with lattices.

This is the framework's semantic gold standard — a clean-room numpy/Python
implementation of the capability of the reference's
``OnlineLatticeDecoderBase`` (ref: src/my-decoder/online-decoder-base.h,
online-decoder-base-inl.h): frame-synchronous Viterbi over the CSR graph with
beam + max/min-active pruning, exact ε-closure, ForwardLink recording, raw
lattice extraction with lattice-beam extra-cost pruning (ref PruneForwardLinks
inl.h:483-577, GetRawLattice :869-977), and best path.

It defines the semantics the device search (`ops/beamsearch.py`) must match:
per-frame order = emitting expansion → prune → ε-closure → prune, with
pruning = "beam margin over best, capped at max_active, never below
min_active".  (The reference's *adaptive* cutoff estimation, inl.h:139-245,
is a work-saving heuristic around the same semantics.)

It is deliberately simple and slow — used for parity tests and as the
host-side lattice builder until the device link-log path lands.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.decoder.raw_lattice import lattice_from_token_sets
from asr_decoder_tpu.fst.fst import EPSILON, StdFst
from asr_decoder_tpu.fst.lattice import Lattice
from asr_decoder_tpu.fst.semiring import INF


@dataclass
class GoldResult:
    words: list[int]
    ilabels: list[int]
    cost: float
    reached_final: bool
    lattice: Lattice | None = None


class GoldDecoder:
    """Single-utterance offline decode over precomputed log-likelihoods."""

    def __init__(self, fst: StdFst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None):
        self.fst = fst
        self.ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
        self.config = config or DecoderConfig()

    # -- pruning with the dense-search semantics --------------------------
    def _prune(self, toks: dict[int, float]) -> dict[int, float]:
        cfg = self.config
        if not toks:
            return toks
        costs = np.array(list(toks.values()))
        best = costs.min()
        order = np.sort(costs)
        cap = min(cfg.max_active, cfg.beam_width)
        cutoff = best + cfg.beam
        if len(order) > cap:
            cutoff = min(cutoff, float(order[cap - 1]))
        if cfg.min_active > 0 and len(order) > cfg.min_active:
            cutoff = max(cutoff, float(order[cfg.min_active - 1]))
        return {s: c for s, c in toks.items() if c <= cutoff}

    def _eps_closure(self, toks: dict[int, float]):
        """Exact ε-closure by worklist relaxation
        (ref ProcessNonemitting, inl.h:354-437)."""
        fst = self.fst
        work = list(toks)
        while work:
            s = work.pop()
            c = toks[s]
            lo, hi = int(fst.state_offset[s]), int(fst.state_eps_end[s])
            for i in range(lo, hi):
                d = int(fst.arc_dst[i])
                nc = c + float(fst.arc_weight[i])
                if nc < toks.get(d, INF):
                    toks[d] = nc
                    work.append(d)
        return toks

    def decode(self, loglikes: np.ndarray,
               want_lattice: bool = True) -> GoldResult:
        """loglikes: f32[T, V] acoustic log-likelihood rows."""
        fst = self.fst
        cfg = self.config
        scale = cfg.acoustic_scale
        T = loglikes.shape[0]

        frame_toks: list[dict[int, float]] = []

        toks = {int(fst.start): 0.0}
        self._eps_closure(toks)
        toks = self._prune(toks)
        frame_toks.append(dict(toks))

        for t in range(T):
            ll = loglikes[t]
            new: dict[int, float] = {}
            for s, c in toks.items():
                lo = int(fst.state_eps_end[s])
                hi = int(fst.state_offset[s + 1])
                for i in range(lo, hi):
                    il = int(fst.arc_ilabel[i])
                    am = -scale * float(ll[self.ilabel2pdf[il]])
                    nc = c + float(fst.arc_weight[i]) + am
                    d = int(fst.arc_dst[i])
                    if nc < new.get(d, INF):
                        new[d] = nc
            new = self._prune(new)
            self._eps_closure(new)
            new = self._prune(new)
            frame_toks.append(dict(new))
            toks = new

        final_id = fst.final_state
        if final_id in toks:
            best_cost = toks[final_id]
            reached = True
        else:
            best_cost = min(toks.values()) if toks else INF
            reached = False

        lattice = None
        if want_lattice:
            lattice = lattice_from_token_sets(
                fst, frame_toks, loglikes, self.ilabel2pdf, cfg)
        words, ilabels = [], []
        if lattice is not None:
            words, ilabels, _, _ = lattice.to_vector()
        return GoldResult(words=words, ilabels=ilabels, cost=float(best_cost),
                          reached_final=reached, lattice=lattice)


class GoldClgDecoder:
    """Host reference for CLG-on-the-fly decoding over the virtual
    composite automaton (fst/clg.py): emitting expansion from HMM virtual
    states, ε phase = CLG ε arcs + HMM entry hops + HMM exit hops.

    Semantics parity target for ``TpuClgBeamSearch`` — equivalent (up to
    the entry-hop retiming described in fst/clg.py) to the reference's
    nested clg×hmm ProcessEmitting
    (ref: src/my-decoder/online-clg-decoder-mempool-base.h:120-204)."""

    def __init__(self, clgfst, ilabel2pdf: np.ndarray,
                 config: DecoderConfig | None = None):
        self.g = clgfst
        self.ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
        self.config = config or DecoderConfig()

    _prune = GoldDecoder._prune

    def _eps_closure(self, toks, bp):
        work = list(toks)
        while work:
            v = work.pop()
            c = toks[v]
            for dst, w, ol, kind, arc in self.g.eps_expand(v):
                nc = c + w
                if nc < toks.get(dst, INF):
                    toks[dst] = nc
                    bp[dst] = (v, ol, 0)
                    work.append(dst)
        return toks

    def decode(self, loglikes: np.ndarray,
               want_lattice: bool = False) -> GoldResult:
        g = self.g
        cfg = self.config
        scale = cfg.acoustic_scale
        T = loglikes.shape[0]

        toks = {g.start(): 0.0}
        bps: list[dict] = [dict()]
        self._eps_closure(toks, bps[0])
        toks = self._prune(toks)
        frame_toks = [dict(toks)]

        for t in range(T):
            ll = loglikes[t]
            new: dict = {}
            bp: dict = {}
            for v, c in toks.items():
                for dst, w, il in g.emit_expand(v):
                    am = -scale * float(ll[self.ilabel2pdf[il]])
                    nc = c + w + am
                    if nc < new.get(dst, INF):
                        new[dst] = nc
                        bp[dst] = ((v, t), 0, il)
            new = self._prune(new)
            self._eps_closure(new, bp)
            new = self._prune(new)
            bps.append(bp)
            toks = new
            frame_toks.append(dict(toks))

        finals = {v: c for v, c in toks.items() if g.is_final(v)}
        if finals:
            best_key = min(finals, key=finals.get)
            best_cost = finals[best_key]
            reached = True
        else:
            best_key = min(toks, key=toks.get) if toks else None
            best_cost = toks[best_key] if toks else INF
            reached = False

        words_rev, il_rev = [], []
        if best_key is not None:
            key = best_key
            t = T
            while t >= 0:
                bp = bps[t]
                took = False
                while key in bp:
                    prev, ol, il = bp[key]
                    if isinstance(prev, tuple):   # emitting hop
                        if il:
                            il_rev.append(il)
                        key = prev[0]
                        took = True
                        break
                    if ol:
                        words_rev.append(ol)
                    key = prev
                if t > 0 and not took:
                    raise AssertionError("broken CLG backpointer chain")
                t -= 1
        lattice = None
        if want_lattice:
            from asr_decoder_tpu.decoder.raw_lattice import (
                ClgExpander, lattice_from_token_sets_generic)
            lattice = lattice_from_token_sets_generic(
                ClgExpander(g), frame_toks, loglikes, self.ilabel2pdf, cfg)
        return GoldResult(words=words_rev[::-1], ilabels=il_rev[::-1],
                          cost=float(best_cost), reached_final=reached,
                          lattice=lattice)


class GoldBigLmDecoder:
    """Host reference for the BigLM in-search pair decoder: token identity
    is (fst_state, lm1_state, lm2_state) and word-olabel arcs add the
    difference-LM score to the graph cost (ref semantics:
    src/my-decoder/online-decoder-mempool-base-biglm.h:316-469 with
    DiffArpaLm, src/newlm/diff-lm.h).  Tracks backpointers for the best
    path; final cost adds the diff LM's sentence-end cost
    (ref ComputeFinalCosts :161-216)."""

    def __init__(self, fst: StdFst, ilabel2pdf: np.ndarray, fsa1, fsa2,
                 lm1_scale: float = 1.0, lm2_scale: float = 1.0,
                 config: DecoderConfig | None = None):
        self.fst = fst
        self.ilabel2pdf = np.asarray(ilabel2pdf, np.int64)
        self.fsa1, self.fsa2 = fsa1, fsa2
        self.lm1_scale, self.lm2_scale = lm1_scale, lm2_scale
        self.config = config or DecoderConfig()

    def _lm_advance(self, l1: int, l2: int, ol: int):
        if ol <= 0:
            return l1, l2, 0.0
        n1, c1 = self.fsa1.get_arc(l1, ol)
        n2, c2 = self.fsa2.get_arc(l2, ol)
        return n1, n2, self.lm2_scale * c2 - self.lm1_scale * c1

    def _lm_final(self, l1: int, l2: int) -> float:
        return (self.lm2_scale * self.fsa2.final(l2)
                - self.lm1_scale * self.fsa1.final(l1))

    def _prune(self, toks):
        cfg = self.config
        if not toks:
            return toks
        costs = np.array(list(toks.values()))
        best = costs.min()
        order = np.sort(costs)
        cap = min(cfg.max_active, cfg.beam_width)
        cutoff = best + cfg.beam
        if len(order) > cap:
            cutoff = min(cutoff, float(order[cap - 1]))
        if cfg.min_active > 0 and len(order) > cfg.min_active:
            cutoff = max(cutoff, float(order[cfg.min_active - 1]))
        return {k: c for k, c in toks.items() if c <= cutoff}

    def _eps_closure(self, toks, bp):
        fst = self.fst
        work = list(toks)
        while work:
            key = work.pop()
            s, l1, l2 = key
            c = toks[key]
            lo, hi = int(fst.state_offset[s]), int(fst.state_eps_end[s])
            for i in range(lo, hi):
                n1, n2, lc = self._lm_advance(l1, l2,
                                              int(fst.arc_olabel[i]))
                nk = (int(fst.arc_dst[i]), n1, n2)
                nc = c + float(fst.arc_weight[i]) + lc
                if nc < toks.get(nk, INF):
                    toks[nk] = nc
                    bp[nk] = (key, i)
                    work.append(nk)
        return toks

    def decode(self, loglikes: np.ndarray,
               want_lattice: bool = False) -> GoldResult:
        fst = self.fst
        cfg = self.config
        scale = cfg.acoustic_scale
        T = loglikes.shape[0]

        start = (int(fst.start), self.fsa1.start, self.fsa2.start)
        toks = {start: 0.0}
        bps: list[dict] = [dict()]
        self._eps_closure(toks, bps[0])
        toks = self._prune(toks)
        frame_toks = [dict(toks)]

        for t in range(T):
            ll = loglikes[t]
            new: dict = {}
            bp: dict = {}
            for (s, l1, l2), c in toks.items():
                lo = int(fst.state_eps_end[s])
                hi = int(fst.state_offset[s + 1])
                for i in range(lo, hi):
                    il = int(fst.arc_ilabel[i])
                    am = -scale * float(ll[self.ilabel2pdf[il]])
                    n1, n2, lc = self._lm_advance(l1, l2,
                                                  int(fst.arc_olabel[i]))
                    nc = c + float(fst.arc_weight[i]) + lc + am
                    nk = (int(fst.arc_dst[i]), n1, n2)
                    if nc < new.get(nk, INF):
                        new[nk] = nc
                        bp[nk] = ((s, l1, l2, t), i)
            new = self._prune(new)
            self._eps_closure(new, bp)
            new = self._prune(new)
            bps.append(bp)
            toks = new
            frame_toks.append(dict(toks))

        final_id = fst.final_state
        finals = {k: c + self._lm_final(k[1], k[2])
                  for k, c in toks.items() if k[0] == final_id}
        if finals:
            best_key = min(finals, key=finals.get)
            best_cost = finals[best_key]
            reached = True
        else:
            best_key = min(toks, key=toks.get) if toks else None
            best_cost = toks[best_key] if toks else INF
            reached = False

        # backpointer walk: per-frame bp dicts; a frame's emitting entry
        # records its source token at the *previous* frame
        words, ilabels, arc_ids = [], [], []
        if best_key is not None:
            key = best_key
            t = T
            while t >= 0:
                bp = bps[t]
                took = False
                while key in bp:
                    prev, arc = bp[key]
                    arc_ids.append(arc)
                    if len(prev) == 4:       # emitting hop → previous frame
                        key = prev[:3]
                        took = True
                        break
                    key = prev
                if t > 0 and not took:
                    # token carried? cannot happen: every frame-t token
                    # descends from an emitting arc at frame t
                    raise AssertionError("broken backpointer chain")
                t -= 1
            arc_ids.reverse()
            ol = fst.arc_olabel[arc_ids]
            il = fst.arc_ilabel[arc_ids]
            words = [int(x) for x in ol[ol != 0]]
            ilabels = [int(x) for x in il[il != 0]]
        lattice = None
        if want_lattice:
            from asr_decoder_tpu.decoder.raw_lattice import (
                BigLmExpander, lattice_from_token_sets_generic)
            exp = BigLmExpander(fst, self._lm_advance, self._lm_final)
            lattice = lattice_from_token_sets_generic(
                exp, frame_toks, loglikes, self.ilabel2pdf, cfg)
        return GoldResult(words=words, ilabels=ilabels,
                          cost=float(best_cost), reached_final=reached,
                          lattice=lattice)
