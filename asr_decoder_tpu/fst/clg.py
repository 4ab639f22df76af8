"""CLG-on-the-fly composite graph: CLG WFST ⊗ per-phone HMM sub-FSTs.

Device-side equivalent of the reference's ``ClgFst``
(ref: src/my-decoder/clg-fst.h:9-189): instead of pre-composing H with CLG
into a monolithic HCLG, the search walks a *virtual* state space

  * ``v < offset``                      — a CLG graph state,
  * ``v = arcid + (hmmstate+1)*offset`` — HMM state ``hmmstate`` of the HMM
    attached to CLG arc ``arcid`` (the arc's ilabel picks the HMM),

with ``offset = clg.num_arcs + 1`` (ref MapClgTokenStateId arithmetic,
clg-fst.h:135-165).  Where the reference nests clg-arc × hmm-arc loops
inside ProcessEmitting (online-clg-decoder-mempool-base.h:120-204), the
device re-design flattens the composite into a *uniform* automaton over
virtual states that the dense beam kernel can expand with fixed-lane
gathers:

  * ε transitions:
      - CLG state, ε arc       → arc.dst              (weight, olabel)
      - CLG state, non-ε arc   → arcid + offset       (HMM *entry* hop:
        CLG weight + olabel paid here — the reference folds both into the
        first emitting hop, which retimes identically)
      - HMM state with ε arc   → clg_dst(arcid)       (HMM *exit* hop)
  * emitting transitions (HMM virtual states only):
      - self-loop (arc.to == hmmstate)  → v
      - forward   (arc.to == hmmstate+1)→ v + offset

Because entry is an ε hop, tokens rest at HMM entry states between frames
and the emitting stage needs only ONE gather level (HMM arc rows) — the
two-level clg×hmm nest becomes table indirection at graph-load time.

HMM bundle binary format (ref ReadHmm, clg-fst.h:48-73): ``int32 numhmm``
followed by ``numhmm`` standard-format FST bodies; HMM i is addressed by
ilabel i+1, and olabels are dropped on load (ref RmOlalel).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from asr_decoder_tpu.fst.fst import (_ARC_DT, _STATEINFO_DT, EPSILON,
                                     StdFst)

INF = float("inf")


def _read_one_fst(f) -> StdFst:
    hdr = f.read(24)
    if len(hdr) != 24:
        raise IOError("truncated fst header in hmm bundle")
    start, final, nstates, narcs, _, _ = struct.unpack("<6i", hdr)
    infos = np.frombuffer(f.read(_STATEINFO_DT.itemsize * nstates),
                          _STATEINFO_DT)
    arcs = np.frombuffer(f.read(_ARC_DT.itemsize * narcs), _ARC_DT)
    if len(infos) != nstates or len(arcs) != narcs:
        raise IOError("truncated fst body in hmm bundle")
    counts = infos["num_arcs"].astype(np.int64)
    src = np.repeat(np.arange(nstates, dtype=np.int64), counts)
    return StdFst.from_arcs(nstates, start, final, src, arcs["ilabel"],
                            np.zeros(narcs, np.int32),   # RmOlalel
                            arcs["weight"], arcs["dst"])


def read_hmm_bundle(path: str) -> list:
    """[None, hmm₁, …, hmmₙ] — HMM for ilabel i at index i
    (ref ReadHmm, clg-fst.h:48-73)."""
    with open(path, "rb") as f:
        (numhmm,) = struct.unpack("<i", f.read(4))
        return [None] + [_read_one_fst(f) for _ in range(numhmm)]


def write_hmm_bundle(path: str, hmms: list) -> None:
    """Inverse of ``read_hmm_bundle``; ``hmms[0]`` (None) is skipped."""
    with open(path, "wb") as f:
        body = [h for h in hmms if h is not None]
        f.write(struct.pack("<i", len(body)))
        for h in body:
            nstates, narcs = h.num_states, h.num_arcs
            infos = np.zeros(nstates, _STATEINFO_DT)
            infos["num_arcs"] = np.diff(h.state_offset).astype(np.uint32)
            infos["niepsilons"] = (h.state_eps_end -
                                   h.state_offset[:-1]).astype(np.uint32)
            arcs = np.zeros(narcs, _ARC_DT)
            arcs["ilabel"] = h.arc_ilabel
            arcs["olabel"] = 0
            arcs["weight"] = h.arc_weight
            arcs["dst"] = h.arc_dst
            f.write(struct.pack("<6i", h.start, h.final_state, nstates,
                                narcs, int(np.sum(h.arc_ilabel == EPSILON)),
                                narcs))
            infos.tofile(f)
            arcs.tofile(f)


@dataclass
class ClgFst:
    """Host composite: CLG graph + HMM list (index = CLG arc ilabel).

    Checks the linear-chain HMM contract the virtual arithmetic relies on
    (ref MapClgTokenStateId 'curstate + _offset', clg-fst.h:146-151): every
    emitting HMM arc goes to its own state (self-loop) or to state+1, and
    every ε HMM arc exits the HMM (destination ignored, ref returns
    ``clg_arc->_to``)."""

    clg: StdFst
    hmms: list          # [None, StdFst, ...]

    def __post_init__(self):
        self.offset = self.clg.num_arcs + 1
        used = set(int(x) for x in
                   self.clg.arc_ilabel[self.clg.arc_ilabel != EPSILON])
        max_h = 0
        for il in used:
            if il >= len(self.hmms) or self.hmms[il] is None:
                raise ValueError(f"CLG arc ilabel {il} has no HMM")
            h = self.hmms[il]
            max_h = max(max_h, h.num_states)
            for s in range(h.num_states):
                for (hil, _, _, d) in h.arcs(s):
                    if hil != EPSILON and d not in (s, s + 1):
                        raise ValueError(
                            f"HMM {il} arc {s}->{d} breaks the chain "
                            "topology the CLG arithmetic needs")
        if self.offset * (max_h + 2) >= 2**31:
            raise ValueError("virtual state space overflows int32 "
                             "(ref clg-fst.h:26 asserts the same bound)")
        self.max_hmm_states = max_h

    @staticmethod
    def load(clg_path: str, hmm_path: str) -> "ClgFst":
        """ref ClgFst::Init (clg-fst.h:17-32)."""
        return ClgFst(StdFst.read_binary(clg_path),
                      read_hmm_bundle(hmm_path))

    # -- virtual state helpers (host mirror of the device arithmetic) -----
    def in_clg(self, v: int) -> bool:
        return v < self.offset

    def split(self, v: int) -> tuple[int, int]:
        """virtual → (clg arc id, hmm state)."""
        return v % self.offset, v // self.offset - 1

    def hmm_of_arc(self, arcid: int) -> StdFst:
        return self.hmms[int(self.clg.arc_ilabel[arcid])]

    def start(self) -> int:
        return self.clg.start

    def is_final(self, v: int) -> bool:
        return v < self.offset and v == self.clg.final_state

    def eps_expand(self, v: int):
        """Yield (dst_virtual, weight, olabel, kind, arc_or_None) ε hops
        from ``v`` — kind ∈ {'eps','entry','exit'}."""
        if v < self.offset:
            lo, hi = self.clg.arc_range(v)
            ee = int(self.clg.state_eps_end[v])
            for i in range(lo, ee):       # real CLG ε arcs
                yield (int(self.clg.arc_dst[i]),
                       float(self.clg.arc_weight[i]),
                       int(self.clg.arc_olabel[i]), "eps", i)
            for i in range(ee, hi):       # HMM entry hops
                yield (i + self.offset, float(self.clg.arc_weight[i]),
                       int(self.clg.arc_olabel[i]), "entry", i)
        else:
            arcid, hs = self.split(v)
            h = self.hmm_of_arc(arcid)
            if hs < h.num_states:
                lo = int(h.state_offset[hs])
                ee = int(h.state_eps_end[hs])
                for i in range(lo, ee):   # exit hops
                    yield (int(self.clg.arc_dst[arcid]),
                           float(h.arc_weight[i]), 0, "exit", None)

    def emit_expand(self, v: int):
        """Yield (dst_virtual, weight, ilabel) emitting arcs from ``v``."""
        if v < self.offset:
            return
        arcid, hs = self.split(v)
        h = self.hmm_of_arc(arcid)
        if hs >= h.num_states:
            return
        ee = int(h.state_eps_end[hs])
        hi = int(h.state_offset[hs + 1])
        for i in range(ee, hi):
            d = int(h.arc_dst[i])
            dst = v if d == hs else v + self.offset
            yield dst, float(h.arc_weight[i]), int(h.arc_ilabel[i])

    # -- ε-sweep bound -----------------------------------------------------
    def eps_depth(self) -> int:
        """Exact bound on chained ε hops from any reachable token state:
        longest ε chain over {CLG ε arcs, entry hops, exit hops}.  Raises
        on ε-cycles (same precondition as DeviceFst sweeps mode)."""
        clg = self.clg
        S = clg.num_states
        memo = np.full(S, -1, np.int64)
        on_stack = np.zeros(S, bool)

        def hmm_state0_exit(arcid: int) -> bool:
            h = self.hmm_of_arc(arcid)
            return int(h.state_eps_end[0]) > int(h.state_offset[0])

        def d(s: int) -> int:
            if memo[s] >= 0:
                return int(memo[s])
            if on_stack[s]:
                raise ValueError("ε-cycle in CLG composite")
            on_stack[s] = True
            best = 0
            lo, hi = clg.arc_range(s)
            ee = int(clg.state_eps_end[s])
            for i in range(lo, ee):
                best = max(best, 1 + d(int(clg.arc_dst[i])))
            for i in range(ee, hi):
                tail = 1 + d(int(clg.arc_dst[i])) \
                    if hmm_state0_exit(i) else 0
                best = max(best, 1 + tail)
            on_stack[s] = False
            memo[s] = best
            return best

        depth = max((d(s) for s in range(S)), default=0)
        # mid-HMM exits start their own chains: exit + chase from clg dst
        for a in range(clg.num_arcs):
            if clg.arc_ilabel[a] == EPSILON:
                continue
            h = self.hmm_of_arc(a)
            has_exit = np.any(h.state_eps_end > h.state_offset[:-1])
            if has_exit:
                depth = max(depth, 1 + d(int(clg.arc_dst[a])))
        return depth
