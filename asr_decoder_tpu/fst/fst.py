"""Immutable WFST decode graph as structure-of-arrays CSR.

Device-first re-design of the reference's static decode graph
(ref: src/newfst/optimize-fst.h:53-307).  Where the reference stores a
pointer-linked ``State{arcs*,num_arcs}`` array, we store flat numpy arrays —
``arc_ilabel/arc_olabel/arc_weight/arc_dst`` plus ``state_offset`` — that can
be uploaded to device HBM unchanged and gathered from inside jitted search.

Conventions carried over from the reference (they simplify search):
  * single super-final state: ``IsFinal(s) == (s == final_state)`` and final
    weights are rewritten as ε-arcs to it (ref: optimize-fst.h:104-119);
  * ε input label is 0; per-state arcs are sorted ε-first so the emitting /
    non-emitting split is a per-state offset (the reference instead counts
    ``_niepsilons``, ref: optimize-fst.h:20).

File formats supported:
  * the reference's custom binary format — 6×int32 header
    (start, final, nstates, narcs, niepsilons, noepsilons) then
    ``StateInfo{num_arcs,niepsilons,noepsilons}[nstates]`` (3×uint32) then
    ``Arc{ilabel,olabel,weight,dst}[narcs]`` (i32,i32,f32,i32)
    (ref: optimize-fst.h:226-280 ReadFst);
  * OpenFST ConstFst binary (``HCLG.fst``) (ref: src/newfst/const-fst.h:118);
  * OpenFST text format (for tests and tools).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

EPSILON = 0
NO_STATE = -1

_ARC_DT = np.dtype([("ilabel", "<i4"), ("olabel", "<i4"),
                    ("weight", "<f4"), ("dst", "<i4")])
_STATEINFO_DT = np.dtype([("num_arcs", "<u4"), ("niepsilons", "<u4"),
                          ("noepsilons", "<u4")])

# OpenFST binary header constants (ref: src/newfst/const-fst.h:22-118)
_OPENFST_MAGIC = 2125659606
_CONST_FST_STATE_DT = np.dtype([("final", "<f4"), ("pos", "<u4"),
                                ("narcs", "<u4"), ("niepsilons", "<u4"),
                                ("noepsilons", "<u4")])
_CONST_FST_ARC_DT = np.dtype([("ilabel", "<i4"), ("olabel", "<i4"),
                              ("weight", "<f4"), ("dst", "<i4")])


@dataclass
class StdFst:
    """Immutable tropical-weight WFST in CSR form.

    ``state_offset`` has ``num_states+1`` entries; state ``s`` owns arcs
    ``state_offset[s]:state_offset[s+1]``, ε-arcs (ilabel==0) first.
    ``state_eps_end[s]`` is the end of the ε segment.
    """

    start: int
    final_state: int
    state_offset: np.ndarray        # i64[num_states+1]
    state_eps_end: np.ndarray       # i64[num_states] (>= state_offset[s])
    arc_ilabel: np.ndarray          # i32[num_arcs]
    arc_olabel: np.ndarray          # i32[num_arcs]
    arc_weight: np.ndarray          # f32[num_arcs]
    arc_dst: np.ndarray             # i32[num_arcs]
    # where olabels sit relative to a word's acoustic span: "start"
    # (composed HCLG, labels pushed early) or "end" (label-pushed-late
    # graphs like the shared-prefix CTC trie) — consumed by word alignment
    # (align/word_align.py)
    olabel_anchor: str = "start"

    @property
    def num_states(self) -> int:
        return len(self.state_offset) - 1

    @property
    def num_arcs(self) -> int:
        return len(self.arc_ilabel)

    def is_final(self, s: int) -> bool:
        return s == self.final_state

    def num_input_epsilons(self, s: int) -> int:
        return int(self.state_eps_end[s] - self.state_offset[s])

    def arcs(self, s: int):
        """Iterate (ilabel, olabel, weight, dst) tuples of state ``s``."""
        lo, hi = int(self.state_offset[s]), int(self.state_offset[s + 1])
        for i in range(lo, hi):
            yield (int(self.arc_ilabel[i]), int(self.arc_olabel[i]),
                   float(self.arc_weight[i]), int(self.arc_dst[i]))

    def arc_range(self, s: int) -> tuple[int, int]:
        return int(self.state_offset[s]), int(self.state_offset[s + 1])

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_arcs(num_states: int, start: int, final_state: int,
                  src: np.ndarray, ilabel: np.ndarray, olabel: np.ndarray,
                  weight: np.ndarray, dst: np.ndarray) -> "StdFst":
        """Build CSR from parallel arc arrays, sorting per-state ε-first."""
        src = np.asarray(src, np.int64)
        ilabel = np.asarray(ilabel, np.int32)
        olabel = np.asarray(olabel, np.int32)
        weight = np.asarray(weight, np.float32)
        dst = np.asarray(dst, np.int32)
        # stable sort by (src, is_emitting) puts ε-arcs first per state
        order = np.lexsort((ilabel != EPSILON, src))
        src, ilabel, olabel, weight, dst = (
            a[order] for a in (src, ilabel, olabel, weight, dst))
        counts = np.bincount(src, minlength=num_states)
        offset = np.zeros(num_states + 1, np.int64)
        np.cumsum(counts, out=offset[1:])
        eps_counts = np.bincount(src[ilabel == EPSILON], minlength=num_states)
        eps_end = offset[:-1] + eps_counts
        return StdFst(start=start, final_state=final_state,
                      state_offset=offset, state_eps_end=eps_end,
                      arc_ilabel=ilabel, arc_olabel=olabel,
                      arc_weight=weight, arc_dst=dst)

    @staticmethod
    def from_final_weights(num_states: int, start: int,
                           src, ilabel, olabel, weight, dst,
                           final_weights: dict[int, float]) -> "StdFst":
        """Build from arcs + per-state final weights, applying the reference's
        super-final rewrite: add one state; each final state gets an ε-arc to
        it carrying the final weight (ref: optimize-fst.h:104-119)."""
        superfinal = num_states
        src = list(src)
        ilabel = list(ilabel)
        olabel = list(olabel)
        weight = list(weight)
        dst = list(dst)
        for s, w in sorted(final_weights.items()):
            src.append(s)
            ilabel.append(EPSILON)
            olabel.append(EPSILON)
            weight.append(w)
            dst.append(superfinal)
        return StdFst.from_arcs(
            num_states + 1, start, superfinal,
            np.array(src, np.int64), np.array(ilabel, np.int32),
            np.array(olabel, np.int32), np.array(weight, np.float32),
            np.array(dst, np.int32))

    # ------------------------------------------------------------------
    # reference custom binary format
    # ------------------------------------------------------------------
    @staticmethod
    def read_binary(path: str) -> "StdFst":
        """Read the reference's custom fst format (ref: optimize-fst.h:226-280)."""
        with open(path, "rb") as f:
            hdr = f.read(24)
            if len(hdr) != 24:
                raise IOError(f"{path}: truncated fst header")
            start, final, nstates, narcs, nieps, noeps = struct.unpack("<6i", hdr)
            infos = np.fromfile(f, _STATEINFO_DT, nstates)
            arcs = np.fromfile(f, _ARC_DT, narcs)
        if len(infos) != nstates or len(arcs) != narcs:
            raise IOError(f"{path}: truncated fst body")
        counts = infos["num_arcs"].astype(np.int64)
        src = np.repeat(np.arange(nstates, dtype=np.int64), counts)
        return StdFst.from_arcs(nstates, start, final, src,
                                arcs["ilabel"], arcs["olabel"],
                                arcs["weight"], arcs["dst"])

    def write_binary(self, path: str) -> None:
        nstates, narcs = self.num_states, self.num_arcs
        counts = np.diff(self.state_offset).astype(np.uint32)
        infos = np.zeros(nstates, _STATEINFO_DT)
        infos["num_arcs"] = counts
        infos["niepsilons"] = (self.state_eps_end -
                               self.state_offset[:-1]).astype(np.uint32)
        oeps = np.bincount(
            np.repeat(np.arange(nstates), np.diff(self.state_offset)),
            weights=(self.arc_olabel == EPSILON), minlength=nstates)
        infos["noepsilons"] = oeps.astype(np.uint32)
        arcs = np.zeros(narcs, _ARC_DT)
        arcs["ilabel"] = self.arc_ilabel
        arcs["olabel"] = self.arc_olabel
        arcs["weight"] = self.arc_weight
        arcs["dst"] = self.arc_dst
        with open(path, "wb") as f:
            f.write(struct.pack("<6i", self.start, self.final_state, nstates,
                                narcs, int(np.sum(self.arc_ilabel == EPSILON)),
                                int(np.sum(self.arc_olabel == EPSILON))))
            infos.tofile(f)
            arcs.tofile(f)

    # ------------------------------------------------------------------
    # OpenFST formats
    # ------------------------------------------------------------------
    @staticmethod
    def read_openfst_const(path: str) -> "StdFst":
        """Read an OpenFST ConstFst binary (standard Kaldi ``HCLG.fst``)
        and apply the super-final rewrite (ref: src/newfst/const-fst.h:118,
        const-fst-read.cc; super-final rewrite optimize-fst.h:82-134)."""
        with open(path, "rb") as f:
            magic, = struct.unpack("<i", f.read(4))
            if magic != _OPENFST_MAGIC:
                raise IOError(f"{path}: not an OpenFST binary (magic={magic})")

            def read_string() -> str:
                n, = struct.unpack("<i", f.read(4))
                return f.read(n).decode()

            fsttype = read_string()
            arctype = read_string()
            if fsttype not in ("const", "vector"):
                raise IOError(f"{path}: unsupported fst type {fsttype!r}")
            if arctype != "standard":
                raise IOError(f"{path}: unsupported arc type {arctype!r}")
            version, flags, properties, start, numstates, numarcs = \
                struct.unpack("<iiqqqq", f.read(40))
            if fsttype == "vector":
                return StdFst._read_openfst_vector_body(f, start)
            # ConstFst data: packed ConstState[] then Arc[] immediately after
            # the header (the reference reads it unaligned too,
            # ref: const-fst.h:200-221)
            infos = np.fromfile(f, _CONST_FST_STATE_DT, numstates)
            arcs = np.fromfile(f, _CONST_FST_ARC_DT, numarcs)
        if len(infos) != numstates or len(arcs) != numarcs:
            raise IOError(f"{path}: truncated ConstFst body")
        counts = infos["narcs"].astype(np.int64)
        src = np.repeat(np.arange(numstates, dtype=np.int64), counts)
        finals = {i: float(w) for i, w in enumerate(infos["final"])
                  if w != np.float32(np.inf)}
        return StdFst.from_final_weights(
            numstates, start, src, arcs["ilabel"], arcs["olabel"],
            arcs["weight"], arcs["dst"], finals)

    @staticmethod
    def _read_openfst_vector_body(f, start: int) -> "StdFst":
        """VectorFst body: per state: final(f32), narcs(i64), then arcs."""
        src, il, ol, w, ds = [], [], [], [], []
        finals: dict[int, float] = {}
        s = 0
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            final, narcs = struct.unpack("<fq", head)
            if final != np.float32(np.inf):
                finals[s] = final
            if narcs:
                a = np.fromfile(f, _CONST_FST_ARC_DT, narcs)
                src.extend([s] * narcs)
                il.append(a["ilabel"])
                ol.append(a["olabel"])
                w.append(a["weight"])
                ds.append(a["dst"])
            s += 1
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        return StdFst.from_final_weights(
            s, start, np.array(src, np.int64),
            cat(il, np.int32), cat(ol, np.int32),
            cat(w, np.float32), cat(ds, np.int32), finals)

    # ------------------------------------------------------------------
    # text format (OpenFST att-style, for tests/tools)
    # ------------------------------------------------------------------
    @staticmethod
    def from_text(text: str, start: int | None = None) -> "StdFst":
        """Parse OpenFST text: ``src dst ilabel olabel [weight]`` arcs and
        ``state [weight]`` final lines; start = first mentioned state."""
        src, dst, il, ol, w = [], [], [], [], []
        finals: dict[int, float] = {}
        max_state = -1
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) <= 2:
                s = int(parts[0])
                finals[s] = float(parts[1]) if len(parts) == 2 else 0.0
                max_state = max(max_state, s)
            else:
                s, d = int(parts[0]), int(parts[1])
                src.append(s)
                dst.append(d)
                il.append(int(parts[2]))
                ol.append(int(parts[3]))
                w.append(float(parts[4]) if len(parts) > 4 else 0.0)
                if start is None:
                    start = s
                max_state = max(max_state, s, d)
        return StdFst.from_final_weights(
            max_state + 1, start if start is not None else 0,
            np.array(src, np.int64), np.array(il, np.int32),
            np.array(ol, np.int32), np.array(w, np.float32),
            np.array(dst, np.int32), finals)

    def to_text(self) -> str:
        out = []
        for s in range(self.num_states):
            for il, ol, w, d in self.arcs(s):
                out.append(f"{s}\t{d}\t{il}\t{ol}\t{w:g}")
        out.append(f"{self.final_state}")
        return "\n".join(out)

    # ------------------------------------------------------------------
    def remove_olabels(self) -> None:
        """ref: Fst::RmOlalel [sic] — strip output labels (HMM sub-fsts)."""
        self.arc_olabel = np.zeros_like(self.arc_olabel)

    def max_out_degree(self) -> int:
        return int(np.max(np.diff(self.state_offset))) if self.num_states else 0

    def epsilon_depth(self, max_iters: int = 64) -> int:
        """Longest ε-chain length (number of relaxation sweeps needed for
        ε-closure).  The reference handles ε-chains with a worklist
        (ref: src/my-decoder/online-decoder-base-inl.h:354-437); the device
        search instead runs this many bounded sweeps.  Raises if the
        ε-subgraph has a cycle reachable in ``max_iters`` iterations."""
        eps_mask = self.arc_ilabel == EPSILON
        if not np.any(eps_mask):
            return 0
        src_all = np.repeat(np.arange(self.num_states, dtype=np.int64),
                            np.diff(self.state_offset))
        esrc = src_all[eps_mask]
        edst = self.arc_dst[eps_mask].astype(np.int64)
        # longest path over the ε-DAG by iterated relaxation
        depth = np.zeros(self.num_states, np.int64)
        for it in range(max_iters):
            nd = depth.copy()
            np.maximum.at(nd, edst, depth[esrc] + 1)
            if np.array_equal(nd, depth):
                return int(depth.max())
            depth = nd
        raise ValueError("epsilon cycle detected or depth > max_iters")
