"""Lattice determinization — one best alignment per word sequence.

Capability parity with the reference's Kaldi-style lattice determinizer
(ref: src/newfst/lattice-determinize.h:35-551, wrapper
lattice-determinize-api.cc:5): the input lattice (ilabel = transition-id,
olabel = word-id) becomes deterministic on *word sequences*, keeping only the
lowest-cost ilabel alignment for each distinct word sequence; alignment
strings are re-expanded as linear ε-olabel chains on the output (the
reference's string-repository + MakeArc expansion).

Host-side post-search pass (off the device hot path), pure Python over the
acyclic ``Lattice`` — subsets are exact, no approximation.  Raises
``DeterminizeError`` if the output would exceed ``max_states`` (the
reference wrapper's guard).
"""

from __future__ import annotations

import heapq

from asr_decoder_tpu.fst.lattice import EPSILON, Lattice, LatticeArc
from asr_decoder_tpu.fst.semiring import LatticeWeight

# a pair weight inside a subset: ((graph, am), tid-string)
_W = tuple[float, float]


class DeterminizeError(RuntimeError):
    pass


def _wplus(a: _W, b: _W) -> _W:
    """Tropical Plus on (graph, am): min by total, tie to larger graph part
    (matches LatticeWeightTpl::Plus tie-break, ref newfst/weigth.h:247)."""
    ta, tb = a[0] + a[1], b[0] + b[1]
    if ta != tb:
        return a if ta < tb else b
    return a if a[0] >= b[0] else b


def _wtimes(a: _W, b: _W) -> _W:
    return (a[0] + b[0], a[1] + b[1])


def _better(aw: _W, astr: tuple, bw: _W, bstr: tuple) -> bool:
    """Is (aw, astr) the preferred pair? Weight first, then shorter/lex
    string (a deterministic tie-break; the reference compares strings via
    its repository order, lattice-determinize.h:168-200)."""
    ta, tb = aw[0] + aw[1], bw[0] + bw[1]
    if ta != tb:
        return ta < tb
    if aw[0] != bw[0]:
        return aw[0] > bw[0]
    return astr < bstr


def _topo_order(lat: Lattice) -> list[int]:
    order = lat.topsort_order()
    if order is None:
        raise DeterminizeError("input lattice is cyclic")
    return order


def determinize_lattice(lat: Lattice, max_states: int = 500_000,
                        max_work: int | None = None) -> Lattice:
    """Determinize on word (olabel) sequences.  Input must be acyclic.

    ``max_work`` bounds total relaxation steps — degenerate lattices (huge
    per-word ilabel-string subsets) raise ``DeterminizeError`` instead of
    running away, the role of Kaldi's determinize max-mem/max-loop guard
    (callers fall back to the raw lattice, see session.get_lattice).
    None = adaptive: generous for small lattices, bounded-blowup for big
    ones, so a doomed determinization aborts in ~seconds instead of
    burning a fixed multi-million-step budget before the fallback.
    """
    if lat.start < 0 or lat.num_states == 0:
        return Lattice()
    if max_work is None:
        max_work = min(4_000_000, max(500_000, 40 * lat.num_arcs))
    topo = _topo_order(lat)
    topo_pos = {s: i for i, s in enumerate(topo)}
    work = [0]

    def closure(pairs: dict[int, tuple[_W, tuple]]):
        """Follow olabel-ε arcs, accumulating weight and ilabel string.
        Exact over the DAG: relax states in topological order (lazy heap;
        ε arcs only go forward in topo order, so every state pops with its
        final value — duplicate pops are idempotent)."""
        import heapq
        heap = [(topo_pos[s], s) for s in pairs]
        heapq.heapify(heap)
        while heap:
            work[0] += 1
            if work[0] > max_work:
                raise DeterminizeError(
                    f"determinization exceeded {max_work} steps")
            _, s = heapq.heappop(heap)
            w, st = pairs[s]
            for a in lat.arcs(s):
                if a.olabel != EPSILON:
                    continue
                nw = _wtimes(w, (a.weight.value1, a.weight.value2))
                ns = st + ((a.ilabel,) if a.ilabel != EPSILON else ())
                if a.dst not in pairs or _better(nw, ns, *pairs[a.dst]):
                    pairs[a.dst] = (nw, ns)
                    heapq.heappush(heap, (topo_pos[a.dst], a.dst))
        return pairs

    def normalize(pairs: dict[int, tuple[_W, tuple]]):
        """Extract (common weight, common string prefix); return
        (frozen normalized subset, common_w, common_str)."""
        best_w = None
        for w, st in pairs.values():
            best_w = w if best_w is None else _wplus(best_w, w)
        strs = [st for _, st in pairs.values()]
        common = strs[0]
        for st in strs[1:]:
            n = 0
            for x, y in zip(common, st):
                if x != y:
                    break
                n += 1
            common = common[:n]
            if not common:
                break
        norm = frozenset(
            (s, (w[0] - best_w[0], w[1] - best_w[1]), st[len(common):])
            for s, (w, st) in pairs.items())
        return norm, best_w, common

    out = Lattice()

    def emit_chain(src: int, first_il: tuple, olabel: int,
                   w: LatticeWeight) -> int:
        """Append a linear chain of states for an ilabel string; the first
        arc carries the olabel and weight (ref MakeArc expansion,
        lattice-determinize.h:300-360).  Returns the chain's last state."""
        cur = src
        if not first_il:
            nxt = out.add_state()
            out.add_arc(cur, LatticeArc(EPSILON, olabel, w, nxt))
            return nxt
        for k, il in enumerate(first_il):
            nxt = out.add_state()
            out.add_arc(cur, LatticeArc(
                il, olabel if k == 0 else EPSILON,
                w if k == 0 else LatticeWeight.one(), nxt))
            cur = nxt
        return cur

    # start subset
    start_pairs = closure({lat.start: ((0.0, 0.0), ())})
    norm0, w0, str0 = normalize(start_pairs)
    subsets: dict[frozenset, int] = {}
    queue: list[frozenset] = []

    def det_state(norm: frozenset) -> int:
        if norm not in subsets:
            subsets[norm] = out.add_state()
            queue.append(norm)
            if len(subsets) > max_states:
                raise DeterminizeError(
                    f"determinization exceeded {max_states} states")
        return subsets[norm]

    s0 = det_state(norm0)
    real_start = out.add_state()
    out.set_start(real_start)
    # entry chain for any common start weight/string
    tail = emit_chain(real_start, str0, EPSILON,
                      LatticeWeight(w0[0], w0[1])) \
        if (str0 or w0 != (0.0, 0.0)) else real_start
    if tail != real_start:
        out.add_arc(tail, LatticeArc(EPSILON, EPSILON,
                                     LatticeWeight.one(), s0))
    elif real_start != s0:
        out.add_arc(real_start, LatticeArc(EPSILON, EPSILON,
                                           LatticeWeight.one(), s0))

    qi = 0
    while qi < len(queue):
        norm = queue[qi]
        qi += 1
        src_id = subsets[norm]
        pairs = {s: (w, st) for s, w, st in norm}
        # finals: best (weight, string) over final member states
        fbest = None
        for s, (w, st) in pairs.items():
            fw = lat.final(s)
            if not fw.is_zero():
                cand = (_wtimes(w, (fw.value1, fw.value2)), st)
                if fbest is None or _better(cand[0], cand[1], *fbest):
                    fbest = cand
        if fbest is not None:
            fw, fstr = fbest
            if fstr:
                last = emit_chain(src_id, fstr, EPSILON,
                                  LatticeWeight(fw[0], fw[1]))
                out.set_final(last)
            else:
                out.set_final(src_id, LatticeWeight(fw[0], fw[1]))
        # transitions grouped by word
        trans: dict[int, dict[int, tuple[_W, tuple]]] = {}
        for s, (w, st) in pairs.items():
            for a in lat.arcs(s):
                if a.olabel == EPSILON:
                    continue
                nw = _wtimes(w, (a.weight.value1, a.weight.value2))
                ns = st + ((a.ilabel,) if a.ilabel != EPSILON else ())
                d = trans.setdefault(a.olabel, {})
                if a.dst not in d or _better(nw, ns, *d[a.dst]):
                    d[a.dst] = (nw, ns)
        for word in sorted(trans):
            npairs = closure(dict(trans[word]))
            nnorm, nw, nstr = normalize(npairs)
            dst_id = det_state(nnorm)
            last = emit_chain(src_id, nstr, word, LatticeWeight(nw[0], nw[1]))
            out.add_arc(last, LatticeArc(EPSILON, EPSILON,
                                         LatticeWeight.one(), dst_id))
    out.connect()
    return out
