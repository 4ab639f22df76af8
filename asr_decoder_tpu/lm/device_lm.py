"""Device-resident ARPA n-gram LM for in-search (BigLM) rescoring.

Device-side re-design of the reference's per-arc LM queries inside
``ProcessEmitting`` (ref: src/my-decoder/online-decoder-mempool-base-biglm.h:
316-402 calling ``DiffArpaLm::GetArc`` → ``Fsa::GetArc`` backoff chasing,
src/newlm/arpa2fsa.cc:244-262).  The reference binary-searches a per-state
sorted arc list and chases backoffs in a data-dependent while loop — neither
shape works on the device.  Here the same automaton becomes three dense tables:

  * an open-addressing hash over all non-root arcs: row table
    ``i32[H, 4] = (key_state | key_word | dst | weight-bits)``, linear
    probing, probe count bounded by the longest cluster at build time;
  * a dense unigram row ``(uni_dst, uni_w)[Vmax+1]`` — the root state's arc
    list is vocabulary-sized, so its "binary search" is a direct index;
  * backoff arrays ``(backoff_dst, backoff_w)[S]``.

``get_arc_batch`` then evaluates any ``[B, N]`` batch of (state, word)
queries in a *static* number of gathers: ``levels`` backoff iterations
(= the FSA's longest backoff chain, e.g. 3 for a 4-gram LM), each one hash
row-probe plus one unigram/backoff lookup — exact semantics parity with the
host ``Fsa.get_arc`` (lm/arpa.py), including the +100 stay-at-root penalty
for unseen words.

All keys/ids are i32 (JAX x64 stays off); weights ride as bit-cast i32 in
the hash rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.lm.arpa import Fsa

UNSEEN_PENALTY = 100.0   # host Fsa.get_arc parity (lm/arpa.py)

# Knuth multiplicative hashing constants (i32 wraparound is intended).
_H1 = np.int32(-1640531527)      # 2654435761 as signed i32
_H2 = np.int32(40503)


def _hash2(s, w, mask):
    h = (s * _H1) ^ (w * _H2)
    h = h ^ (h >> 15)
    return (h * _H1 >> 8) & mask


@dataclass
class DeviceNgramLm:
    """Device tables for one ARPA Fsa + the static probe/level bounds."""

    table: jax.Array        # i32[H, 4]: key_state | key_word | dst | w_bits
    uni: jax.Array          # i32[Vmax+1, 2]: dst | w_bits (root arcs, dense)
    backoff: jax.Array      # i32[S, 2]: dst | w_bits
    start: int
    root: int               # the unigram (empty-context) state
    levels: int             # backoff chase iterations (max chain length + 1)
    max_probes: int         # longest linear-probe cluster
    mask: int               # hash size - 1
    fsa: Fsa                # host copy (final costs, tests)

    @staticmethod
    def build(fsa: Fsa) -> "DeviceNgramLm":
        S = fsa.num_states
        root = fsa.unigram
        counts = np.diff(fsa.offset)

        # --- dense unigram row ------------------------------------------
        lo, hi = int(fsa.offset[root]), int(fsa.offset[root + 1])
        vmax = int(fsa.arc_word.max()) if fsa.num_arcs else 0
        uni = np.empty((vmax + 2, 2), np.int32)
        uni[:, 0] = root
        uni[:, 1] = np.float32(UNSEEN_PENALTY).view(np.int32)
        uw = fsa.arc_word[lo:hi]
        uni[uw, 0] = fsa.arc_dst[lo:hi]
        uni[uw, 1] = fsa.arc_weight[lo:hi].view(np.int32)

        # --- hash over all non-root arcs ---------------------------------
        nr_states = np.repeat(np.arange(S, dtype=np.int32),
                              counts.astype(np.int64))
        keep = nr_states != root
        ks = nr_states[keep]
        kw = fsa.arc_word[keep].astype(np.int32)
        kd = fsa.arc_dst[keep].astype(np.int32)
        kv = fsa.arc_weight[keep].view(np.int32)
        n = len(ks)
        H = 1 << max(int(np.ceil(np.log2(max(2 * n, 16)))), 4)
        mask = H - 1
        table = np.full((H, 4), -1, np.int32)
        with np.errstate(over="ignore"):
            h = _hash2(ks, kw, np.int32(mask)).astype(np.int64)
        # vectorized linear-probe insertion: place non-colliding entries in
        # rounds; each round resolves first-comers, losers step +1
        pend = np.arange(n)
        max_probes = 1
        probes = 0
        while len(pend):
            probes += 1
            hp = h[pend]
            # winner per slot this round = first pending entry with that h
            order = np.argsort(hp, kind="stable")
            hp_s = hp[order]
            first = np.ones(len(order), bool)
            first[1:] = hp_s[1:] != hp_s[:-1]
            cand = pend[order[first]]
            slot_free = table[h[cand], 0] == -1
            placed = cand[slot_free]
            table[h[placed], 0] = ks[placed]
            table[h[placed], 1] = kw[placed]
            table[h[placed], 2] = kd[placed]
            table[h[placed], 3] = kv[placed]
            placed_set = np.zeros(n, bool)
            placed_set[placed] = True
            pend = pend[~placed_set[pend]]
            h[pend] = (h[pend] + 1) & mask
        # an entry placed in round r is found in r lookup probes
        max_probes = probes

        # --- backoff arrays ----------------------------------------------
        backoff = np.empty((S, 2), np.int32)
        backoff[:, 0] = fsa.backoff_dst
        backoff[:, 1] = fsa.backoff_w.view(np.int32)

        # levels = longest backoff chain + 1 (root gets resolved in-level)
        depth = np.zeros(S, np.int64)
        bd = fsa.backoff_dst.astype(np.int64)
        cur = bd.copy()
        lvl = 1
        while True:
            live = cur >= 0
            if not live.any():
                break
            depth[live] = lvl
            cur[live] = bd[cur[live]]
            lvl += 1
            if lvl > S + 2:
                raise ValueError("backoff cycle in Fsa")
        levels = int(depth.max()) + 1

        return DeviceNgramLm(
            table=jnp.asarray(table), uni=jnp.asarray(uni),
            backoff=jnp.asarray(backoff), start=int(fsa.start),
            root=int(root), levels=levels, max_probes=int(max_probes),
            mask=mask, fsa=fsa)

    def final_host(self, s: int) -> float:
        return self.fsa.final(s)


def _bits_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def lm_get_arc_tables(table, uni, backoff, s, w, *, mask: int, levels: int,
                      max_probes: int):
    """Vectorized ``Fsa.get_arc`` over raw device tables (jit-composable:
    tables are traced operands, bounds are static).  (next_state i32[...],
    cost f32[...]) for emitting word ``w`` from context state ``s``;
    ``w <= 0`` (ε / backoff label) keeps the state at zero cost — matching
    ``NextLmState``'s olabel==0 short-circuit
    (ref online-decoder-mempool-base-biglm.h:55-62).
    """
    orig_shape = s.shape
    s = s.reshape(-1)
    w = w.reshape(-1)
    mask = jnp.int32(mask)
    vcap = uni.shape[0] - 1

    cost = jnp.zeros(s.shape, jnp.float32)
    done = w <= 0
    dst = s
    wq = jnp.clip(w, 0, vcap)

    for _ in range(levels):
        at_root = backoff[s, 0] < 0
        # root: direct unigram lookup (covers the unseen +100 stay case)
        urow = uni[wq]                          # [Q,2]
        root_hit = at_root & ~done
        dst = jnp.where(root_hit, urow[:, 0], dst)
        cost = cost + jnp.where(root_hit, _bits_f32(urow[:, 1]), 0.0)
        done = done | root_hit
        # non-root: bounded linear hash probe
        h = _hash2(s, w, mask)
        found = jnp.zeros(s.shape, bool)
        hdst = jnp.zeros(s.shape, jnp.int32)
        hw = jnp.zeros(s.shape, jnp.float32)
        for _p in range(max_probes):
            row = table[h]                      # [Q,4]
            m = (row[:, 0] == s) & (row[:, 1] == w) & ~found
            hdst = jnp.where(m, row[:, 2], hdst)
            hw = jnp.where(m, _bits_f32(row[:, 3]), hw)
            found = found | m
            h = (h + 1) & mask
        ok = found & ~done
        dst = jnp.where(ok, hdst, dst)
        cost = cost + jnp.where(ok, hw, 0.0)
        done = done | ok
        # miss: chase backoff
        miss = ~done
        brow = backoff[s]
        cost = cost + jnp.where(miss, _bits_f32(brow[:, 1]), 0.0)
        s = jnp.where(miss, brow[:, 0], s)
    return dst.reshape(orig_shape), cost.reshape(orig_shape)


def lm_get_arc(lm: DeviceNgramLm, s, w):
    """``lm_get_arc_tables`` with the bounds taken from a DeviceNgramLm."""
    return lm_get_arc_tables(lm.table, lm.uni, lm.backoff, s, w,
                             mask=lm.mask, levels=lm.levels,
                             max_probes=lm.max_probes)


@dataclass
class DeviceDiffLm:
    """Difference LM (lm2·G₂ − lm1·G₁) over two device n-gram LMs — the
    in-search analogue of ``DiffArpaLm`` (ref: src/newlm/diff-lm.h:13-122).
    Instead of interning pair states in a host hash, the search carries both
    component states as beam lanes and merges on the (fst, lm1, lm2) key."""

    lm1: DeviceNgramLm
    lm2: DeviceNgramLm
    lm1_scale: float = 1.0
    lm2_scale: float = 1.0

    @staticmethod
    def build(fsa1: Fsa, fsa2: Fsa, lm1_scale: float = 1.0,
              lm2_scale: float = 1.0) -> "DeviceDiffLm":
        return DeviceDiffLm(DeviceNgramLm.build(fsa1),
                            DeviceNgramLm.build(fsa2),
                            lm1_scale, lm2_scale)

    @property
    def start(self) -> tuple[int, int]:
        return self.lm1.start, self.lm2.start

    def advance(self, s1, s2, w):
        """(next1, next2, cost) for word batch ``w`` (≤0 ⇒ no-op)."""
        n1, c1 = lm_get_arc(self.lm1, s1, w)
        n2, c2 = lm_get_arc(self.lm2, s2, w)
        return n1, n2, self.lm2_scale * c2 - self.lm1_scale * c1

    def final_host(self, s1: int, s2: int) -> float:
        """Sentence-final cost (ref ComputeFinalCosts adding
        ``_diff_lm.Final``, online-decoder-mempool-base-biglm.h:161-216)."""
        return (self.lm2_scale * self.lm2.final_host(s2)
                - self.lm1_scale * self.lm1.final_host(s1))
