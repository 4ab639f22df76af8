"""Parity tests: device beam search vs the host gold decoder.

This is the framework's analogue of the reference's decoder-vs-Kaldi parity
axis (SURVEY §4): same graph + same loglikes ⇒ same best path (exact, with
beams wide enough that pruning never differs)."""

import numpy as np
import pytest

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.decoder.gold import GoldDecoder
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.fst.fst import StdFst
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch


def random_decode_graph(rng, num_states=30, num_labels=8, max_deg=4,
                        eps_prob=0.25):
    """Random connected WFST shaped like a decode graph: emitting arcs with
    labels 1..num_labels, forward-only ε-arcs (acyclic ε-subgraph), random
    olabels (words), final weights on a few states."""
    src, dst, il, ol, w = [], [], [], [], []
    for s in range(num_states):
        # guarantee connectivity: arc to s+1
        targets = [min(s + 1, num_states - 1)] + list(
            rng.integers(0, num_states, rng.integers(0, max_deg)))
        for d in targets:
            if rng.random() < eps_prob and d > s:
                src.append(s)
                dst.append(int(d))
                il.append(0)
                ol.append(int(rng.integers(0, 5)))
                w.append(float(rng.random() * 2))
            else:
                src.append(s)
                dst.append(int(d))
                il.append(int(rng.integers(1, num_labels + 1)))
                ol.append(int(rng.integers(0, 5)))
                w.append(float(rng.random() * 2))
    finals = {num_states - 1: float(rng.random()),
              num_states // 2: float(rng.random())}
    return StdFst.from_final_weights(
        num_states, 0, np.array(src), np.array(il), np.array(ol),
        np.array(w), np.array(dst), finals)


def _setup(rng, num_labels=8, eps_mode="auto", **kw):
    fst = random_decode_graph(rng, num_labels=num_labels, **kw)
    dev = DeviceFst.build(fst, arc_lanes=8)
    ilabel2pdf = np.arange(num_labels + 1, dtype=np.int32)
    cfg = DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8,
                        max_active=64, min_active=0, lattice_beam=1e9,
                        eps_mode=eps_mode)
    return fst, dev, ilabel2pdf, cfg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("eps_mode", ["closure", "sweeps"])
def test_device_matches_gold_single(seed, eps_mode):
    rng = np.random.default_rng(seed)
    fst, dev, i2p, cfg = _setup(rng, eps_mode=eps_mode)
    T, V = 15, 9
    loglikes = rng.standard_normal((T, V)).astype(np.float32) * 3
    gold = GoldDecoder(fst, i2p, cfg).decode(loglikes)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None])
    res = search.traceback(state, init_log, logs, fst)[0]
    assert res["reached_final"] == gold.reached_final
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res["words"] == gold.words
        assert res["ilabels"] == gold.ilabels


@pytest.mark.parametrize("eps_mode", ["closure", "sweeps"])
def test_device_matches_gold_batched_varlen(eps_mode):
    rng = np.random.default_rng(42)
    fst, dev, i2p, cfg = _setup(rng, eps_mode=eps_mode)
    B, Tmax, V = 4, 20, 9
    lens = np.array([20, 13, 7, 17])
    loglikes = rng.standard_normal((B, Tmax, V)).astype(np.float32) * 3
    mask = np.arange(Tmax)[None, :] < lens[:, None]
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes, mask)
    results = search.traceback(state, init_log, logs, fst)
    for b in range(B):
        gold = GoldDecoder(fst, i2p, cfg).decode(loglikes[b, :lens[b]])
        assert results[b]["cost"] == pytest.approx(gold.cost, abs=1e-3), b
        if gold.reached_final:
            assert results[b]["words"] == gold.words, b


def test_degree_split_preserves_paths():
    """A state with out-degree ≫ arc_lanes must still decode exactly."""
    rng = np.random.default_rng(7)
    num_labels = 40
    # one hub state with 40 emitting arcs
    src = [0] * num_labels + [i + 1 for i in range(num_labels)]
    il = list(range(1, num_labels + 1)) + [1] * num_labels
    ol = list(range(1, num_labels + 1)) + [0] * num_labels
    w = list(rng.random(2 * num_labels).astype(float))
    dst = [i + 1 for i in range(num_labels)] + [num_labels + 1] * num_labels
    fst = StdFst.from_final_weights(
        num_labels + 2, 0, np.array(src), np.array(il), np.array(ol),
        np.array(w), np.array(dst), {num_labels + 1: 0.5})
    dev = DeviceFst.build(fst, arc_lanes=8)
    assert dev.max_em_degree <= 8 and dev.max_eps_degree <= 8
    assert dev.num_states > fst.num_states  # split happened
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    cfg = DecoderConfig(beam=1e9, beam_width=128, arc_lanes=8,
                        max_active=128, min_active=0)
    T = 2
    loglikes = rng.standard_normal((T, num_labels + 1)).astype(np.float32)
    gold = GoldDecoder(fst, i2p, cfg).decode(loglikes)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None])
    res = search.traceback(state, init_log, logs, fst)[0]
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-4)
    assert res["words"] == gold.words


def test_narrow_beam_still_decodes():
    """With a tight beam the device must return a valid (possibly different)
    path — sanity that pruning keeps the machinery alive."""
    rng = np.random.default_rng(3)
    fst, dev, i2p, _ = _setup(rng)
    cfg = DecoderConfig(beam=4.0, beam_width=16, arc_lanes=8,
                        max_active=16, min_active=2)
    T, V = 12, 9
    loglikes = rng.standard_normal((T, V)).astype(np.float32)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None])
    res = search.traceback(state, init_log, logs, fst)[0]
    assert np.isfinite(res["cost"])


@pytest.mark.parametrize("seed", [0, 5])
def test_device_lattice_matches_gold(seed):
    """With wide beams the device token sets equal gold's, and both run the
    same host lattice builder ⇒ byte-identical lattices."""
    rng = np.random.default_rng(seed)
    fst, dev, i2p, cfg = _setup(rng)
    cfg.lattice_beam = 8.0
    T, V = 12, 9
    loglikes = rng.standard_normal((T, V)).astype(np.float32) * 3
    gold = GoldDecoder(fst, i2p, cfg).decode(loglikes, want_lattice=True)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None])
    lat = search.get_lattices(init_log, logs, loglikes[None], fst)[0]
    assert lat is not None and gold.lattice is not None
    assert sorted(lat.to_text().splitlines()) == \
        sorted(gold.lattice.to_text().splitlines())
    words, ilabs, lm, am = lat.to_vector()
    assert words == gold.words


def test_device_lattice_batched_with_split_states():
    """Lattices survive degree-splitting (orig_state fold) and padding."""
    rng = np.random.default_rng(9)
    fst, dev, i2p, cfg = _setup(rng, max_deg=12)  # force splits w/ lanes=8
    cfg.lattice_beam = 6.0
    B, Tmax, V = 3, 14, 9
    lens = np.array([14, 9, 5])
    loglikes = rng.standard_normal((B, Tmax, V)).astype(np.float32) * 2
    mask = np.arange(Tmax)[None, :] < lens[:, None]
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes, mask)
    lats = search.get_lattices(init_log, logs, loglikes, fst, mask)
    for b in range(B):
        gold = GoldDecoder(fst, i2p, cfg).decode(
            loglikes[b, :lens[b]], want_lattice=True)
        assert lats[b] is not None
        assert sorted(lats[b].to_text().splitlines()) == \
            sorted(gold.lattice.to_text().splitlines()), b


def test_gold_lattice_contains_best_path():
    rng = np.random.default_rng(11)
    fst, dev, i2p, cfg = _setup(rng)
    T, V = 10, 9
    loglikes = rng.standard_normal((T, V)).astype(np.float32) * 2
    gold = GoldDecoder(fst, i2p, cfg).decode(loglikes, want_lattice=True)
    assert gold.lattice is not None
    assert gold.lattice.check_format()
    words, ilabs, lm, am = gold.lattice.to_vector()
    assert words == gold.words
    if gold.reached_final:
        assert lm + am == pytest.approx(gold.cost, abs=1e-3)


def test_blank_skip_mask_equals_frame_removal():
    """CTC blank-skip semantics (ref SkipBlockFrame, nnet-nnet.h:265-275):
    masking a frame out of the search (tokens carry unchanged) must equal
    deleting that frame from the input sequence."""
    from asr_decoder_tpu.models.nnet import blank_frame_mask
    rng = np.random.default_rng(11)
    fst, dev, i2p, cfg = _setup(rng, eps_mode="closure")
    T, V = 18, 9
    loglikes = rng.standard_normal((T, V)).astype(np.float32) * 3
    # saturate the blank row (pdf 0) on some frames, as the posterior
    # pipeline does (log ~70 > BLANK_SKIP_LOGPROB)
    blank_frames = np.array([2, 3, 7, 11, 12, 13])
    loglikes[blank_frames, 0] = 70.0
    mask = ~np.asarray(blank_frame_mask(loglikes[None], 0))
    assert mask.sum() == T - len(blank_frames)

    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None], mask)
    res_masked = search.traceback(state, init_log, logs, fst)[0]

    kept = loglikes[np.asarray(mask[0])]
    state2, init_log2, logs2 = search.decode(kept[None])
    res_removed = search.traceback(state2, init_log2, logs2, fst)[0]

    assert res_masked["cost"] == pytest.approx(res_removed["cost"], abs=1e-3)
    assert res_masked["words"] == res_removed["words"]
    assert res_masked["ilabels"] == res_removed["ilabels"]


def test_relax_topk_clo_grouping_robust_to_huge_costs():
    """The ε-first re-prune groups CLO_BIT destinations at the beam front
    regardless of cost magnitude (a cost-weighted grouping key silently
    broke at beam≈1e9: marked tokens fell outside the closure-fetch
    prefix)."""
    import jax.numpy as jnp
    from asr_decoder_tpu.ops.beamsearch import CLO_BIT, _relax_topk

    K = 8
    # candidates: distinct dsts, half carrying CLO_BIT, costs spanning 1e9
    dst = np.array([[1 | CLO_BIT, 2, 3 | CLO_BIT, 4, 5, 6 | CLO_BIT,
                     7, 8, 9, 10, 11 | CLO_BIT, 12]], np.int32)
    cost = np.array([[9.9e8, 1.0, 5.0e8, 2.0, 3.0, 7.0e8,
                      4.0, 5.0, 6.0, 7.0, 8.8e8, 9.0]], np.float32)
    for F in (1, 2):
        state, cost2, fi, alive, live = _relax_topk(
            jnp.asarray(dst), jnp.asarray(cost), K=K, beam=1e9,
            min_active=0, F=F, clo_first=True)
        state = np.asarray(state)[0]
        alive = np.asarray(alive)[0]
        bits = [(int(s) >> 30) & 1 if s >= 0 else -1 for s in state]
        nbit = sum(b == 1 for b in bits)
        # every live marked token sits before every live unmarked token
        first_unmarked = bits.index(0)
        assert all(b == 1 for b in bits[:first_unmarked][:nbit])
        assert all(b != 1 for b in bits[first_unmarked:] if b >= 0), bits
        if F == 1:
            # nothing selected away: all 8 best-by-cost distinct states
            assert int(np.asarray(live)[0]) == K
        # selection is by cost: the K cheapest distinct dsts survive
        want = set(np.sort(cost[0])[:K].tolist())
        got = set(np.asarray(cost2)[0][alive].tolist())
        assert got == want


def test_relax_topk_min_active_counts_distinct_states():
    """min_active keeps the best min_active DISTINCT destinations, as the
    v2 relax and the gold decoder do (ref GetCutoff); counting duplicate
    candidates instead let one state's duplicates use up min_active.
    (K·F = 8 covers every candidate, so no duplicate crowding.)"""
    import jax.numpy as jnp
    from asr_decoder_tpu.ops.beamsearch import _relax_and_prune, _relax_topk

    dst = np.array([[1, 1, 1, 2, 3, 4, 1, 2]], np.int32)
    cost = np.array([[0.0, 0.1, 0.2, 5.0, 6.0, 7.0, 0.3, 5.5]], np.float32)
    kw = dict(K=4, beam=0.5, min_active=3)
    st3, c3, _, alive3, live3 = _relax_topk(
        jnp.asarray(dst), jnp.asarray(cost), F=2, **kw)
    st2, c2, _, keep2 = _relax_and_prune(
        jnp.asarray(dst), jnp.asarray(cost), **kw)
    got = sorted(zip(np.asarray(st3)[0][np.asarray(alive3)[0]].tolist(),
                     np.asarray(c3)[0][np.asarray(alive3)[0]].tolist()))
    want = sorted(zip(np.asarray(st2)[0][np.asarray(keep2)[0]].tolist(),
                      np.asarray(c2)[0][np.asarray(keep2)[0]].tolist()))
    assert got == want == [(1, 0.0), (2, 5.0), (3, 6.0)]
    assert int(np.asarray(live3)[0]) == 3
