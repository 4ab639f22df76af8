"""Cross-implementation parity: the device TpuBeamSearch vs the ACTUAL
reference C++ LatticeFasterDecoder (built Kaldi-free from /root/reference,
ref: src/my-decoder/lattice-faster-decoder.cc).

Same graph (via StdFst.write_binary, the reference's own on-disk format)
and same loglikes through both implementations must yield identical word
sequences and total costs — externally anchoring the repo's parity claims
(previously checked only against our own gold Python decoder)."""

import numpy as np
import pytest

from asr_decoder_tpu.decoder import ref_parity
from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

from test_beamsearch import random_decode_graph

pytestmark = pytest.mark.skipif(
    not ref_parity.available(),
    reason="reference tree or g++ not available")


@pytest.fixture(scope="session")
def ref_binary(tmp_path_factory):
    return ref_parity.build(str(tmp_path_factory.mktemp("refparity")))


def _decode_both(ref_binary, fst, loglikes, i2p, acoustic_scale=1.0,
                 eps_mode="auto"):
    cfg = DecoderConfig(beam=1e9, beam_width=256, arc_lanes=16,
                        max_active=256, min_active=0, lattice_beam=1e9,
                        acoustic_scale=acoustic_scale, eps_mode=eps_mode)
    dev = DeviceFst.build(fst, arc_lanes=cfg.arc_lanes)
    search = TpuBeamSearch(dev, i2p, cfg)
    ours = search.traceback(*search.decode(loglikes[None]), fst)[0]
    ref = ref_parity.run(ref_binary, fst, loglikes, i2p,
                         acoustic_scale=acoustic_scale, beam=1e9,
                         max_active=1 << 30, min_active=0)
    return ours, ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_matches_reference_decoder_random_graphs(ref_binary, seed):
    rng = np.random.default_rng(seed)
    num_labels = 8
    fst = random_decode_graph(rng, num_states=40, num_labels=num_labels)
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    T, V = 25, num_labels + 1
    loglikes = (rng.standard_normal((T, V)) * 3).astype(np.float32)
    ours, ref = _decode_both(ref_binary, fst, loglikes, i2p)
    assert ref["nonempty"]
    assert ours["cost"] == pytest.approx(ref["cost"], abs=1e-2)
    assert ours["words"] == ref["words"]
    assert ours["ilabels"] == ref["ilabels"]


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_matches_reference_decoder_acoustic_scale(ref_binary, scale):
    rng = np.random.default_rng(42)
    fst = random_decode_graph(rng, num_states=30, num_labels=6)
    i2p = np.arange(7, dtype=np.int32)
    loglikes = (rng.standard_normal((20, 7)) * 3).astype(np.float32)
    ours, ref = _decode_both(ref_binary, fst, loglikes, i2p,
                             acoustic_scale=scale)
    assert ours["cost"] == pytest.approx(ref["cost"], abs=1e-2)
    assert ours["words"] == ref["words"]


def test_matches_reference_decoder_ctc_mapping(ref_binary):
    """CTC-style ilabel-1 pdf mapping agrees through both decodables."""
    rng = np.random.default_rng(9)
    num_labels = 6
    fst = random_decode_graph(rng, num_states=30, num_labels=num_labels)
    # ilabel -> ilabel-1 (CTC shift); ilabel 0 unused (epsilon)
    i2p = np.concatenate([[0], np.arange(num_labels)]).astype(np.int32)
    loglikes = (rng.standard_normal((18, num_labels)) * 3).astype(np.float32)
    ours, ref = _decode_both(ref_binary, fst, loglikes, i2p)
    assert ours["cost"] == pytest.approx(ref["cost"], abs=1e-2)
    assert ours["words"] == ref["words"]
    assert ours["ilabels"] == ref["ilabels"]


def test_matches_reference_on_eval_task_graph(ref_binary):
    """The eval harness's lexicon+LM CTC decode graph through both
    implementations (the production-shaped quality anchor), with
    realistic posteriors: log-softmax over template scores."""
    from asr_decoder_tpu.eval.synth_task import SynthTask
    from asr_decoder_tpu.fst.ctc_graph import build_ctc_decode_graph
    task = SynthTask(num_phones=8, num_words=12, feat_dim=12, seed=0)
    fst, i2p = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                      task.num_phones)
    rng = np.random.default_rng(3)
    _, _, feats = task.sample_utterance(rng)
    scores = feats @ task.templates.T          # [T, P+1]
    logp = scores - np.log(np.exp(scores).sum(axis=1, keepdims=True))
    loglikes = logp.astype(np.float32)
    ours, ref = _decode_both(ref_binary, fst, loglikes,
                             np.asarray(i2p, np.int32))
    assert ref["nonempty"]
    assert ours["cost"] == pytest.approx(ref["cost"], abs=1e-2)
    assert ours["words"] == ref["words"]


# ---------------------------------------------------------------------------
# pruned-search cross-parity (VERDICT r4 #2): finite beam / max_active on
# mid-size graphs where pruning demonstrably drops paths (the exact decode
# finds a strictly better cost than the pruned one).
#
# Semantics map (ref GetCutoff, online-decoder-base-inl.h:139-245):
#   * pure beam (min_active=0, max_active unbound): candidate cutoff =
#     best + beam on both sides -> EXACT word/cost agreement is asserted.
#   * min_active/max_active binding: the reference widens/tightens its
#     cutoff to the nth_element cost +/- beam_delta (a 0.5 margin), while
#     the device search keeps exactly the top-`rank` candidates; the margin
#     admits boundary tokens differently, so agreement is asserted as a
#     bounded rate with near-identical costs on divergence.
# ---------------------------------------------------------------------------

def _midsize_graph(seed, num_states=10_000, num_labels=48):
    """random_hclg + realistically dense final states (~2%): pruned decodes
    must be able to END in a final state, else both implementations hit
    their (differing) no-final fallbacks."""
    from asr_decoder_tpu.fst.synthetic import random_hclg
    from asr_decoder_tpu.fst.fst import StdFst
    rng = np.random.default_rng(seed)
    fst0 = random_hclg(rng, num_states=num_states, num_ilabels=num_labels,
                       num_words=300)
    n = num_states
    finals = {int(s): float(rng.random())
              for s in rng.integers(0, n, max(4, n // 50))}
    finals[n - 1] = 0.0
    src_all = np.repeat(np.arange(fst0.num_states),
                        np.diff(fst0.state_offset))
    keep = (src_all < n) & (fst0.arc_dst < n)
    fst = StdFst.from_final_weights(
        n, fst0.start, src_all[keep], fst0.arc_ilabel[keep],
        fst0.arc_olabel[keep], fst0.arc_weight[keep], fst0.arc_dst[keep],
        finals)
    return fst, rng


def _peaked_loglikes(rng, T, V):
    sc = rng.standard_normal((T, V)) * 6
    return (sc - np.log(np.exp(sc).sum(1, keepdims=True))).astype(np.float32)


def _run_both(ref_binary, fst, loglikes, i2p, *, beam, max_active,
              min_active, ref_max_active=None):
    cfg = DecoderConfig(beam=beam, beam_width=max_active, arc_lanes=16,
                        max_active=max_active, min_active=min_active,
                        lattice_beam=1e9, eps_mode="auto")
    dev = DeviceFst.build(fst, arc_lanes=cfg.arc_lanes)
    search = TpuBeamSearch(dev, i2p, cfg)
    ours = search.traceback(*search.decode(loglikes[None]), fst)[0]
    ref = ref_parity.run(ref_binary, fst, loglikes, i2p, beam=beam,
                         max_active=ref_max_active or max_active,
                         min_active=min_active)
    return ours, ref


@pytest.mark.parametrize("beam,seed", [(10.0, 0), (10.0, 1), (10.0, 2),
                                       (16.0, 3), (10.0, 4), (16.0, 5)])
def test_pruned_parity_beam_binding(ref_binary, beam, seed):
    """Pure-beam regime (min_active=0, max_active unbound): the adaptive
    candidate cutoff (ref ProcessEmitting next_cutoff tightening,
    inl.h:269-340) equals best+beam on both sides -> exact agreement,
    while pruning demonstrably drops paths (exact decode beats it)."""
    fst, rng = _midsize_graph(seed)
    num_labels = 48
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    loglikes = _peaked_loglikes(rng, 120, num_labels + 1)
    ours, ref = _run_both(ref_binary, fst, loglikes, i2p, beam=beam,
                          max_active=8192, min_active=0,
                          ref_max_active=1 << 30)
    assert ref["nonempty"]
    assert ours["words"] == ref["words"]
    assert ours["cost"] == pytest.approx(ref["cost"], abs=1e-2)
    # pruning bites: the exact decode finds a strictly better path
    exact, _ = _run_both(ref_binary, fst, loglikes, i2p, beam=1e9,
                         max_active=16384, min_active=0,
                         ref_max_active=1 << 30)
    assert exact["cost"] < ours["cost"] - 1.0


def test_pruned_parity_min_active_bounded_divergence(ref_binary):
    """min_active=200 binding on both sides: the reference widens its
    cutoff to the 200th-token cost + beam_delta (0.5) while the device
    search keeps the top-200 candidate ranks exactly - boundary tokens
    admit differently, so agreement is a bounded rate; diverging
    utterances must still be within 1.5% total cost."""
    num_labels = 48
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    agree = 0
    for seed in range(6):
        fst, rng = _midsize_graph(seed)
        loglikes = _peaked_loglikes(rng, 120, num_labels + 1)
        ours, ref = _run_both(ref_binary, fst, loglikes, i2p, beam=10.0,
                              max_active=8192, min_active=200)
        if ours["words"] == ref["words"]:
            agree += 1
            assert ours["cost"] == pytest.approx(ref["cost"], rel=1e-3)
        else:
            assert ours["cost"] == pytest.approx(ref["cost"], rel=1.5e-2)
    assert agree >= 2, f"only {agree}/6 utterances agreed"


def test_pruned_parity_max_active_binding_rate(ref_binary):
    """max_active binding (K=200 << in-beam set, flat posteriors): the
    reference tightens to nth_element+beam_delta, the device search takes a
    dense top-K - documented approximation, bounded divergence rate."""
    num_labels = 48
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    agree = 0
    for seed in range(6):
        fst, rng = _midsize_graph(seed, num_states=4000)
        loglikes = (np.random.default_rng(100 + seed)
                    .standard_normal((100, num_labels + 1)) * 2
                    ).astype(np.float32)
        ours, ref = _run_both(ref_binary, fst, loglikes, i2p, beam=14.0,
                              max_active=200, min_active=20)
        if not ref["nonempty"]:
            continue
        if ours["words"] == ref["words"]:
            agree += 1
            assert ours["cost"] == pytest.approx(ref["cost"], rel=1e-3)
    assert agree >= 3, f"only {agree}/6 utterances agreed"

def test_nbest_matches_reference_pipeline(ref_binary):
    """Lattice n-best cross-parity (VERDICT r4 #3): our raw-lattice →
    determinize → n-shortest pipeline (Python and native C++) against the
    reference's GetRawLattice → DeterminizeLatticeWrapper → NShortestPath
    → ConvertNbestToVector (ref kaldi-online-nnet3-my-decoder.cc:97-105),
    on the same graph + loglikes: same word sequences in the same order
    with matching total costs.  Peaked posteriors + finite beams keep the
    reference determinizer's subset construction tractable."""
    from asr_decoder_tpu.fst.determinize import determinize_lattice
    from asr_decoder_tpu.fst.nbest import nshortest

    rng = np.random.default_rng(11)
    num_labels = 8
    fst = random_decode_graph(rng, num_states=40, num_labels=num_labels)
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    T, V = 25, num_labels + 1
    sc = rng.standard_normal((T, V)) * 5
    loglikes = (sc - np.log(np.exp(sc).sum(1, keepdims=True))
                ).astype(np.float32)

    cfg = DecoderConfig(beam=12.0, beam_width=256, arc_lanes=16,
                        max_active=256, min_active=0, lattice_beam=8.0,
                        eps_mode="auto")
    dev = DeviceFst.build(fst, arc_lanes=cfg.arc_lanes)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(loglikes[None])
    lat = search.get_lattices(init_log, logs, loglikes[None], fst)[0]
    det = determinize_lattice(lat)
    ours = nshortest(det, 5)

    ref = ref_parity.run(ref_binary, fst, loglikes, i2p, beam=12.0,
                         max_active=1 << 30, min_active=0, nbest=5)
    assert ref.get("nbest"), ref
    assert len(ours) == len(ref["nbest"]) == 5
    for o, r in zip(ours, ref["nbest"]):
        assert [int(w) for w in o.words] == r["words"]
        assert o.graph_cost + o.am_cost == pytest.approx(r["cost"],
                                                         abs=1e-2)

    # the native C++ n-best twin agrees with both
    from asr_decoder_tpu.fst.native_nbest import available as nat_ok
    from asr_decoder_tpu.fst.native_nbest import nshortest_bytes
    if nat_ok():
        nat = nshortest_bytes(det.to_bytes(), 5)
        assert [p["words"] for p in nat] == [r["words"]
                                             for r in ref["nbest"]]


def test_word_spans_match_reference_traceback(ref_binary):
    """Word-span cross-check (VERDICT r4 #8): per-word frame spans derived
    from OUR best path (align/word_align.word_spans) equal spans derived
    from the REFERENCE's own best-path arc stream under the reference's
    AlignTime interpretation ("each time you see a nonzero ilabel you can
    interpret that as a frame",
    ref: src/my-decoder/lattice-faster-decoder.h:129-137)."""
    from asr_decoder_tpu.align.word_align import word_spans

    rng = np.random.default_rng(21)
    num_labels = 8
    fst = random_decode_graph(rng, num_states=40, num_labels=num_labels)
    i2p = np.arange(num_labels + 1, dtype=np.int32)
    T, V = 25, num_labels + 1
    loglikes = (rng.standard_normal((T, V)) * 3).astype(np.float32)
    ours, ref = _decode_both(ref_binary, fst, loglikes, i2p)
    assert ours["words"] == ref["words"] and ref.get("arcs")

    # reference-side spans from ITS arc stream, word-start anchored
    spans_ref = []
    frame = 0
    for il, ol in ref["arcs"]:
        if ol != 0:
            if spans_ref:
                spans_ref[-1][2] = frame
            spans_ref.append([ol, frame, frame])
        if il != 0:
            frame += 1
    if spans_ref:
        spans_ref[-1][2] = frame

    spans_ours = word_spans(ours["arc_ids"], fst.arc_ilabel,
                            fst.arc_olabel)
    assert spans_ours == [tuple(s) for s in spans_ref]
