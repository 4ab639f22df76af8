"""Composed TLG decode graph: LM-score consistency through full decodes,
backoff topology, synthetic-ARPA generator sanity (the production-scale
composed-graph path, VERDICT r4 #5)."""

import numpy as np
import pytest

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.fst.tlg import build_tlg
from asr_decoder_tpu.lm.arpa import parse_arpa
from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

from test_lm import ARPA


def _decode_phone_seq(fst, i2p, seq, num_phones):
    """Force-decode a phone/blank frame sequence (0 = blank) with 0-cost
    acoustics on the intended rows: total path cost == graph cost."""
    V = num_phones + 2
    ll = np.full((1, len(seq), V), -30.0, np.float32)
    for t, p in enumerate(seq):
        ll[0, t, p if p else 0] = 0.0
    dev = DeviceFst.build(fst, arc_lanes=16)
    cfg = DecoderConfig(beam=1e9, beam_width=512, arc_lanes=16,
                        max_active=512, min_active=4, eps_mode="closure")
    search = TpuBeamSearch(dev, np.asarray(i2p, np.int32), cfg)
    st, il, lg = search.decode(ll)
    return search.traceback(st, il, lg, fst)[0]


def test_tlg_costs_match_lm_score():
    """A full decode through the composed TLG accumulates exactly the LM's
    n-gram + backoff + </s> costs (fsa.score_ids) for the decoded words."""
    fsa = parse_arpa(ARPA)
    a, b = fsa.vocab["a"], fsa.vocab["b"]
    num_phones = 4
    lexicon = {a: [1, 2], b: [3]}
    fst, i2p = build_tlg(lexicon, fsa, num_phones)
    assert fst.olabel_anchor == "end"

    # phones: a=(1,2), b=(3); frames: 1 1 2 0 3  → "a b"
    res = _decode_phone_seq(fst, i2p, [1, 1, 2, 0, 3], num_phones)
    assert res["words"] == [a, b]
    assert res["reached_final"]
    # bigram path: p(a|<s>) + p(b|a) + backoff-chased p(</s>|b)
    assert res["cost"] == pytest.approx(fsa.score_ids([a, b]), abs=1e-4)

    # a different word order exercises different n-grams/backoffs
    res = _decode_phone_seq(fst, i2p, [3, 0, 1, 1, 2], num_phones)
    assert res["words"] == [b, a]
    assert res["cost"] == pytest.approx(fsa.score_ids([b, a]), abs=1e-4)


def test_tlg_lm_scale():
    fsa = parse_arpa(ARPA)
    a, b = fsa.vocab["a"], fsa.vocab["b"]
    lexicon = {a: [1, 2], b: [3]}
    fst, i2p = build_tlg(lexicon, fsa, 4, lm_scale=0.5)
    res = _decode_phone_seq(fst, i2p, [1, 1, 2, 0, 3], 4)
    assert res["cost"] == pytest.approx(0.5 * fsa.score_ids([a, b]),
                                        abs=1e-4)


def test_tlg_shares_prefixes_per_hub():
    """Words sharing a prefix from the same LM state share trie nodes; the
    hub out-degree is bounded by distinct first phones, not vocab."""
    fsa = parse_arpa(ARPA)
    a, b, c = fsa.vocab["a"], fsa.vocab["b"], fsa.vocab["c"]
    lexicon = {a: [1, 2], b: [1, 3], c: [1, 2, 4]}
    fst, i2p = build_tlg(lexicon, fsa, 4)
    # unigram hub: all three words start with phone 1 → exactly one
    # phone-1 entry arc from the unigram hub
    s = fsa.unigram
    arcs = [(int(fst.arc_ilabel[k]), int(fst.arc_dst[k]))
            for k in range(int(fst.state_offset[s]),
                           int(fst.state_offset[s + 1]))]
    entry = [x for x in arcs if x[0] == 1 and x[1] != s]
    assert len(entry) == 1


def test_synth_arpa_parses_and_composes():
    """The synthetic ARPA generator yields a valid hierarchical LM that
    parses, scores, and composes into a TLG with LM-consistent costs."""
    text = synth_arpa_text(vocab_size=50, n_bigram=120, n_trigram=60,
                           n_4gram=25, seed=3)
    fsa = parse_arpa(text)
    assert fsa.num_states > 50
    rng = np.random.default_rng(0)
    num_phones = 8
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if not wname.startswith("w"):
            continue
        n = int(rng.integers(2, 5))
        ph = [int(rng.integers(1, num_phones + 1))]
        while len(ph) < n:
            p = int(rng.integers(1, num_phones + 1))
            if p != ph[-1]:
                ph.append(p)
        lexicon[wid] = ph
    fst, i2p = build_tlg(lexicon, fsa, num_phones)
    assert fst.num_states > fsa.num_states
    # decode one 2-word sequence and check the LM cost
    w1, w2 = lexicon and sorted(lexicon)[:2]
    seq = []
    for w in (w1, w2):
        seq += lexicon[w] + [0]
    res = _decode_phone_seq(fst, i2p, seq, num_phones)
    if res["words"] == [w1, w2]:       # another pair may tie cheaper
        assert res["cost"] == pytest.approx(fsa.score_ids([w1, w2]),
                                            abs=1e-3)


def test_tlg_streaming_session_end_to_end():
    """A composed TLG behind the full streaming session (fbank → AM →
    search → traceback + word alignment): chunked decode equals one-shot,
    and alignment spans use the TLG's end-anchored olabels."""
    import jax
    from asr_decoder_tpu.fst.symbol import SymbolTable
    from asr_decoder_tpu.models.flagship import make_flagship
    from asr_decoder_tpu.frontend.fbank import FbankConfig
    from asr_decoder_tpu.serving.session import (OnlineDecoderConfig,
                                                 OnlineDecoderInfo,
                                                 OnlineDecoderSession)

    fsa = parse_arpa(__import__("test_lm").ARPA)
    a, b = fsa.vocab["a"], fsa.vocab["b"]
    num_phones = 6
    lexicon = {a: [1, 2], b: [3]}
    fst, i2p = build_tlg(lexicon, fsa, num_phones)
    nnet = make_flagship(jax.random.PRNGKey(0), feat_dim=16,
                         num_pdfs=num_phones + 1, hidden=16, proj=8,
                         num_layers=1, context=1)
    words = SymbolTable()
    words.add("<eps>", 0)
    for name, wid in sorted(fsa.vocab.items(), key=lambda kv: kv[1]):
        if wid > 0:
            words.add(name, wid)
    info = OnlineDecoderInfo(
        nnet, fst, words, np.asarray(i2p, np.int32),
        decoder_config=DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8,
                                     max_active=64, min_active=0,
                                     lattice_beam=8.0),
        online_config=OnlineDecoderConfig(chunk_frames=16),
        fbank_config=FbankConfig(num_bins=16))
    rng = np.random.default_rng(4)
    wave = (rng.standard_normal(9600) * 3000).astype(np.float32)

    s1 = OnlineDecoderSession(info)
    s1.process_data(wave, eos=True)
    one = s1.get_best_path()
    ali = s1.get_word_alignment()

    s2 = OnlineDecoderSession(info)
    for lo in range(0, len(wave), 3200):
        s2.process_data(wave[lo:lo + 3200], eos=lo + 3200 >= len(wave))
    two = s2.get_best_path()
    assert two["words"] == one["words"]
    assert two["cost"] == pytest.approx(one["cost"], abs=1e-3)
    # alignment matches the decoded words, spans monotone non-overlapping
    assert [w for w, _, _ in ali] == words.words(one.get("words", []))
    for (w1, b1, e1), (w2, b2, e2) in zip(ali, ali[1:]):
        assert b1 <= e1 <= b2 <= e2
