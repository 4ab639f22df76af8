"""The decode operating points shared by ``bench.py``, ``chip_smoke.py``
and ``tools/perf``: the flagship AM's width, the headline HCLG-shaped
graph, the composed production TLG and its CTC-spiky posteriors.  Every
model, graph and posterior is made from a seed.

* headline — 200k-state HCLG-shaped graph over 2048 ilabels, beam 14,
  ``beam_width = max_active = 512``, ε-closure mode.
* production — T∘(L∘G) over a synthetic 40k-word 4-gram ARPA LM (~2.5M
  states), beam 12, ``max_active = 4096``, ``topk_overfetch = 1`` (ref
  production conf src/v1-asrbin/conf/decoder.conf, max-active 7000).
"""

from __future__ import annotations

import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig

# flagship AM: 80-bin fbank → projected LSTM 3×1024 (proj 512) → 2048 pdfs
FLAGSHIP = dict(feat_dim=80, num_pdfs=2048, hidden=1024, proj=512,
                num_layers=3)
SKIP = 2                      # frame-subsampling factor 3 (ref conf)
HEADLINE_STATES = 200_000
PRODUCTION_PHONES = 40


def headline_config() -> DecoderConfig:
    return DecoderConfig(beam=14.0, beam_width=512, arc_lanes=8,
                         max_active=512, min_active=16, eps_mode="closure")


def production_config() -> DecoderConfig:
    # topk_overfetch=1: with live ≪ K the K·F candidate cut never binds
    # (duplicate crowding needs a saturated beam)
    return DecoderConfig(beam=12.0, beam_width=4096, arc_lanes=16,
                         max_active=4096, min_active=200,
                         eps_mode="closure", topk_overfetch=1)


def ctc_ilabel2pdf(num_pdfs: int) -> np.ndarray:
    """ilabel i scores AM row i-1 (ref: nnet-nnet.h:226 "ilabel - 1")."""
    return np.concatenate([[0], np.arange(num_pdfs)]).astype(np.int32)


def headline_graph(seed: int = 0, num_states: int = HEADLINE_STATES):
    """(StdFst, ilabel2pdf) of the headline HCLG-shaped graph."""
    from asr_decoder_tpu.fst.synthetic import random_hclg
    num_pdfs = FLAGSHIP["num_pdfs"]
    fst = random_hclg(np.random.default_rng(seed), num_states=num_states,
                      num_ilabels=num_pdfs)
    return fst, ctc_ilabel2pdf(num_pdfs)


def production_tlg(seed: int = 1, vocab_size: int = 40_000,
                   n_bigram: int = 220_000, n_trigram: int = 130_000,
                   n_4gram: int = 60_000,
                   num_phones: int = PRODUCTION_PHONES):
    """(StdFst, ilabel2pdf, lexicon) of the composed production TLG:
    trie lexicon ∘ synthetic 4-gram ARPA, built with the repo's own
    ``lm/arpa`` + ``fst/tlg`` tools."""
    from asr_decoder_tpu.fst.tlg import build_tlg
    from asr_decoder_tpu.lm.arpa import parse_arpa
    from asr_decoder_tpu.lm.synth_arpa import synth_arpa_text
    rng = np.random.default_rng(seed)
    fsa = parse_arpa(synth_arpa_text(
        vocab_size=vocab_size, n_bigram=n_bigram, n_trigram=n_trigram,
        n_4gram=n_4gram, seed=seed))
    lexicon = {}
    for wname, wid in fsa.vocab.items():
        if not wname.startswith("w"):
            continue
        n = int(rng.integers(3, 8))
        ph = [int(rng.integers(1, num_phones + 1))]
        while len(ph) < n:
            p = int(rng.integers(1, num_phones + 1))
            if p != ph[-1]:
                ph.append(p)
        lexicon[wid] = ph
    fst, i2p = build_tlg(lexicon, fsa, num_phones)
    return fst, np.asarray(i2p, np.int32), lexicon


def tlg_posteriors(rng, lexicon, num_phones, B, T):
    """Peaked posteriors over a TLG's phone set: word sequences rendered as
    per-phone template frames + noise, log-softmax scored (the eval
    harness's template model, eval/synth_task.py).  CTC-spiky: ~1 frame
    per phone spike with blank frames between, the regime the reference's
    skip-block targets."""
    t = rng.standard_normal((num_phones + 1, 24))
    # scale 2.5 ⇒ top posterior ~0.95+, the sharpness trained CTC AMs give
    templates = (t / np.linalg.norm(t, axis=1, keepdims=True)
                 ).astype(np.float32) * 2.5
    words = sorted(lexicon)
    lls = np.zeros((B, T, num_phones + 1), np.float32)
    for b in range(B):
        rows = [0, 0]
        while len(rows) < T:
            w = words[int(rng.integers(0, len(words)))]
            for q in lexicon[w]:
                rows.extend([q] * int(rng.integers(1, 3)))
                rows.extend([0] * int(rng.integers(0, 3)))
            rows.append(0)
        rows = rows[:T]
        feats = templates[np.array(rows)] + \
            rng.standard_normal((T, 24)).astype(np.float32) * 0.35
        sc = feats @ templates.T
        lls[b] = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
    return lls
