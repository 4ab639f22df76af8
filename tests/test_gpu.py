"""The card against the CPU backend at small widths: the AM at "highest"
precision, the headline-style search, and the search against the gold
decoder.  ``chip_smoke.py`` covers the same ground at full width.

Run on a machine with a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``; without one these
tests skip.
"""

import jax
import numpy as np
import pytest

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

pytestmark = pytest.mark.gpu


def _am_fn(layers, wave):
    from asr_decoder_tpu.frontend.fbank import FbankConfig, compute_fbank
    from asr_decoder_tpu.models.layers import init_layer_state
    from asr_decoder_tpu.models.nnet import am_forward

    feats = compute_fbank(FbankConfig(num_bins=40), wave)
    state = [init_layer_state(l, wave.shape[0]) for l in layers]
    return am_forward(layers, feats, state, skip=2)[0]


def test_am_highest_precision_matches_cpu(gpu_device):
    from asr_decoder_tpu.models.flagship import make_flagship

    cpu = jax.devices("cpu")[0]
    layers = make_flagship(jax.random.PRNGKey(0), feat_dim=40, num_pdfs=256,
                           hidden=128, proj=64, num_layers=2).layers
    waves = (np.random.default_rng(0).standard_normal((2, 32000)) * 1000
             ).astype(np.float32)
    am = jax.jit(_am_fn)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(am(jax.device_put(layers, gpu_device),
                            jax.device_put(waves, gpu_device)))
        want = np.asarray(am(jax.device_put(layers, cpu),
                             jax.device_put(waves, cpu)))
    assert np.abs(got - want).max() <= 1e-3


def _decode(device, dev, i2p, cfg, ll, fst):
    with jax.default_device(device):
        search = TpuBeamSearch(dev, i2p, cfg)
        return search.traceback(
            *search.decode(jax.device_put(ll, device)), fst)


def test_search_matches_cpu_backend(gpu_device):
    from asr_decoder_tpu.fst.synthetic import random_hclg

    rng = np.random.default_rng(1)
    fst = random_hclg(rng, num_states=5000, num_ilabels=64)
    dev = DeviceFst.build(fst, arc_lanes=8)
    i2p = np.concatenate([[0], np.arange(64)]).astype(np.int32)
    cfg = DecoderConfig(beam=14.0, beam_width=64, arc_lanes=8,
                        max_active=64, min_active=8, eps_mode="closure")
    ll = (rng.standard_normal((8, 40, 64)) * 3).astype(np.float32)
    got = _decode(gpu_device, dev, i2p, cfg, ll, fst)
    want = _decode(jax.devices("cpu")[0], dev, i2p, cfg, ll, fst)
    for g, w in zip(got, want):
        assert g["words"] == w["words"]
        assert abs(g["cost"] - w["cost"]) <= 1e-4 * abs(w["cost"])


def test_search_matches_gold(gpu_device):
    from asr_decoder_tpu.decoder.gold import GoldDecoder
    from test_beamsearch import random_decode_graph

    rng = np.random.default_rng(11)
    fst = random_decode_graph(rng)
    dev = DeviceFst.build(fst, arc_lanes=8)
    i2p = np.arange(9, dtype=np.int32)
    cfg = DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
                        min_active=0)
    ll = (rng.standard_normal((1, 10, 9)) * 3).astype(np.float32)
    gold = GoldDecoder(fst, i2p, cfg).decode(ll[0])
    res = _decode(gpu_device, dev, i2p, cfg, ll, fst)[0]
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res["words"] == gold.words
