"""Compare the relax engines (v2 sort, v3 topk) on the bench operating
points (headline 200k HCLG / production TLG / realistic trie-TLG), search
only, on one GPU.

Usage: python tools/perf/bench_points.py [headline|production|realistic] ...
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def time_search(search, st, ll, mask, iters=3):
    import jax
    jax.block_until_ready(search.advance(st, ll, mask)[0])
    best = 1e30
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(search.advance(st, ll, mask)[0])
        best = min(best, time.perf_counter() - t0)
    return best


def live_stats(search, st, ll, mask):
    stf, _ = search.advance(st, ll, mask)
    live = (np.asarray(stf.tok_cost) < np.inf).sum(axis=1)
    return int(live.mean()), int(live.max())


def run_point(name):
    import dataclasses

    import jax.numpy as jnp

    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    from asr_decoder_tpu.models.nnet import pack_nonblank_frames
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

    rng = np.random.default_rng(1)
    mask = None
    if name == "headline":
        fst, i2p = op.headline_graph(0)
        base = op.headline_config()
        dev = DeviceFst.build(fst, arc_lanes=base.arc_lanes)
        B, T, V = 256, 88, op.FLAGSHIP["num_pdfs"]
        ll = np.asarray(rng.standard_normal((B, T, V)) * 3, np.float32)
        audio_s = B * 8.0          # 88 frames at subsampling 3 = 8 s
    elif name == "production":
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from profile_production import load_production_graph
        dev, i2p, lexicon = load_production_graph()
        base = op.production_config()
        raw = op.tlg_posteriors(rng, lexicon, op.PRODUCTION_PHONES, 32, 264)
        ll, mask = pack_nonblank_frames(raw, 0, thresh=float(np.log(0.75)))
        audio_s = 32 * 264 * 3 / 100.0
    else:  # realistic
        from asr_decoder_tpu.eval.synth_task import SynthTask
        from asr_decoder_tpu.fst.ctc_graph import build_ctc_decode_graph
        task = SynthTask(num_phones=40, num_words=30_000, feat_dim=24,
                         seed=0)
        fst, i2p = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                          task.num_phones,
                                          share_prefixes=True)
        i2p = np.asarray(i2p, np.int32)
        dev = DeviceFst.build(fst, arc_lanes=16)
        B, T = 64, 160
        rng3 = np.random.default_rng(7)
        ll = np.zeros((B, T, task.num_phones + 1), np.float32)
        for b in range(B):
            while True:
                _, _, feats = task.sample_utterance(rng3)
                if len(feats) <= T:
                    break
            sc = feats @ task.templates.T
            lp = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
            ll[b, :len(lp)] = lp
            ll[b, len(lp):] = lp[-1]
        base = DecoderConfig(beam=14.0, beam_width=1024, arc_lanes=16,
                             max_active=1024, min_active=200,
                             eps_mode="closure")
        audio_s = B * T / 100.0

    ll = jnp.asarray(ll)
    mask = None if mask is None else jnp.asarray(mask)
    for relax in ("topk", "sort"):
        search = TpuBeamSearch(dev, i2p,
                               dataclasses.replace(base, relax_impl=relax))
        st, _ = search.init_state(ll.shape[0])
        lm, lx = live_stats(search, st, ll, mask)
        dt = time_search(search, st, ll, mask)
        print(f"{name:11s} {relax:5s} search {dt*1e3:8.1f} ms  "
              f"{audio_s/dt:8.1f} audio-s/s   live mean={lm} max={lx}",
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from asr_decoder_tpu.utils.device import (enable_compile_cache,
                                              require_gpu)
    require_gpu()
    enable_compile_cache()
    for p in (sys.argv[1:] or ["realistic", "headline"]):
        run_point(p)
