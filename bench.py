"""End-to-end decode throughput benchmark on one GPU.

Pipeline benchmarked — the reference's canonical serve path (SURVEY §3.1:
fbank → AM forward → WFST beam search), batched:
  16 kHz waveform batch → 80-dim fbank → flagship projected-LSTM AM with
  frame-subsampling 3 → batched frame-synchronous Viterbi beam search with
  full lattice/backpointer logging → per-utterance token beams.

Three operating points (``asr_decoder_tpu/eval/operating_points.py``):
  * headline — 200k-state HCLG-shaped graph, 256 concurrent streams,
    max_active 512.
  * production — a COMPOSED ~2.5M-state TLG (lexicon tries over a
    synthetic 4-gram ARPA LM; ref conf src/v1-asrbin/conf/decoder.conf
    max-active 7000) at max_active 4096 with CTC-spiky posteriors and
    blank-skip frame packing; search only; graph build/load timed.
  * realistic — 30k-word single-hub trie TLG at max_active 1024.

Metric: aggregate audio-seconds decoded per wall-second per card
(BASELINE.json).  vs_baseline: the reference's production CPU serving
configuration decodes ~60 concurrent real-time streams per node
(--nthread=60 at decoder rt ≈ 1.0, ref: src/v2-asrbin/conf/v2-conf.txt),
i.e. ~60 audio-seconds/s — vs_baseline = (audio-s/s per card) / 60.

Each time is the minimum over a few iterations, each ending in
``jax.block_until_ready``.  Fails unless JAX's default device is a GPU;
``detail.device`` and ``detail.card`` name what ran.

Usage: python bench.py [--quick] [--profile-dir=DIR]
Prints exactly one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_AUDIO_S_PER_S = 60.0   # one reference CPU node (60 threads @ RTF 1)


def _time(fn, *args, iters=3):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main(quick: bool = False, profile_dir: str | None = None):
    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.eval import operating_points as op
    from asr_decoder_tpu.frontend.fbank import FbankConfig, compute_fbank
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    from asr_decoder_tpu.models.flagship import make_flagship
    from asr_decoder_tpu.models.nnet import am_forward
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch
    from asr_decoder_tpu.utils.device import (device_info,
                                              enable_compile_cache,
                                              gpu_name_and_power_limit,
                                              require_gpu)

    require_gpu()
    enable_compile_cache()
    rng = np.random.default_rng(0)
    sr = 16000
    secs = 8.0
    batch = 256 if not quick else 4

    fb_cfg = FbankConfig(num_bins=op.FLAGSHIP["feat_dim"])
    nnet = make_flagship(jax.random.PRNGKey(0), **op.FLAGSHIP)
    layers = nnet.layers
    am_state = nnet.init_state(batch)

    fst, ilabel2pdf = op.headline_graph(
        0, op.HEADLINE_STATES if not quick else 5_000)
    cfg = op.headline_config()
    dev = DeviceFst.build(fst, arc_lanes=cfg.arc_lanes)
    search = TpuBeamSearch(dev, ilabel2pdf, cfg)

    wave = jnp.asarray(rng.standard_normal((batch, int(sr * secs))) * 1000,
                       jnp.float32)

    def am_fn(w):
        feats = compute_fbank(fb_cfg, w)
        ll, _ = am_forward(layers, feats, am_state, skip=op.SKIP)
        return ll

    am_jit = jax.jit(am_fn)
    ll = jax.block_until_ready(am_jit(wave))
    state0, _ = search.init_state(batch)

    def pipeline(w):
        ll = am_jit(w)
        state, init_log = search.init_state(batch)
        state, logs = search.advance(state, ll)
        return state, logs

    iters = 3 if not quick else 1
    t_am = _time(am_jit, wave, iters=iters)
    t_search = _time(lambda l: search.advance(state0, l)[0], ll,
                     iters=2 * iters)
    if profile_dir:
        # xprof/Perfetto capture of one full pipeline run (SURVEY §5)
        from asr_decoder_tpu.utils.profiling import trace
        with trace(profile_dir):
            jax.block_until_ready(pipeline(wave))
    dt = _time(pipeline, wave, iters=iters)

    audio_s = batch * secs
    audio_s_per_s = audio_s / dt

    prod = None
    if not quick:
        from asr_decoder_tpu.models.nnet import pack_nonblank_frames
        t0 = time.perf_counter()
        fst2, i2p2, lexicon = op.production_tlg()
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg2 = op.production_config()
        dev2 = DeviceFst.build(fst2, arc_lanes=cfg2.arc_lanes)
        search2 = TpuBeamSearch(dev2, i2p2, cfg2)
        t_load = time.perf_counter() - t0
        bp, Tp = 32, 264
        raw_ll = op.tlg_posteriors(np.random.default_rng(2), lexicon,
                                   op.PRODUCTION_PHONES, bp, Tp)
        # CTC blank-skip frame packing (ref SkipBlockFrame,
        # nnet-nnet.h:265-275): frames whose blank log-posterior exceeds
        # log(0.75) never reach the search
        packed, pmask = pack_nonblank_frames(raw_ll, 0,
                                             thresh=float(np.log(0.75)))
        ll2, pmask_dev = jax.block_until_ready(
            (jnp.asarray(packed), jnp.asarray(pmask)))
        st2, _ = search2.init_state(bp)
        t_s2 = _time(lambda l: search2.advance(st2, l, pmask_dev)[0], ll2,
                     iters=2 * iters)
        stf, _ = search2.advance(st2, ll2, pmask_dev)
        live = (np.asarray(stf.tok_cost) < np.inf).sum(axis=1)
        # Tp frames are subsampled ×3 (frame-subsampling-factor 3, the
        # reference production conf) → Tp/33.3 s of audio per utterance
        prod_audio_s = bp * Tp * 3 / 100.0
        prod = {
            "graph": "composed TLG (trie ∘ 4-gram ARPA)",
            "graph_states": int(dev2.num_states),
            "graph_arcs": int(fst2.num_arcs),
            "vocab": 40_000,
            "max_active": cfg2.max_active,
            "batch": bp,
            "frames": Tp,
            "packed_frames": int(packed.shape[1]),
            "subsampling": 3,
            "relax": search2.relax_impl,
            "live_mean": int(live.mean()),
            "search_audio_s_per_s": round(prod_audio_s / t_s2, 1),
            "search_ms": round(t_s2 * 1e3, 1),
            "graph_build_s": round(t_gen, 1),
            "graph_load_s": round(t_load, 1),
        }

    realistic = None
    if not quick:
        from asr_decoder_tpu.eval.synth_task import SynthTask
        from asr_decoder_tpu.fst.ctc_graph import build_ctc_decode_graph
        task = SynthTask(num_phones=40, num_words=30_000, feat_dim=24,
                         seed=0)
        t0 = time.perf_counter()
        fst3, i2p3 = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                            task.num_phones,
                                            share_prefixes=True)
        dev3 = DeviceFst.build(fst3, arc_lanes=16)
        cfg3 = DecoderConfig(beam=14.0, beam_width=1024, arc_lanes=16,
                             max_active=1024, min_active=200,
                             eps_mode="closure")
        search3 = TpuBeamSearch(dev3, np.asarray(i2p3, np.int32), cfg3)
        t_load3 = time.perf_counter() - t0
        rng3 = np.random.default_rng(7)
        Br, Tr = 64, 160
        lls3 = np.zeros((Br, Tr, task.num_phones + 1), np.float32)
        for b in range(Br):
            while True:
                _, _, feats = task.sample_utterance(rng3)
                if len(feats) <= Tr:
                    break
            sc = feats @ task.templates.T
            lp = sc - np.log(np.exp(sc).sum(axis=1, keepdims=True))
            lls3[b, :len(lp)] = lp
            lls3[b, len(lp):] = lp[-1]
        lls3 = jax.block_until_ready(jnp.asarray(lls3))
        st3, _ = search3.init_state(Br)
        t_s3 = _time(lambda l: search3.advance(st3, l)[0], lls3,
                     iters=2 * iters)
        realistic = {
            "graph_states": int(dev3.num_states),
            "graph_arcs": int(fst3.num_arcs),
            "vocab": 30_000,
            "max_active": cfg3.max_active,
            "batch": Br,
            "posteriors": "template-softmax",
            "relax": search3.relax_impl,
            "search_audio_s_per_s": round(Br * Tr / 100.0 / t_s3, 1),
            "search_ms": round(t_s3 * 1e3, 1),
            "graph_load_s": round(t_load3, 1),
        }

    print(json.dumps({
        "metric": "audio_seconds_per_second_per_chip",
        "value": round(audio_s_per_s, 2),
        "unit": "audio-s/s",
        "vs_baseline": round(audio_s_per_s / BASELINE_AUDIO_S_PER_S, 3),
        "detail": {
            "device": device_info(),
            "card": gpu_name_and_power_limit(),
            "batch": batch, "wave_secs": secs,
            "graph_states": dev.num_states,
            "beam_width": cfg.beam_width,
            "relax": search.relax_impl,
            "am_audio_s_per_s": round(audio_s / t_am, 1),
            "search_audio_s_per_s": round(audio_s / t_search, 1),
            "am_ms": round(t_am * 1e3, 1),
            "search_ms": round(t_search * 1e3, 1),
            "frames": int(ll.shape[1]),
            "timing": "min over iters, block_until_ready",
            "production": prod,
            "realistic": realistic,
        },
    }))


if __name__ == "__main__":
    pdir = None
    for a in sys.argv[1:]:
        if a.startswith("--profile-dir="):
            pdir = a.split("=", 1)[1]
    main(quick="--quick" in sys.argv, profile_dir=pdir)
