"""End-to-end WER/RTF harness: train CTC flagship → build CTC decode graph
→ batched device decode → WER, with gold-decoder parity checking.

The framework's analogue of the reference's offline eval driver
(ref: src/kaldi-nnet3bin/kaldi-my-decoder.cc:20-125 — loglikes → decoder →
words → "real-time factor assuming 100 frames/sec" report :113-116) plus
its WER scorer (ref: src/kaldi-bin/bin/nbest-compute-wer.cc).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.decoder.config import DecoderConfig
from asr_decoder_tpu.decoder.gold import GoldDecoder
from asr_decoder_tpu.eval.synth_task import SynthTask
from asr_decoder_tpu.fst.ctc_graph import build_ctc_decode_graph
from asr_decoder_tpu.fst.device_fst import DeviceFst
from asr_decoder_tpu.models.flagship import (ctc_train_step, init_opt_state,
                                             make_flagship)
from asr_decoder_tpu.models.nnet import Nnet, am_forward
from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch
from asr_decoder_tpu.utils.wer import WerStats, score_pair


def train_ctc_model(task: SynthTask, *, hidden: int = 96, proj: int = 48,
                    num_layers: int = 2, steps: int = 400, batch: int = 32,
                    max_frames: int = 128, max_label: int = 24,
                    lr: float = 2e-3, seed: int = 0, log_every: int = 0):
    """Train the flagship projected-LSTM AM with CTC on the synthetic task
    until convergence on the default device; returns (layers, final loss).
    Returned params are host numpy, uncommitted to any device.
    """
    nnet = make_flagship(jax.random.PRNGKey(seed),
                         feat_dim=task.feat_dim,
                         num_pdfs=task.num_phones + 1, hidden=hidden,
                         proj=proj, num_layers=num_layers, context=1)
    layers = nnet.layers
    state = nnet.init_state(batch)
    opt_state = init_opt_state(layers, lr)
    rng = np.random.default_rng(seed + 1)
    loss = float("nan")
    for step in range(steps):
        x, labels, pads = task.sample_batch(rng, batch, max_frames,
                                            max_label)
        layers, opt_state, loss = ctc_train_step(
            layers, opt_state, jnp.asarray(x), jnp.asarray(labels),
            jnp.asarray(pads), state, lr)
        if log_every and (step + 1) % log_every == 0:
            print(f"  ctc step {step + 1}/{steps} "
                  f"loss={float(loss):.3f}")
    return jax.device_get(layers), float(loss)


@dataclass
class EvalResult:
    wer: WerStats
    gold_wer: WerStats | None
    gold_mismatches: int       # gold-checked utts where device hyp != gold
    frames: int
    wav_seconds: float         # at the reference's 100 frames/s accounting
    decode_seconds: float
    am_seconds: float
    # cross-implementation parity material: the decode graph, the ilabel
    # map, and (loglikes, device hyp words, device cost) for the first
    # ``keep_samples`` utterances — eval.py re-decodes these through the
    # actual reference C++ LatticeFasterDecoder (decoder/ref_parity.py)
    fst: object = None
    ilabel2pdf: object = None
    samples: list = None

    @property
    def rtf(self) -> float:
        """ref kaldi-my-decoder.cc:113-116: elapsed·100/frame_count."""
        return (self.am_seconds + self.decode_seconds) / \
            max(self.wav_seconds, 1e-9)


def evaluate_wer(task: SynthTask, layers, *, num_utts: int = 64,
                 batch: int = 16, max_frames: int = 160,
                 config: DecoderConfig | None = None, seed: int = 1234,
                 check_gold: int = 0, keep_samples: int = 0) -> EvalResult:
    """Decode a held-out set through the device beam search; score WER
    against the sampled transcripts; optionally gold-decode the first
    ``check_gold`` utterances on host and score them identically (device
    WER must equal gold WER — the parity axis)."""
    fst, i2p = build_ctc_decode_graph(task.lexicon, task.word_costs,
                                      task.num_phones)
    config = config or DecoderConfig(beam=16.0, beam_width=2048,
                                     max_active=7000, min_active=200,
                                     arc_lanes=16)
    dev = DeviceFst.build(fst, arc_lanes=config.arc_lanes)
    search = TpuBeamSearch(dev, i2p, config)

    rng = np.random.default_rng(seed)
    utts = []
    while len(utts) < num_utts:
        words, _, feats = task.sample_utterance(rng)
        if len(feats) <= max_frames:
            utts.append((words, feats))

    wer = WerStats()
    gold_wer = WerStats() if check_gold else None
    samples: list = []
    mismatches = 0
    frames = am_s = dec_s = 0.0
    state0 = Nnet(layers).init_state(batch)
    golds_done = 0
    # warmup: compile the AM + search programs before timing (RTF must
    # measure steady-state decode, not XLA compilation)
    warm = jnp.zeros((batch, max_frames, task.feat_dim), jnp.float32)
    wll, _ = am_forward(layers, warm, state0, do_softmax=True, do_log=True,
                        sub_prior=False)
    wst, _, _ = search.decode(wll, np.ones((batch, max_frames), bool))
    jax.block_until_ready(wst.tok_cost)
    for lo in range(0, num_utts, batch):
        chunk = utts[lo:lo + batch]
        B = len(chunk)
        feats = np.zeros((batch, max_frames, task.feat_dim), np.float32)
        lens = np.zeros(batch, np.int64)
        for b, (_, x) in enumerate(chunk):
            feats[b, :len(x)] = x
            feats[b, len(x):] = task.templates[0]
            lens[b] = len(x)
        t0 = time.monotonic()
        lls, _ = am_forward(layers, jnp.asarray(feats), state0,
                            do_softmax=True, do_log=True, sub_prior=False)
        lls = jax.block_until_ready(lls)
        t1 = time.monotonic()
        mask = np.arange(max_frames)[None, :] < lens[:, None]
        st, init_log, logs = search.decode(lls, mask)
        jax.block_until_ready(st.tok_cost)
        t2 = time.monotonic()
        am_s += t1 - t0
        dec_s += t2 - t1
        frames += float(lens[:B].sum())
        results = search.traceback(st, init_log, logs, fst)
        lls_np = np.asarray(lls)
        for b, (words, _) in enumerate(chunk):
            hyp = results[b]["words"]
            if len(samples) < keep_samples:
                samples.append((lls_np[b, :int(lens[b])].copy(), list(hyp),
                                float(results[b]["cost"])))
            wer += score_pair(words, hyp)
            if gold_wer is not None and golds_done < check_gold:
                g = GoldDecoder(fst, i2p, config).decode(
                    lls_np[b, :int(lens[b])])
                gold_wer += score_pair(words, g.words)
                mismatches += int(g.words != hyp)
                golds_done += 1
    return EvalResult(wer=wer, gold_wer=gold_wer,
                      gold_mismatches=mismatches, frames=int(frames),
                      wav_seconds=frames / 100.0, decode_seconds=dec_s,
                      am_seconds=am_s, fst=fst, ilabel2pdf=i2p,
                      samples=samples)
