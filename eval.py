"""End-to-end WER + RTF eval driver (the offline eval binary).

The framework's ``kaldi-my-decoder`` (ref: src/kaldi-nnet3bin/
kaldi-my-decoder.cc:20-125): train the flagship CTC AM to convergence on the
hermetic synthetic phone task, build a lexicon+LM CTC decode graph, decode a
held-out set through the batched device beam search at a production
operating point (beam 16 / beam_width 2048 / max_active 7000 / min_active
200), score WER, gold-check device/host parity, and report RTF with the
reference's "assuming 100 frames/sec" accounting (ref :113-116).

Usage: python eval.py [--quick] [--steps N] [--utts N]
"""

from __future__ import annotations

import json
import sys
import time


def main() -> None:
    quick = "--quick" in sys.argv

    def argval(name, default):
        return int(sys.argv[sys.argv.index(name) + 1]) \
            if name in sys.argv else default

    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.eval.harness import evaluate_wer, train_ctc_model
    from asr_decoder_tpu.eval.synth_task import SynthTask
    from asr_decoder_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    if quick:
        task = SynthTask(num_phones=8, num_words=12, feat_dim=12, seed=0)
        steps = argval("--steps", 800)
        hidden, proj, layers_n = 64, 32, 1
        utts = argval("--utts", 32)
        check_gold = 8
    else:
        task = SynthTask(num_phones=20, num_words=50, feat_dim=24, seed=0)
        steps = argval("--steps", 2500)
        hidden, proj, layers_n = 128, 64, 2
        utts = argval("--utts", 128)
        check_gold = 16

    t0 = time.monotonic()
    layers, loss = train_ctc_model(
        task, hidden=hidden, proj=proj, num_layers=layers_n, steps=steps,
        batch=32, max_frames=160, max_label=32, lr=5e-3,
        log_every=max(steps // 5, 1))
    train_s = time.monotonic() - t0
    print(f"trained {steps} steps in {train_s:.1f}s, final ctc loss "
          f"{loss:.4f}", file=sys.stderr)

    config = DecoderConfig(beam=16.0, beam_width=2048, max_active=7000,
                           min_active=200, arc_lanes=16)
    res = evaluate_wer(task, layers, num_utts=utts, batch=16,
                       max_frames=192, config=config,
                       check_gold=check_gold, keep_samples=check_gold)
    w = res.wer

    # cross-implementation parity: same graph + loglikes through the ACTUAL
    # reference C++ LatticeFasterDecoder (built Kaldi-free from
    # /root/reference, see decoder/ref_parity.py) at the same operating
    # point — word agreement externally anchors the WER number
    ref_par = None
    from asr_decoder_tpu.decoder import ref_parity
    if ref_parity.available() and res.samples:
        import tempfile
        binary = ref_parity.build(tempfile.mkdtemp(prefix="refparity_"))
        agree = 0
        max_dcost = 0.0
        for lls, hyp, cost in res.samples:
            r = ref_parity.run(binary, res.fst, lls, res.ilabel2pdf,
                               beam=config.beam,
                               max_active=config.max_active,
                               min_active=config.min_active)
            agree += int(r.get("words", []) == hyp)
            if r.get("nonempty"):
                max_dcost = max(max_dcost, abs(r["cost"] - cost))
        ref_par = {"checked": len(res.samples), "words_agree": agree,
                   "max_cost_delta": round(max_dcost, 4)}
        print(f"reference C++ decoder parity: {agree}/{len(res.samples)} "
              f"words agree, max |Δcost| {max_dcost:.4f}", file=sys.stderr)
    print(json.dumps({
        "metric": "wer",
        "value": round(w.wer, 4),
        "unit": "errors/ref-word",
        "detail": {
            "errors": w.errors, "ref_len": w.ref_len,
            "subs": w.subs, "ins": w.ins, "dels": w.dels,
            "ser": round(w.ser, 4),
            "gold_wer": round(res.gold_wer.wer, 4),
            "gold_checked": check_gold,
            "gold_mismatches": res.gold_mismatches,
            "utts": utts, "frames": res.frames,
            "rtf": round(res.rtf, 5),
            "decode_audio_s_per_s": round(
                res.wav_seconds / max(res.decode_seconds +
                                      res.am_seconds, 1e-9), 1),
            "operating_point": {
                "beam": config.beam, "beam_width": config.beam_width,
                "max_active": config.max_active,
                "min_active": config.min_active},
            "ctc_loss": round(loss, 4),
            "ref_parity": ref_par,
        }}))


if __name__ == "__main__":
    main()
