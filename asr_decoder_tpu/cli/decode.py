"""Offline batch decode + RTF/WER eval main.

ref: src/kaldi-nnet3bin/kaldi-my-decoder.cc:20-125 — decode a list of
inputs, print per-utterance words, report "real-time factor assuming 100
frames/sec" (:113-116).  Inputs are wav files (full frontend+AM pipeline);
with ``--ref-text`` a transcript file (``<utt-id> <word> ...`` per line,
ids matching the wav list order) is WER-scored like
src/kaldi-bin/bin/nbest-compute-wer.cc.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from asr_decoder_tpu.cli._model import build_info, register_info_flags
from asr_decoder_tpu.serving.session import OnlineDecoderSession
from asr_decoder_tpu.utils.config import ConfigOptions
from asr_decoder_tpu.utils.device import enable_compile_cache
from asr_decoder_tpu.utils.wer import WerStats, score_pair


def read_wav(path: str) -> np.ndarray:
    from asr_decoder_tpu.frontend.audio import decode_audio
    with open(path, "rb") as f:
        return decode_audio(f.read())


def main(argv: list[str] | None = None) -> int:
    opts = ConfigOptions(
        usage="decode [options] <nnet-binary> <graph> <words.txt> "
              "<wav-list>")
    dec, online, fbank, am, extra = register_info_flags(opts)
    ref_file = {"v": ""}
    opts.register("ref-text", lambda: ref_file["v"],
                  lambda v: ref_file.__setitem__("v", v),
                  "Reference transcripts for WER scoring", str)
    ali = {"v": False}
    opts.register("ali", lambda: ali["v"],
                  lambda v: ali.__setitem__("v", v),
                  "Print per-word time spans (AlignTime) per utterance",
                  bool)
    pos = opts.parse(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    if len(pos) != 4:
        print(opts.usage(), file=sys.stderr)
        return 2
    info = build_info(pos[0], pos[1], pos[2], dec, online, fbank, am, extra)
    with open(pos[3]) as f:
        wavs = [ln.strip() for ln in f if ln.strip()]
    refs = {}
    if ref_file["v"]:
        with open(ref_file["v"]) as f:
            for ln in f:
                parts = ln.split()
                if parts:
                    refs[parts[0]] = parts[1:]
    session = OnlineDecoderSession(info)
    wer = WerStats()
    tot_frames = 0
    t0 = time.monotonic()
    for line in wavs:
        parts = line.split()
        utt, path = (parts[0], parts[1]) if len(parts) > 1 \
            else (parts[0], parts[0])
        session.reset()
        session.process_data(read_wav(path), eos=True)
        txt = session.get_best_path_txt()
        tot_frames += session.num_frames_decoded
        print(f"{utt} {txt}")
        if ali["v"]:
            for word, b, e in session.get_word_alignment():
                print(f"{utt} ali {word} {b:.3f} {e:.3f}")
        if utt in refs:
            wer += score_pair(refs[utt], txt.split())
    elapsed = time.monotonic() - t0
    # ref kaldi-my-decoder.cc:113-116
    print(f"decode elapsed {elapsed:.2f}s, frames {tot_frames}, "
          f"real-time factor assuming 100 frames/sec is "
          f"{elapsed * 100.0 / max(tot_frames, 1):.4f}", file=sys.stderr)
    if refs:
        print(f"%WER {100.0 * wer.wer:.2f} [ {wer.errors} / {wer.ref_len}, "
              f"{wer.ins} ins, {wer.dels} del, {wer.subs} sub ]",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
