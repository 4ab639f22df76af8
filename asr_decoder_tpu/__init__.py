"""asr_decoder_tpu — a batched streaming speech-recognition decoding framework.

A ground-up JAX/XLA re-design of the capabilities of the reference
C++ online ASR decoder (datemoon/ASR-decoder): feature extraction, VAD,
acoustic-model forward, WFST frame-synchronous beam search with lattice
generation, lattice post-processing (determinize / n-best / rescoring),
big-LM on-the-fly rescoring, and a streaming serving runtime.

Layering (mirrors reference layers L0..L8, see SURVEY.md):
  utils/     - config, logging, timing                (ref: src/util)
  fst/       - CSR WFST + lattice kernel              (ref: src/newfst)
  frontend/  - fbank / pitch feature frontend         (ref: src/nnet feat, src/pitch)
  models/    - acoustic model runtime                 (ref: src/nnet, src/hmm)
  ops/       - XLA device search + gathers            (ref: src/my-decoder hot loops)
  decoder/   - beam-search sessions, offline+online   (ref: src/my-decoder, src/kaldi-nnet3)
  lm/        - ARPA LM, diff-LM, rescoring            (ref: src/newlm, src/biglm)
  vad/       - energy + model VAD, smoothing          (ref: src/vad, src/online-vad)
  parallel/  - mesh / sharding utilities              (ref: thread-pool data parallelism)
  serving/   - wire protocol + async TCP server       (ref: src/service2)
"""

__version__ = "0.1.0"
