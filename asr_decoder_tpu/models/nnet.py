"""Acoustic model container + posterior pipeline (the decodable).

Capability parity with the reference ``Nnet``/``NnetForward``
(ref: src/nnet/nnet-nnet.h:17-308, nnet-nnet.cc): ordered layer stack, the
reference's raw binary model format (``u32 nlayer`` then per layer
``i32 in, i32 out, i32 type`` + raw float blobs, ref: nnet-nnet.cc:15-35,
nnet-component.cc:66-101), and the posterior post-processing —
softmax→(CTC-blank scale/saturate)→log→(−log prior), acoustic scale and frame
subsampling (ref: NnetForward::FeedForward nnet-nnet.cc:120-168 and
NnetForwardOptions nnet-nnet.h:63-87).

Device-first: ``am_forward`` is a pure function [B,T,D] → [B,T',V] of a Layer
pytree, jit/vmap/pjit-compatible, with explicit streaming state.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.models.layers import (ID_KINDS, KIND_IDS, Layer,
                                           init_layer_state, layer_forward)
from asr_decoder_tpu.utils.config import ConfigOptions, flag

# log-prob above which a CTC blank frame is skippable
# (ref: SkipBlockFrame threshold 20, nnet-nnet.h:265-275; saturation constant
#  2.71828e30 whose log ≈ 70, nnet-nnet.cc:149)
BLANK_SATURATE = 2.71828e30
BLANK_SKIP_LOGPROB = 20.0


@dataclass
class AmConfig:
    """ref: NnetForwardOptions (nnet-nnet.h:63-87)."""
    skip: int = flag(0, "Frame-subsampling factor minus one (skip frames)")
    skip_copy: bool = flag(False, "Copy scores to skipped frames so the "
                                  "search still walks every input frame "
                                  "(ref _skip score copy, nnet-nnet.cc:"
                                  "93-116); False drops skipped frames")
    do_log: bool = flag(True, "Transform NN output by log()")
    sub_prior: bool = flag(True, "Subtract log prior (last layer must be Prior)")
    do_softmax: bool = flag(True, "Apply the final softmax layer")
    block_scale: float = flag(1.0, "CTC blank posterior scale")
    skip_block: float = flag(1.0, "Saturate blank posteriors above this")
    acoustic_scale: float = flag(1.0, "Scaling factor for acoustic likelihoods")
    block_pdf_pdfid: int = flag(-1, "CTC blank output row; -1 = no blank")
    skip_blank_frames: bool = flag(
        False, "CTC blank-skip: frames whose blank logprob exceeds the "
               "skip threshold are masked out of the search (tokens carry "
               "unchanged) — the best-path fast path of the reference's "
               "SkipBlockFrame (ref nnet-nnet.h:265-275); lattice output "
               "is unavailable in this mode")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


class Nnet:
    """Ordered layer stack + model IO."""

    def __init__(self, layers: list[Layer]):
        self.layers = layers

    @property
    def input_dim(self) -> int:
        return self.layers[0].input_dim if self.layers else 0

    @property
    def output_dim(self) -> int:
        return self.layers[-1].output_dim if self.layers else 0

    def context(self) -> tuple[int, int]:
        """(left, right) context of the first splice layer
        (ref: NnetForward::GetLRoffset, nnet-nnet.cc:73-88)."""
        for l in self.layers:
            if l.kind == "splice":
                return -min(l.meta), max(l.meta)
        return 0, 0

    def init_state(self, batch: int):
        return [init_layer_state(l, batch) for l in self.layers]

    # ------------------------------------------------------------------
    # reference raw-binary model format
    # ------------------------------------------------------------------
    @staticmethod
    def read_binary(path: str) -> "Nnet":
        layers: list[Layer] = []
        with open(path, "rb") as f:
            (nlayer,) = struct.unpack("<I", f.read(4))
            while True:
                hdr = f.read(12)
                if len(hdr) < 12:
                    break
                din, dout, typ = struct.unpack("<3i", hdr)
                kind = ID_KINDS.get(typ)
                if kind is None:
                    raise IOError(f"unknown component type 0x{typ:x}")
                layers.append(_read_layer_blob(f, kind, din, dout))
        if nlayer != len(layers):
            raise IOError(f"expected {nlayer} layers, read {len(layers)}")
        return Nnet(layers)

    def write_binary(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<I", len(self.layers)))
            for l in self.layers:
                f.write(struct.pack("<3i", l.input_dim, l.output_dim,
                                    KIND_IDS[l.kind]))
                _write_layer_blob(f, l)


def _f32(f, n) -> np.ndarray:
    a = np.fromfile(f, "<f4", n)
    if len(a) != n:
        raise IOError("truncated model blob")
    return a


def _read_layer_blob(f, kind: str, din: int, dout: int) -> Layer:
    j = lambda a, shape=None: jnp.asarray(
        a.reshape(shape) if shape else a, jnp.float32)
    if kind == "splice":
        n = dout // din
        offs = np.fromfile(f, "<i4", n)
        return Layer({}, "splice", din, dout, meta=tuple(int(o) for o in offs))
    if kind == "add_shift":
        return Layer({"shift": j(_f32(f, din))}, kind, din, dout)
    if kind == "rescale":
        return Layer({"scale": j(_f32(f, din))}, kind, din, dout)
    if kind == "prior":
        # raw-binary prior blob stores log priors directly
        # (ref: Prior::ReadData(FILE*), nnet-layer.h:105-117)
        return Layer({"log_priors": j(_f32(f, din))}, kind, din, dout)
    if kind == "affine":
        bias = _f32(f, dout)
        w = _f32(f, dout * din)
        return Layer({"weight": j(w, (dout, din)), "bias": j(bias)},
                     kind, din, dout)
    if kind == "linear":
        return Layer({"weight": j(_f32(f, dout * din), (dout, din))},
                     kind, din, dout)
    if kind in ("softmax", "sigmoid"):
        return Layer({}, kind, din, dout)
    if kind in ("lstm", "lstm_cudnn"):
        H = dout
        p = {"w_gifo_x": j(_f32(f, 4 * H * din), (4 * H, din)),
             "w_gifo_m": j(_f32(f, 4 * H * H), (4 * H, H)),
             "bias": j(_f32(f, 4 * H)),
             "phole_i": j(_f32(f, H)), "phole_f": j(_f32(f, H)),
             "phole_o": j(_f32(f, H))}
        return Layer(p, "lstm", din, dout)
    if kind == "tf_lstm":
        H = dout
        p = {"w_gifo_x": j(_f32(f, 4 * H * din), (4 * H, din)),
             "w_gifo_m": j(_f32(f, 4 * H * H), (4 * H, H)),
             "bias": j(_f32(f, 4 * H))}
        return Layer(p, "tf_lstm", din, dout)
    if kind == "lstm_projected":
        (H,) = struct.unpack("<i", f.read(4))
        p = {"w_gifo_x": j(_f32(f, 4 * H * din), (4 * H, din)),
             "w_gifo_r": j(_f32(f, 4 * H * dout), (4 * H, dout)),
             "bias": j(_f32(f, 4 * H)),
             "phole_i": j(_f32(f, H)), "phole_f": j(_f32(f, H)),
             "phole_o": j(_f32(f, H)),
             "w_r_m": j(_f32(f, dout * H), (dout, H))}
        return Layer(p, "lstm_projected", din, dout)
    if kind == "sru":
        p = {"w_xfrh": j(_f32(f, 4 * dout * din), (4 * dout, din)),
             "bias_f": j(_f32(f, dout)), "bias_r": j(_f32(f, dout))}
        return Layer(p, "sru", din, dout)
    raise IOError(f"no blob reader for {kind}")


def _write_layer_blob(f, l: Layer) -> None:
    w = lambda a: np.asarray(a, "<f4").tofile(f)
    if l.kind == "splice":
        np.asarray(l.meta, "<i4").tofile(f)
    elif l.kind == "add_shift":
        w(l.params["shift"])
    elif l.kind == "rescale":
        w(l.params["scale"])
    elif l.kind == "prior":
        w(l.params["log_priors"])
    elif l.kind == "affine":
        w(l.params["bias"])
        w(l.params["weight"])
    elif l.kind == "linear":
        w(l.params["weight"])
    elif l.kind in ("softmax", "sigmoid"):
        pass
    elif l.kind in ("lstm", "lstm_cudnn"):
        for k in ("w_gifo_x", "w_gifo_m", "bias",
                  "phole_i", "phole_f", "phole_o"):
            w(l.params[k])
    elif l.kind == "tf_lstm":
        for k in ("w_gifo_x", "w_gifo_m", "bias"):
            w(l.params[k])
    elif l.kind == "lstm_projected":
        H = l.params["w_r_m"].shape[1]
        f.write(struct.pack("<i", H))
        for k in ("w_gifo_x", "w_gifo_r", "bias",
                  "phole_i", "phole_f", "phole_o", "w_r_m"):
            w(l.params[k])
    elif l.kind == "sru":
        for k in ("w_xfrh", "bias_f", "bias_r"):
            w(l.params[k])
    else:
        raise IOError(f"no blob writer for {l.kind}")


# ----------------------------------------------------------------------
# the decodable: pure forward + posterior pipeline
# ----------------------------------------------------------------------

def _am_forward_impl(layers: list[Layer], x, state, *, do_softmax=True,
               do_log=True, sub_prior=True, block_pdf_pdfid=-1,
               block_scale=1.0, skip_block=1.0, skip=0, skip_copy=False):
    """x f32[B,T,D] → log-likelihood rows f32[B,T',V], with streaming state.

    Mirrors NnetForward::FeedForward (ref: nnet-nnet.cc:89-168): run layers
    (stopping before Prior; before Softmax too when do_softmax=False), blank
    scale/saturate, log, prior subtraction; frame subsampling runs the net
    on every (1+skip)-th input frame (ref: nnet-nnet.cc:93-116).  With
    ``skip_copy`` the computed rows are copied onto the skipped frames so
    T' == T and the search walks every frame (the reference's ``_skip``
    score-copy semantics — required for WER parity with reference confs);
    without it skipped frames are dropped (T' = ceil(T/(1+skip))).  Note
    acoustic_scale is NOT applied here (the search applies it, matching
    LogLikelihood ref: nnet-nnet.h:212-233).
    """
    T_in = x.shape[1]
    if skip:
        x = x[:, ::1 + skip]
    new_state = []
    for i, layer in enumerate(layers):
        if layer.kind == "prior":
            break
        if layer.kind == "softmax" and not do_softmax:
            break
        x, st = layer_forward(layer, x, state[i])
        new_state.append(st)
    new_state.extend(state[len(new_state):])
    if do_softmax and do_log:
        if block_pdf_pdfid >= 0:
            blank = x[..., block_pdf_pdfid] * block_scale
            blank = jnp.where(blank / (block_scale + 1e-8) > skip_block,
                              BLANK_SATURATE, blank)
            x = x.at[..., block_pdf_pdfid].set(blank)
        x = jnp.log(x)
        if sub_prior:
            last = layers[-1]
            if last.kind == "prior":
                x, _ = layer_forward(last, x, {})
    if skip and skip_copy:
        x = jnp.repeat(x, 1 + skip, axis=1)[:, :T_in]
    return x, new_state


def am_forward(layers, x, state, **kw):
    """Scoped wrapper over the AM forward (xprof scope "am/forward");
    see ``_am_forward_impl`` for semantics."""
    with jax.named_scope("am/forward"):
        return _am_forward_impl(layers, x, state, **kw)


def blank_frame_mask(loglikes, block_pdf_pdfid: int,
                     acoustic_scale: float = 1.0):
    """True where the frame is a skippable CTC blank.  The reference compares
    LogLikelihood(frame, blank), which includes the acoustic scale
    (ref: SkipBlockFrame, nnet-nnet.h:265-275; scale at nnet-nnet.h:231) —
    ``loglikes`` here are unscaled (the search applies the scale), so the
    scale is applied to the blank score before thresholding."""
    return (acoustic_scale * loglikes[..., block_pdf_pdfid]
            > BLANK_SKIP_LOGPROB)


def pack_nonblank_frames(loglikes, block_pdf_pdfid: int,
                         acoustic_scale: float = 1.0,
                         thresh: float | None = None):
    """Drop skippable blank-dominated frames and left-pack the rest.

    ``loglikes`` f32[B, T, V] → (packed f32[B, T', V], mask bool[B, T'])
    with T' = max per-utterance kept count — the batched analogue of the
    reference's SkipBlockFrame frame skipping (ref: nnet-nnet.h:265-275):
    skipped frames never reach the search at all, so decode cost scales
    with the non-blank frame count.  ``thresh`` overrides the default
    unnormalized-score threshold (use ≈ log(0.95) for log-softmax
    posteriors)."""
    import numpy as _np
    ll = _np.asarray(loglikes)
    cut = BLANK_SKIP_LOGPROB if thresh is None else thresh
    keep = ~(acoustic_scale * ll[..., block_pdf_pdfid] > cut)
    counts = keep.sum(axis=1)
    Tp = max(int(counts.max()), 1)
    B, T, V = ll.shape
    out = _np.zeros((B, Tp, V), ll.dtype)
    mask = _np.zeros((B, Tp), bool)
    for b in range(B):
        k = ll[b][keep[b]]
        out[b, :len(k)] = k
        mask[b, :len(k)] = True
    return out, mask
