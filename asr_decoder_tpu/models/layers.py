"""Acoustic-model layer zoo as pure JAX functions over pytree params.

Capability parity with the reference component zoo
(ref: src/nnet/nnet-component.h:8-74, nnet-layer.h:12-268, lstm-layer.cc:34-89,
tf-lstm-layer.cc:34-97, lstm-projected-layer.{h,cc}, nnet-simple-recurrent.cc:91-137),
re-designed for the device: every layer maps [B, T, D] → [B, T, D'] with
recurrence expressed as ``jax.lax.scan`` over time (batched gemms for the
input projections computed for all frames at once — the same split the
reference uses, gemm X→GIFO then per-frame recurrence).

Streaming: recurrent layers carry explicit state pytrees (the reference's
``_buffer`` (c,h,m) kept across chunk calls, reset via ``ResetRnnBuffer``,
ref: src/nnet/nnet-nnet.h:178-188); here state is a value passed in/out so a
batch of independent streams is just a leading axis.

Weight conventions follow the reference binary format: Affine/Linear weights
are [out, in] row-major (y = x·Wᵀ + b); LSTM gate blocks are stacked in
G,I,F,O order; peepholes are diagonal (length-H vectors).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# component-type ids matching the reference binary format
# (ref: src/nnet/nnet-component.h:8-31)
KIND_IDS = {
    "affine": 0x0100,
    "linear": 0x0101,
    "lstm_projected": 0x0102,   # kLstmProjectedStreams
    "lstm": 0x0103,             # kLstm
    "lstm_cudnn": 0x0104,       # kLstmCudnn (read as plain lstm here)
    "sru": 0x0105,              # kSRU
    "tf_lstm": 0x0106,          # kTfLstm
    "softmax": 0x0107,
    "sigmoid": 0x0108,
    "splice": 0x010b,
    "add_shift": 0x010c,
    "rescale": 0x010d,
    "prior": 0x0600,
}
ID_KINDS = {v: k for k, v in KIND_IDS.items()}

RECURRENT_KINDS = ("lstm", "tf_lstm", "lstm_projected", "sru", "lstm_cudnn")


@jax.tree_util.register_dataclass
@dataclass
class Layer:
    params: dict[str, Any]
    kind: str = field(metadata=dict(static=True))
    input_dim: int = field(metadata=dict(static=True))
    output_dim: int = field(metadata=dict(static=True))
    meta: tuple = field(default=(), metadata=dict(static=True))

    @property
    def is_recurrent(self) -> bool:
        return self.kind in RECURRENT_KINDS


# ----------------------------------------------------------------------
# per-kind forward functions: (layer, x[B,T,D], state) -> (y, state')
# ----------------------------------------------------------------------

def _splice(layer: Layer, x, state):
    """Frame splicing with repeat-edge padding.

    The reference's Splice gathers context rows provided by the feature
    buffer, which pads by repeating the first/last frame
    (ref: nnet-layer.cc Splice::PropagateFnc + DnnFeat padding,
    src/nnet/nnet-feature-api.cc).  Offline we clamp gather indices, which
    is the identical computation.
    """
    offsets = layer.meta
    T = x.shape[1]
    idx = jnp.arange(T)[:, None] + jnp.asarray(offsets)[None, :]   # [T,n]
    idx = jnp.clip(idx, 0, T - 1)
    y = x[:, idx, :]                                               # [B,T,n,D]
    return y.reshape(x.shape[0], T, -1), state


def _add_shift(layer, x, state):
    return x + layer.params["shift"], state


def _rescale(layer, x, state):
    return x * layer.params["scale"], state


def _sigmoid(layer, x, state):
    return jax.nn.sigmoid(x), state


def _softmax(layer, x, state):
    return jax.nn.softmax(x, axis=-1), state


def _prior(layer, x, state):
    """out = in − log_prior (ref: Prior::PropagateFnc, nnet-layer.cc:25-31)."""
    return x - layer.params["log_priors"], state


def _affine(layer, x, state):
    p = layer.params
    y = jnp.einsum("btd,od->bto", x, p["weight"],
                   preferred_element_type=jnp.float32) + p["bias"]
    return y, state


def _linear(layer, x, state):
    y = jnp.einsum("btd,od->bto", x, layer.params["weight"],
                   preferred_element_type=jnp.float32)
    return y, state


def _lstm(layer: Layer, x, state):
    """Peephole LSTM, gate blocks in G,I,F,O order
    (ref: Lstm::PropagateFnc, lstm-layer.cc:34-89).  TfLstm is the same
    recurrence without peepholes (ref: tf-lstm-layer.cc:34-97)."""
    p = layer.params
    H = layer.output_dim
    use_phole = "phole_i" in p
    # input contribution for all frames at once (one big gemm)
    gifo_x = jnp.einsum("btd,rd->btr", x, p["w_gifo_x"],
                        preferred_element_type=jnp.float32) + p["bias"]

    def cell(carry, gx):
        c_prev, m_prev = carry
        g = gx + m_prev @ p["w_gifo_m"].T          # [B,4H]
        yg, yi, yf, yo = (g[:, :H], g[:, H:2 * H],
                          g[:, 2 * H:3 * H], g[:, 3 * H:])
        if use_phole:
            yi = yi + p["phole_i"] * c_prev
            yf = yf + p["phole_f"] * c_prev
        yi = jax.nn.sigmoid(yi)
        yf = jax.nn.sigmoid(yf)
        yg = jnp.tanh(yg)
        c = yi * yg + yf * c_prev
        if use_phole:
            yo = yo + p["phole_o"] * c
        yo = jax.nn.sigmoid(yo)
        m = yo * jnp.tanh(c)
        return (c, m), m

    (c, m), ys = jax.lax.scan(cell, (state["c"], state["m"]),
                              jnp.swapaxes(gifo_x, 0, 1))
    return jnp.swapaxes(ys, 0, 1), {"c": c, "m": m}


def _lstm_projected(layer: Layer, x, state):
    """Projected peephole LSTM (ref: lstm-projected-layer.{h,cc}):
    recurrence over the projected output r; y = m · W_rmᵀ."""
    p = layer.params
    H = p["w_r_m"].shape[1]
    gifo_x = jnp.einsum("btd,rd->btr", x, p["w_gifo_x"],
                        preferred_element_type=jnp.float32) + p["bias"]

    def cell(carry, gx):
        c_prev, r_prev = carry
        g = gx + r_prev @ p["w_gifo_r"].T
        yg, yi, yf, yo = (g[:, :H], g[:, H:2 * H],
                          g[:, 2 * H:3 * H], g[:, 3 * H:])
        yi = jax.nn.sigmoid(yi + p["phole_i"] * c_prev)
        yf = jax.nn.sigmoid(yf + p["phole_f"] * c_prev)
        yg = jnp.tanh(yg)
        c = yi * yg + yf * c_prev
        yo = jax.nn.sigmoid(yo + p["phole_o"] * c)
        m = yo * jnp.tanh(c)
        r = m @ p["w_r_m"].T
        return (c, r), r

    (c, r), ys = jax.lax.scan(cell, (state["c"], state["r"]),
                              jnp.swapaxes(gifo_x, 0, 1))
    return jnp.swapaxes(ys, 0, 1), {"c": c, "r": r}


def _sru(layer: Layer, x, state):
    """Simple Recurrent Unit (ref: SRUcell::PropagateFnc,
    nnet-simple-recurrent.cc:91-137): xfrh = x·Wᵀ in 4 blocks
    (x̃, f, r, ah); c = f·c₋₁ + (1−f)·x̃; h = r·c + (1−r)·ah."""
    p = layer.params
    H = layer.output_dim
    xfrh = jnp.einsum("btd,rd->btr", x, p["w_xfrh"],
                      preferred_element_type=jnp.float32)
    yx = xfrh[..., :H]
    yf = jax.nn.sigmoid(xfrh[..., H:2 * H] + p["bias_f"])
    yr = jax.nn.sigmoid(xfrh[..., 2 * H:3 * H] + p["bias_r"])
    yah = xfrh[..., 3 * H:]

    def cell(c_prev, ins):
        yx_t, yf_t = ins
        c = yf_t * c_prev + (1.0 - yf_t) * yx_t
        return c, c

    c, cs = jax.lax.scan(cell, state["c"],
                         (jnp.swapaxes(yx, 0, 1), jnp.swapaxes(yf, 0, 1)))
    cs = jnp.swapaxes(cs, 0, 1)
    h = yr * cs + (1.0 - yr) * yah
    return h, {"c": c}


_FORWARD = {
    "splice": _splice,
    "add_shift": _add_shift,
    "rescale": _rescale,
    "sigmoid": _sigmoid,
    "softmax": _softmax,
    "prior": _prior,
    "affine": _affine,
    "linear": _linear,
    "lstm": _lstm,
    "lstm_cudnn": _lstm,
    "tf_lstm": _lstm,
    "lstm_projected": _lstm_projected,
    "sru": _sru,
}


def layer_forward(layer: Layer, x, state):
    return _FORWARD[layer.kind](layer, x, state)


def init_layer_state(layer: Layer, batch: int, dtype=jnp.float32):
    """Zero streaming state (ref ResetRnnBuffer, nnet-nnet.cc:171-205)."""
    if layer.kind in ("lstm", "tf_lstm", "lstm_cudnn"):
        H = layer.output_dim
        return {"c": jnp.zeros((batch, H), dtype),
                "m": jnp.zeros((batch, H), dtype)}
    if layer.kind == "lstm_projected":
        H = layer.params["w_r_m"].shape[1]
        return {"c": jnp.zeros((batch, H), dtype),
                "r": jnp.zeros((batch, layer.output_dim), dtype)}
    if layer.kind == "sru":
        return {"c": jnp.zeros((batch, layer.output_dim), dtype)}
    return {}


# ----------------------------------------------------------------------
# constructors (random init, used for benchmarks and training)
# ----------------------------------------------------------------------

def make_splice(offsets: list[int], dim: int) -> Layer:
    return Layer({}, "splice", dim, dim * len(offsets),
                 meta=tuple(int(o) for o in offsets))


def make_affine(key, in_dim: int, out_dim: int, scale: float = 0.05) -> Layer:
    k1, _ = jax.random.split(key)
    return Layer({"weight": jax.random.normal(k1, (out_dim, in_dim)) * scale,
                  "bias": jnp.zeros((out_dim,))},
                 "affine", in_dim, out_dim)


def make_linear(key, in_dim: int, out_dim: int, scale: float = 0.05) -> Layer:
    return Layer({"weight": jax.random.normal(key, (out_dim, in_dim)) * scale},
                 "linear", in_dim, out_dim)


def make_lstm(key, in_dim: int, dim: int, peephole: bool = True,
              scale: float = 0.05) -> Layer:
    ks = jax.random.split(key, 5)
    p = {"w_gifo_x": jax.random.normal(ks[0], (4 * dim, in_dim)) * scale,
         "w_gifo_m": jax.random.normal(ks[1], (4 * dim, dim)) * scale,
         "bias": jnp.zeros((4 * dim,))}
    if peephole:
        p.update(phole_i=jax.random.normal(ks[2], (dim,)) * scale,
                 phole_f=jax.random.normal(ks[3], (dim,)) * scale,
                 phole_o=jax.random.normal(ks[4], (dim,)) * scale)
    return Layer(p, "lstm" if peephole else "tf_lstm", in_dim, dim)


def make_lstm_projected(key, in_dim: int, hidden: int, out_dim: int,
                        scale: float = 0.05) -> Layer:
    ks = jax.random.split(key, 6)
    p = {"w_gifo_x": jax.random.normal(ks[0], (4 * hidden, in_dim)) * scale,
         "w_gifo_r": jax.random.normal(ks[1], (4 * hidden, out_dim)) * scale,
         "bias": jnp.zeros((4 * hidden,)),
         "phole_i": jax.random.normal(ks[2], (hidden,)) * scale,
         "phole_f": jax.random.normal(ks[3], (hidden,)) * scale,
         "phole_o": jax.random.normal(ks[4], (hidden,)) * scale,
         "w_r_m": jax.random.normal(ks[5], (out_dim, hidden)) * scale}
    return Layer(p, "lstm_projected", in_dim, out_dim)


def make_sru(key, in_dim: int, dim: int, scale: float = 0.05) -> Layer:
    return Layer({"w_xfrh": jax.random.normal(key, (4 * dim, in_dim)) * scale,
                  "bias_f": jnp.zeros((dim,)),
                  "bias_r": jnp.zeros((dim,))},
                 "sru", in_dim, dim)


def make_softmax(dim: int) -> Layer:
    return Layer({}, "softmax", dim, dim)


def make_sigmoid(dim: int) -> Layer:
    return Layer({}, "sigmoid", dim, dim)


def make_prior(counts: np.ndarray) -> Layer:
    """From raw state counts, as the reference computes it
    (ref: Prior::ReadData, nnet-layer.h:119-131)."""
    counts = np.asarray(counts, np.float64)
    priors = counts / counts.sum() + 1e-20
    return Layer({"log_priors": jnp.asarray(np.log(priors), jnp.float32)},
                 "prior", len(counts), len(counts))


def make_add_shift(shift) -> Layer:
    shift = jnp.asarray(shift, jnp.float32)
    return Layer({"shift": shift}, "add_shift", shift.shape[-1],
                 shift.shape[-1])


def make_rescale(scale) -> Layer:
    scale = jnp.asarray(scale, jnp.float32)
    return Layer({"scale": scale}, "rescale", scale.shape[-1],
                 scale.shape[-1])
