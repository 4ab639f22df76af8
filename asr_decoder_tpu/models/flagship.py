"""Flagship streaming acoustic model + CTC training step.

The framework's headline model: a projected-LSTM streaming AM of the shape
the reference serves (ref AM zoo: src/nnet/nnet-component.h LSTM variants;
conf: 80-dim fbank, frame-subsampling-factor 3, ~2k pdfs —
src/v1-asrbin/conf/{fbank.80.conf,conf.txt}), built from this framework's
layer zoo and trained with CTC (the reference ships CTC decoding support,
ref: src/old-decoder CTC decoders).

Includes the multi-chip training step used by ``__graft_entry__.py``:
data-parallel over utterances (the device re-expression of the reference's
request-level thread pool parallelism, ref: src/service2/thread-pool.h) ×
tensor-parallel over the output projection.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from asr_decoder_tpu.models import layers as L
from asr_decoder_tpu.models.nnet import Nnet, am_forward


def make_flagship(key, feat_dim: int = 80, num_pdfs: int = 2048,
                  hidden: int = 1024, proj: int = 512,
                  num_layers: int = 3, context: int = 1) -> Nnet:
    ks = jax.random.split(key, num_layers + 3)
    offsets = list(range(-context, context + 1))
    spliced = feat_dim * len(offsets)
    layers = [L.make_splice(offsets, feat_dim),
              L.make_affine(ks[0], spliced, proj)]
    for i in range(num_layers):
        layers.append(L.make_lstm_projected(ks[1 + i], proj, hidden, proj))
    layers.append(L.make_affine(ks[num_layers + 1], proj, num_pdfs))
    layers.append(L.make_softmax(num_pdfs))
    counts = np.ones(num_pdfs)
    layers.append(L.make_prior(counts))
    return Nnet(layers)


def flagship_logits(layers, x, state):
    """Raw pre-softmax logits (training head)."""
    return am_forward(layers, x, state, do_softmax=False, do_log=False,
                      sub_prior=False)


def ctc_loss_fn(layers, x, labels, label_paddings, state):
    logits, _ = flagship_logits(layers, x, state)
    B, T, _ = logits.shape
    logit_paddings = jnp.zeros((B, T), jnp.float32)
    per_seq = optax.ctc_loss(logits, logit_paddings, labels, label_paddings)
    return jnp.mean(per_seq)


@partial(jax.jit, donate_argnums=(0,))
def ctc_train_step(layers, opt_state, x, labels, label_paddings, state,
                   lr: float = 1e-3):
    """One Adam CTC training step over the Layer pytree."""
    loss, grads = jax.value_and_grad(ctc_loss_fn)(
        layers, x, labels, label_paddings, state)
    tx = optax.adam(lr)
    updates, opt_state = tx.update(grads, opt_state, layers)
    layers = optax.apply_updates(layers, updates)
    return layers, opt_state, loss


def init_opt_state(layers, lr: float = 1e-3):
    return optax.adam(lr).init(layers)
