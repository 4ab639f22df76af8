"""The search's two random-access reads, as plain XLA gathers.

* ``batched_table_gather`` — ``out[b, n] = table[b, idx[b, n]]``: the
  acoustic-score lookup (one log-likelihood per arc candidate, ref
  LogLikelihood src/nnet/nnet-nnet.h:212-233) and the relax's per-row
  payload gathers.
* ``fetch_state_records`` — ``out[b, k] = records[state[b, k]]``: each beam
  token's whole state record (the reference's per-token ``ArcIterator``
  walk, ref: src/newfst/arc-iter.h:10-43) in one row gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def batched_table_gather(table, idx):
    """``out[b, n] = table[b, idx[b, n]]`` — table [B, V], idx i32[B, N]
    with values in [0, V)."""
    B, V = table.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (B, 1), 0) * V
    return table.reshape(-1)[row + idx]


def fetch_state_records(records, state):
    """Each token's state record: ``records`` i32[S, L], ``state``
    i32[B, K] → i32[B, K, L].  Dead slots (state < 0) read row 0; callers
    mask them by their own validity (``state != NO_STATE``)."""
    return records[jnp.maximum(state, 0)]
