"""Data-parallel decode over a device mesh.

Multi-chip serving (BASELINE config 5, SURVEY §2.10): the reference scales
request-level data parallelism with a pthread pool of independent decoder
instances (ref: src/service2/thread-pool.h:33, --nthread=60..800); the device
re-expression shards the *utterance batch axis* of the one jitted search
program over the ``dp`` mesh axis — graph tables replicated on every chip,
beam state / loglikes / frame logs dp-sharded — so XLA SPMD-partitions the
whole decode with zero cross-chip collectives (the search is embarrassingly
batch-parallel; only the AM would introduce collectives if tp-sharded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from asr_decoder_tpu.parallel.mesh import (data_sharding, replicated,
                                           shard_batch)


def shard_search(mesh: Mesh, search) -> None:
    """Replicate the search's device graph tables onto every mesh device
    (the read-only shared model state, ref: per-thread shared AM/graph in
    V1AsrSource, src/v1-asrbin/v1-asr-service.cc:91-102).  The BigLM
    variant's device n-gram LM tables replicate the same way."""
    for attr in ("graph", "pgraph"):
        g = getattr(search, attr, None)
        if g is not None:
            setattr(search, attr, type(g)(*(
                jax.device_put(a, replicated(mesh)) for a in g)))
    tabs = getattr(search, "_lm_tabs", None)
    if tabs is not None:
        search._lm_tabs = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, replicated(mesh)), tabs)


def shard_beam_state(mesh: Mesh, state):
    """dp-shard any batch-leading beam-state pytree (BeamState or the
    CLG/BigLM variants)."""
    return type(state)(*(
        jax.device_put(a, data_sharding(mesh, a.ndim)) for a in state))


def dp_decode(mesh: Mesh, search, loglikes, frame_mask=None):
    """Full-utterance batched decode, dp-sharded over the mesh.

    Same contract as ``TpuBeamSearch.decode`` (returns final BeamState,
    init FrameLog, frame FrameLogs — host traceback works unchanged); the
    utterance batch B must divide by the mesh's dp size.
    """
    loglikes = jnp.asarray(loglikes, jnp.float32)
    B = loglikes.shape[0]
    dp = mesh.shape["dp"]
    assert B % dp == 0, f"batch {B} not divisible by dp={dp}"
    shard_search(mesh, search)
    state, init_log = search.init_state(B)
    state = shard_beam_state(mesh, state)
    loglikes = shard_batch(mesh, loglikes)
    if frame_mask is None:
        frame_mask = jnp.ones(loglikes.shape[:2], bool)
    frame_mask = shard_batch(mesh, jnp.asarray(frame_mask))
    state, logs = search.advance(state, loglikes, frame_mask)
    return state, init_log, logs
