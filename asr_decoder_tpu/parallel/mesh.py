"""Device mesh + sharding utilities.

The device re-expression of the reference's parallelism inventory
(SURVEY §2.10): request-level data parallelism (thread pool, ref:
src/service2/thread-pool.h) becomes utterance-batch data parallelism over
the ``dp`` mesh axis; the GPU dynamic batcher's device-level batching (ref:
src/gpu-asr) becomes the same batch axis; model sharding (absent in the
reference — CPU-sized nnets) is the ``tp`` axis over wide projections for
large AMs.  The mesh is a plain (dp × tp) grid: every card of a host reaches
every other at the same rate, so its shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from asr_decoder_tpu.models.layers import Layer


def make_mesh(devices=None, tp: int = 1) -> Mesh:
    """(dp × tp) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    assert n % tp == 0, (n, tp)
    arr = np.array(devices).reshape(n // tp, tp)
    return Mesh(arr, ("dp", "tp"))


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Batch-leading arrays sharded over dp, replicated over tp."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _layer_param_spec(layer: Layer, name: str) -> P:
    """Tensor-parallel layout for AM weights.

    Output-projection style sharding: affine/linear weights are [out, in] —
    shard the output rows over tp (the classic vocab/projection split);
    matching bias sharded the same way.  Recurrent weights stay replicated
    (their hidden dims carry sequential dependencies; sharding them would put
    collectives inside the time scan).
    """
    if layer.kind in ("affine", "linear") and name == "weight":
        return P("tp", None)
    if layer.kind == "affine" and name == "bias":
        return P("tp")
    return P()


def shard_model(mesh: Mesh, layers: list[Layer]) -> list[Layer]:
    """Place a Layer list onto the mesh with dp-replicated / tp-split params."""
    out = []
    for layer in layers:
        params = {
            k: jax.device_put(v, NamedSharding(
                mesh, _layer_param_spec(layer, k)))
            for k, v in layer.params.items()
        }
        out.append(Layer(params, layer.kind, layer.input_dim,
                         layer.output_dim, layer.meta))
    return out


def shard_batch(mesh: Mesh, *arrays):
    """Put batch-leading arrays with dp sharding."""
    outs = tuple(
        jax.device_put(a, data_sharding(mesh, np.ndim(a))) for a in arrays)
    return outs if len(outs) > 1 else outs[0]
