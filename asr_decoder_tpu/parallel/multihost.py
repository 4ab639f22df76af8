"""Multi-host serving skeleton (BASELINE config 5: pod-slice serving).

The reference scales serving with one pthread pool per CPU node behind an
external balancer (ref: src/service2/thread-pool.h:33, --nthread=60..800,
src/v2-asrbin/conf/v2-conf.txt); a multi-host deployment re-expresses
that as one process per host, each owning the host's cards.

Architecture (and why it needs no cross-host collectives for dp serving):
``parallel/decode.py``'s dp decode is zero-collective SPMD — the graph is
replicated and every utterance lives on exactly one chip — so a pod slice
serves as N *independent* per-host arenas: each host runs its own
``AsrServer`` + ``BatchedStreamingDecoder`` over a host-local (dp × tp)
mesh and its own TCP ingress port, with client traffic spread by any L4
balancer.  ``jax.distributed`` initialization is only required when a
*global* jit program spans hosts — i.e. a tp-sharded AM too large for one
host's chips — in which case ``global_mesh`` builds the cross-host mesh
(AM weights tp-split, batch dp-split across hosts) and every host must
enter the same jit computation per tick.

Host-loss behavior: with per-host arenas (the default), losing a host
loses only that host's in-flight channels — the balancer redirects new
streams to surviving hosts, and reconnecting clients resend from their
last unacknowledged chunk (the protocol is chunk-acknowledged: every C2S
package gets an S2C reply).  With a cross-host global mesh, a lost host
stalls the collective and the slice must be restarted (the standard
jax.distributed failure model) — which is why serving defaults to
per-host isolation and reserves the global mesh for oversized AMs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import numpy as np

from asr_decoder_tpu.parallel.mesh import make_mesh


@dataclass
class MultihostContext:
    """Process-level topology handle."""
    num_processes: int
    process_id: int
    coordinator: str | None

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int = 1,
                   process_id: int = 0) -> MultihostContext:
    """Initialize the cross-host runtime.

    Single-process (num_processes == 1, the per-host-arena default) is a
    no-op; otherwise ``jax.distributed.initialize`` connects this process
    to the coordinator so ``jax.devices()`` spans the slice.
    """
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return MultihostContext(num_processes=num_processes,
                            process_id=process_id,
                            coordinator=coordinator_address)


def local_serving_mesh(tp: int = 1):
    """Per-host (dp × tp) mesh over this process's local devices — the
    default serving topology (independent arena per host)."""
    return make_mesh(jax.local_devices(), tp=tp)


def global_mesh(ctx: MultihostContext, tp: int = 1):
    """Cross-host (dp × tp) mesh over every device in the slice — only for
    jit programs that must span hosts (oversized tp-sharded AMs).  ``ctx``
    must describe the initialized runtime: the mesh is only meaningful when
    every process of the slice has joined via ``init_multihost``."""
    if ctx.num_processes > 1:
        assert jax.process_count() == ctx.num_processes, (
            f"jax.distributed not initialized for {ctx.num_processes} "
            f"processes (process_count={jax.process_count()}); call "
            "init_multihost with the coordinator address first")
    return make_mesh(jax.devices(), tp=tp)


def run_distributed_selftest(num_processes: int = 2,
                             timeout: float = 480.0) -> list[str]:
    """Spawn ``num_processes`` REAL OS processes that each call
    ``jax.distributed.initialize`` against a local coordinator, build the
    cross-host ``global_mesh``, and verify tp-sharded AM parity on their
    addressable shards (see ``_mh_worker``).  Returns the worker OK lines;
    raises on any worker failure.  Exercises the one code path
    single-process simulation cannot (BASELINE config 5).

    This is the repo's only launcher of several JAX processes.  Its workers
    pin themselves to the CPU backend (``_mh_worker``), so they never
    compete for a card: a JAX process reserves most of a GPU's memory when
    it first touches it, so each card keeps one process."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""        # workers set their own device count
    procs = [subprocess.Popen(
        [sys.executable, "-m", "asr_decoder_tpu.parallel._mh_worker",
         coord, str(num_processes), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(num_processes)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    oks = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        ok = [ln for ln in out.splitlines() if ln.startswith("MH_OK")]
        if p.returncode != 0 or not ok:
            raise RuntimeError(
                f"distributed worker {i} failed (rc={p.returncode}):\n"
                + out[-2000:])
        oks.append(ok[0])
    return oks


def partition_hosts(devices, n_hosts: int) -> list[list]:
    """Split a device list into equal per-host groups.  Used to *simulate*
    a pod slice on one process (tests / dryrun): each group plays the role
    of one host's local devices."""
    n = len(devices)
    assert n % n_hosts == 0, (n, n_hosts)
    per = n // n_hosts
    return [list(devices[i * per:(i + 1) * per]) for i in range(n_hosts)]


def simulated_host_arenas(info_factory, n_hosts: int, num_channels: int,
                          tp: int = 1) -> list:
    """Build ``n_hosts`` independent serving arenas, each over its own
    device group — the per-host-arena topology exercised on a single
    process (mocking the host count; real deployment runs one process per
    host with ``local_serving_mesh``)."""
    from asr_decoder_tpu.serving.batcher import BatchedStreamingDecoder
    groups = partition_hosts(jax.devices(), n_hosts)
    arenas = []
    for g in groups:
        mesh = make_mesh(np.array(g), tp=tp)
        arenas.append(BatchedStreamingDecoder(info_factory(), num_channels,
                                              mesh=mesh))
    return arenas
