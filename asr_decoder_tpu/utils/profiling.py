"""Profiler integration: xprof/Perfetto traces + named scopes.

The reference's tracing is wall-clock timers around decode calls
(ref: src/util/util-time.h:8-23, src/v1-asr/v1-asr-task.h:117,188); the
device build adds what SURVEY §5 calls for — device-level traces with named
scopes visible in xprof/Perfetto.  ``scope(name)`` annotates jitted code
(shows up per-op in the trace); ``trace(dir)`` captures a trace around any
block (host + device timelines), viewable with xprof / tensorboard-profile.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax


def scope(name: str):
    """Named scope for jitted code — ops traced under it carry the name in
    xprof (usable as decorator context: ``with scope("search.emit"): ...``)."""
    return jax.named_scope(name)


@contextmanager
def trace(log_dir: str | None):
    """Capture a JAX profiler trace into ``log_dir`` (no-op if None/empty).

    Usage: ``with trace("/tmp/xprof"): run_decode()`` then inspect with
    xprof or tensorboard's profile plugin."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def annotate(name: str):
    """Host-side trace annotation (shows as a span on the host timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield
