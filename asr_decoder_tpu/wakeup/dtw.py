"""Keyword wakeup by posterior-sequence DTW.

Capability parity with the reference wakeup module — DTW alignment of the
AM's per-frame keyword-state posteriors against a keyword state template
(ref: src/wakeup/dtw.h:30 ``DtwAlign``) and the streaming search wrapper with
per-window wake judgement (ref: src/wakeup/wakeup-search.h:23
``WakeupSearch::{InputDataOneFrame,ProcessData,JudgeWakeup}``).

Device-first: the DTW recurrence is a ``lax.scan`` over frames whose carry is
the whole DP column — each step is a vectorized 3-way min over template
states (and over a batch of keywords/windows), so the device does B×S work
per sequential step instead of the reference's scalar cell loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.utils.config import ConfigOptions, flag

INF = jnp.inf


@dataclass
class WakeupConfig:
    """ref: wakeup-search.h options."""
    window_frames: int = flag(100, "Sliding window length (frames)")
    window_shift: int = flag(20, "Wake re-judgement interval (frames)")
    wake_threshold: float = flag(
        0.55, "Mean per-frame template posterior to wake")
    min_frames: int = flag(30, "Shortest window worth judging")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


@partial(jax.jit, static_argnums=())
def dtw_align(cost: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched DTW over cost f32[B, T, S] (frame t vs template state s).

    Standard symmetric DTW with steps (t-1,s), (t-1,s-1), (t,s-1) expressed
    as a scan over frames; the (t,s-1) within-frame step is a monotonic
    prefix-min (associative scan) instead of a sequential state loop.
    Returns (total f32[B] = D[T-1,S-1], dp f32[B,T,S]).
    """
    B, T, S = cost.shape

    def step(prev, c):           # prev f32[B,S], c f32[B,S]
        diag = jnp.concatenate(
            [jnp.full((B, 1), INF), prev[:, :-1]], axis=1)
        base = jnp.minimum(prev, diag) + c
        # within-frame advance: d[s] = min(base[s], d[s-1] + c[s]) — a
        # prefix-min over base[k] + suffix-sums of c (log-depth cumsum/cummin)
        csum = jnp.cumsum(c, axis=1)
        shifted = base - csum
        run = jax.lax.cummin(shifted, axis=1)
        cur = run + csum
        return cur, cur

    # frame 0: D[0,s] = cumsum of costs along the template (only (t,s-1))
    d0 = jnp.cumsum(cost[:, 0], axis=1)
    if T == 1:
        return d0[:, -1], d0[:, None]
    _, rest = jax.lax.scan(step, d0, jnp.swapaxes(cost[:, 1:], 0, 1))
    dp = jnp.concatenate([d0[:, None], jnp.swapaxes(rest, 0, 1)], axis=1)
    return dp[:, -1, -1], dp


def keyword_cost(posteriors: jax.Array, template: np.ndarray) -> jax.Array:
    """cost[t, s] = −log p(state_s | frame_t) for a keyword's pdf-id
    template (ref: the wakeup template is a keyword state sequence)."""
    post = jnp.asarray(posteriors)
    tpl = jnp.asarray(np.asarray(template, np.int32))
    return -jnp.log(jnp.maximum(post[..., tpl], 1e-10))


class WakeupSearch:
    """Streaming keyword spotting (ref: wakeup-search.h:23).

    Feed per-frame AM posteriors; every ``window_shift`` frames the last
    ``window_frames`` are DTW-aligned against the keyword template and the
    confidence (mean matched posterior) is compared to the threshold.
    """

    def __init__(self, config: WakeupConfig, template: np.ndarray):
        self.config = config
        self.template = np.asarray(template, np.int32)
        self.reset()

    def reset(self) -> None:
        self._frames: list[np.ndarray] = []
        self._since_judge = 0
        self.woken = False
        self.confidence = 0.0
        self.wake_range: tuple[int, int] | None = None

    def input_frame(self, posterior: np.ndarray) -> bool:
        """One posterior row f32[V] (ref: InputDataOneFrame)."""
        self._frames.append(np.asarray(posterior, np.float32))
        self._since_judge += 1
        if (self._since_judge >= self.config.window_shift
                and len(self._frames) >= self.config.min_frames):
            self._since_judge = 0
            self._judge()
        return self.woken

    def process_data(self, posteriors: np.ndarray, end: bool = False) -> bool:
        """A chunk of posterior rows f32[T, V] (ref: ProcessData)."""
        for row in np.asarray(posteriors, np.float32):
            if self.input_frame(row):
                return True
        if end and self._frames and not self.woken:
            self._since_judge = 0
            self._judge()
        return self.woken

    def _judge(self) -> None:
        """ref: JudgeWakeup(start, end) — the keyword may begin anywhere in
        the window, so a batch of candidate start offsets is judged in ONE
        batched dtw_align call: for candidate start k, frames before k are
        masked to free-stay in template state 0 (cost 0) and BIG elsewhere,
        which reduces the DTW to the [k:] suffix; each total is normalized
        by its own worst-case path length."""
        BIG = 1e9
        W = self.config.window_frames
        window = np.stack(self._frames[-W:])
        base = len(self._frames) - len(window)
        T, S = len(window), len(self.template)
        starts = list(range(0, T - S + 1, max(1, self.config.window_shift)))
        if not starts:
            return
        cost = np.asarray(keyword_cost(window[None], self.template))[0]
        cands = np.broadcast_to(cost, (len(starts), T, S)).copy()
        for i, k in enumerate(starts):
            cands[i, :k, 0] = 0.0
            cands[i, :k, 1:] = BIG
        totals, _ = dtw_align(jnp.asarray(cands))
        lens = np.array([T - k + S - 1 for k in starts], np.float32)
        confs = np.exp(-np.asarray(totals) / lens)
        best = int(np.argmax(confs))
        conf = float(confs[best])
        if conf > self.confidence:
            self.confidence = conf
            self.wake_range = (base + starts[best], len(self._frames))
        if conf >= self.config.wake_threshold:
            self.woken = True
