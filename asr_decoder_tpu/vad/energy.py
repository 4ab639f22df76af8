"""Energy-based voice activity detection.

Capability parity with the reference ``EnergyVad``
(ref: src/vad/energy-vad.h:32-449) and the VadJudge smoothing family
(ref: src/online-vad/online-vad.h:28-345): per-frame energy (RMS or mean-abs)
→ 3-way threshold classification (0/1/2 at thresholds th1/th2) → dual
sliding-window hysteresis smoothing (small window for sil→audio with ratio
0.5, big window for audio→sil with ratio 0.8) → per-frame SIL/AUDIO decisions
→ compressed segments (``VadSeg``).

Device-first: energy + classification + window sums are batched array ops;
the hysteresis FSM is a ``lax.scan`` over frames, vmapped over the batch.
A streaming wrapper keeps the reference's caches (sample carry, left/right
context, window sums) across chunk calls with identical edge handling
(first frame replicated into left context, last frame into right lookahead).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.utils.config import ConfigOptions, flag

SIL, AUDIO = 0, 1


@dataclass
class EnergyVadConfig:
    sample_rate: int = flag(16000, "Waveform sample rate")
    frame_length_s: float = flag(0.025, "VAD frame length (s)")
    frame_shift_s: float = flag(0.010, "VAD frame shift (s)")
    sil2audio_ratio: float = flag(0.5, "Small-window ratio to enter AUDIO")
    audio2sil_ratio: float = flag(0.8, "Big-window ratio to leave AUDIO")
    left_frames: int = flag(5, "Left context frames (big window)")
    right_frames: int = flag(5, "Right lookahead frames")
    energy_threshold1: float = flag(32768 * 0.01, "Low energy threshold")
    energy_threshold2: float = flag(32768 * 0.1, "High energy threshold")
    cal_method: str = flag("sum_square_root", "sum_square_root|sum_abs")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def frame_length_samp(self) -> int:
        return int(self.sample_rate * self.frame_length_s)

    @property
    def frame_shift_samp(self) -> int:
        return int(self.sample_rate * self.frame_shift_s)

    @property
    def sil_left_frames(self) -> int:
        return int(self.left_frames * 0.5)


def frame_energy(cfg: EnergyVadConfig, wave):
    """wave f32[B,N] → per-frame energy f32[B,T]
    (ref: OneFrameEnergy, energy-vad.h:74-99)."""
    wave = jnp.asarray(wave, jnp.float32)
    L, S = cfg.frame_length_samp, cfg.frame_shift_samp
    N = wave.shape[1]
    T = (N - L + S) // S
    if T <= 0:
        return jnp.zeros((wave.shape[0], 0), jnp.float32)
    idx = jnp.arange(T)[:, None] * S + jnp.arange(L)[None, :]
    frames = wave[:, idx]
    if cfg.cal_method == "sum_abs":
        return jnp.mean(jnp.abs(frames), axis=-1)
    return jnp.sqrt(jnp.mean(jnp.square(frames), axis=-1))


def classify_energy(cfg: EnergyVadConfig, energy):
    """energy [B,T] → 3-way class [B,T] ∈ {0,1,2}
    (ref: JudgeFramesFromEnergy thresholds, energy-vad.h:133-139)."""
    return (jnp.where(energy >= cfg.energy_threshold1, 1, 0)
            + jnp.where(energy >= cfg.energy_threshold2, 1, 0)).astype(jnp.int32)


def smooth_judge(cfg: EnergyVadConfig, classes, init_flag=None):
    """Hysteresis smoothing (ref: energy-vad.h:158-223).

    classes i32[B,T] must already include the left/right context padding
    (replicated edges); output is [B, T - left - right] SIL/AUDIO decisions
    plus the final FSM flag [B] for streaming continuation.
    """
    L, R, SL = cfg.left_frames, cfg.right_frames, cfg.sil_left_frames
    big_n = L + R + 1
    small_n = SL + R + 1
    B, Tp = classes.shape
    T = Tp - L - R
    if T <= 0:
        empty = jnp.zeros((B, 0), jnp.int32)
        return empty, (init_flag if init_flag is not None
                       else jnp.zeros((B,), jnp.int32))
    cs = jnp.cumsum(classes, axis=1)
    zero = jnp.zeros((B, 1), cs.dtype)
    cs = jnp.concatenate([zero, cs], axis=1)        # cs[i] = sum of [0,i)
    # window ending at judged frame i (centered at i-R in padded coords):
    # big window = classes[i-big_n+1 .. i], small = classes[i-small_n+1 .. i]
    pos = jnp.arange(L + R, Tp)
    big_sum = cs[:, pos + 1] - cs[:, pos + 1 - big_n]
    small_sum = cs[:, pos + 1] - cs[:, pos + 1 - small_n]
    if init_flag is None:
        init_flag = jnp.zeros((B,), jnp.int32)

    def step(flag, sums):
        big, small = sums
        enter = small > small_n * cfg.sil2audio_ratio
        stay = big > big_n * (1.0 - cfg.audio2sil_ratio)
        new = jnp.where(flag == SIL,
                        jnp.where(enter, AUDIO, SIL),
                        jnp.where(stay, AUDIO, SIL))
        return new, new

    flag, decisions = jax.lax.scan(
        step, init_flag,
        (jnp.swapaxes(big_sum, 0, 1), jnp.swapaxes(small_sum, 0, 1)))
    return jnp.swapaxes(decisions, 0, 1), flag


def vad_segments(decisions: np.ndarray) -> list[tuple[int, int, int]]:
    """Per-frame decisions [T] → [(flag, beg, end)] runs
    (ref: CompressVadRes / VadSeg, energy-vad.h:232-268)."""
    decisions = np.asarray(decisions)
    segs: list[tuple[int, int, int]] = []
    if len(decisions) == 0:
        return segs
    beg = 0
    cur = int(decisions[0])
    for i in range(1, len(decisions)):
        d = int(decisions[i])
        if d != cur:
            segs.append((cur, beg, i))
            beg, cur = i, d
    segs.append((cur, beg, len(decisions)))
    return segs


def merge_short_sil(segs, min_sil_frames: int):
    """Merge AUDIO runs separated by short silences
    (ref: MergeSameAduio / min-sil-frames-interval,
    online-vad/online-vad.h:214-232)."""
    out: list[tuple[int, int, int]] = []
    for seg in segs:
        if (seg[0] == SIL and out and out[-1][0] == AUDIO
                and seg[2] - seg[1] < min_sil_frames):
            out.append(seg)  # provisionally keep; flip if audio follows
        else:
            out.append(seg)
    # second pass: flip short SIL between two AUDIO
    merged: list[tuple[int, int, int]] = []
    for i, seg in enumerate(out):
        if (seg[0] == SIL and 0 < i < len(out) - 1
                and out[i - 1][0] == AUDIO and out[i + 1][0] == AUDIO
                and seg[2] - seg[1] < min_sil_frames):
            seg = (AUDIO, seg[1], seg[2])
        if merged and merged[-1][0] == seg[0]:
            merged[-1] = (seg[0], merged[-1][1], seg[2])
        else:
            merged.append(seg)
    return merged


class EnergyVadStream:
    """Streaming energy VAD over waveform chunks (single stream or batch).

    Keeps the reference's caches: sample remainder, padded class history for
    window context, and the hysteresis flag (ref: energy-vad.h FramesEnergy
    data cache :103-125 and first/last-frame padding :137-156).
    """

    def __init__(self, cfg: EnergyVadConfig, batch: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.reset()

    def reset(self, keep_flag: bool = False) -> None:
        if not keep_flag:
            self._flag = jnp.zeros((self.batch,), jnp.int32)
        self._wave_cache = np.zeros((self.batch, 0), np.float32)
        self._class_cache = None  # padded classes not yet judged
        self.sil_frames = 0
        self.nosil_frames = 0

    def accept(self, wave: np.ndarray, end: bool = False) -> np.ndarray:
        cfg = self.cfg
        wave = np.concatenate(
            [self._wave_cache, np.asarray(wave, np.float32)], axis=1)
        L, S = cfg.frame_length_samp, cfg.frame_shift_samp
        T = max(0, (wave.shape[1] - L + S) // S)
        if T > 0:
            energy = frame_energy(cfg, wave[:, :(T - 1) * S + L])
            cls = np.asarray(classify_energy(cfg, energy))
            self._wave_cache = wave[:, T * S:]
        else:
            cls = np.zeros((self.batch, 0), np.int32)
            self._wave_cache = wave
        if self._class_cache is None:
            if cls.shape[1] == 0 and not end:
                return np.zeros((self.batch, 0), np.int32)
            first = cls[:, :1] if cls.shape[1] else np.zeros(
                (self.batch, 1), np.int32)
            self._class_cache = np.repeat(first, cfg.left_frames + 1, axis=1)
            cls = cls[:, 1:]
        buf = np.concatenate([self._class_cache, cls], axis=1)
        if end and buf.shape[1] > 0:
            last = buf[:, -1:]
            buf = np.concatenate(
                [buf, np.repeat(last, cfg.right_frames, axis=1)], axis=1)
        decisions, self._flag = smooth_judge(cfg, jnp.asarray(buf),
                                             self._flag)
        decisions = np.asarray(decisions)
        n = decisions.shape[1]
        self._class_cache = buf[:, n:] if not end else None
        self.nosil_frames += int(decisions.sum())
        self.sil_frames += int(decisions.size - decisions.sum())
        return decisions
