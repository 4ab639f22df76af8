"""Pitch frontend: NCCF + Viterbi pitch tracking + POV post-processing.

Capability parity with the reference's Kaldi-pitch port — NCCF extraction and
online Viterbi pitch tracking (ref: src/pitch/pitch-functions.cc:1229-1272
``OnlinePitchFeature``), POV/normalization/delta post-processing
(ref: ``OnlineProcessPitch`` pitch-functions.h:314, conf
src/nnet/online_pitch.conf), the streaming wrapper (ref: ``StreamPitch``
pitch-functions.h:432-520) and the resampler (ref: ``LinearResample``
src/pitch/resample.h:124).

Device-first: the resampler is one strided convolution; NCCF for all
(frame, lag) pairs is one batched einsum; the per-frame Viterbi recurrence is
a ``lax.scan`` whose step is a vectorized min-plus product over the lag
transition matrix — no scalar loops anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.utils.config import ConfigOptions, flag


@dataclass
class PitchConfig:
    """ref: PitchExtractionOptions (pitch-functions.h:23-100)."""
    sample_rate: int = flag(16000, "Input waveform sample rate")
    frame_shift_ms: float = flag(10.0, "Frame shift (ms)")
    frame_length_ms: float = flag(25.0, "NCCF window length (ms)")
    min_f0: float = flag(50.0, "Minimum F0 to search (Hz)")
    max_f0: float = flag(400.0, "Maximum F0 to search (Hz)")
    resample_freq: float = flag(4000.0, "Internal analysis sample rate")
    lowpass_cutoff: float = flag(1000.0, "Anti-alias lowpass cutoff (Hz)")
    lowpass_filter_width: int = flag(1, "Lowpass sinc half-width (periods)")
    soft_min_f0: float = flag(10.0, "Soft minimum F0 for ballast")
    penalty_factor: float = flag(0.1, "Transition cost on log-lag change")
    nccf_ballast: float = flag(7000.0, "NCCF ballast term")
    lag_bias: float = flag(
        0.01, "Short-lag preference per log-lag unit in the Viterbi local "
              "cost — octave-error guard (periodic signals tie NCCF at lag "
              "multiples; the reference resolves this via its ballast/lag "
              "selection, pitch-functions.cc SelectLags)")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def frames_shift(self) -> int:
        return int(self.resample_freq * self.frame_shift_ms / 1000)

    @property
    def window_size(self) -> int:
        return int(self.resample_freq * self.frame_length_ms / 1000)

    def lags(self) -> np.ndarray:
        lo = int(np.floor(self.resample_freq / self.max_f0))
        hi = int(np.ceil(self.resample_freq / self.min_f0))
        return np.arange(lo, hi + 1, dtype=np.int32)


@dataclass
class ProcessPitchConfig:
    """ref: ProcessPitchOptions (pitch-functions.h:193-260)."""
    pitch_scale: float = flag(2.0, "Scale on normalized log pitch")
    pov_scale: float = flag(2.0, "Scale on the POV feature")
    delta_pitch_scale: float = flag(10.0, "Scale on delta log pitch")
    normalization_left_context: int = flag(75, "CMN window left (frames)")
    normalization_right_context: int = flag(75, "CMN window right (frames)")
    delta_window: int = flag(2, "Delta regression half-window")
    add_pov_feature: bool = flag(True, "Emit the POV feature")
    add_normalized_log_pitch: bool = flag(True, "Emit normalized log pitch")
    add_delta_pitch: bool = flag(True, "Emit delta log pitch")
    add_raw_log_pitch: bool = flag(False, "Emit raw log pitch")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def dim(self) -> int:
        return (int(self.add_pov_feature)
                + int(self.add_normalized_log_pitch)
                + int(self.add_delta_pitch) + int(self.add_raw_log_pitch))


def resample_kernel(cfg: PitchConfig) -> tuple[np.ndarray, int]:
    """Windowed-sinc decimation kernel (ref: LinearResample's lowpass
    filter, resample.cc); returns (kernel f32[W], stride)."""
    stride = int(round(cfg.sample_rate / cfg.resample_freq))
    cutoff = cfg.lowpass_cutoff / cfg.sample_rate  # normalized
    half = int(np.ceil(cfg.lowpass_filter_width * cfg.sample_rate
                       / (2 * cfg.lowpass_cutoff)))
    n = np.arange(-half, half + 1)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * n)
    win = np.hanning(len(n) + 2)[1:-1]
    k = (sinc * win).astype(np.float32)
    return k / k.sum(), stride


def linear_resample(cfg: PitchConfig, wave: jax.Array) -> jax.Array:
    """wave f32[B, N] at sample_rate → f32[B, N'] at resample_freq:
    one strided conv (ref: LinearResample::Resample, resample.h:124)."""
    k, stride = resample_kernel(cfg)
    x = wave[:, None, :]                       # [B, C=1, N]
    kern = jnp.asarray(k)[None, None, :]       # [O=1, I=1, W]
    y = jax.lax.conv_general_dilated(
        x, kern, window_strides=(stride,), padding=[(len(k) // 2,) * 2])
    return y[:, 0, :]


def compute_nccf(cfg: PitchConfig, resampled: jax.Array) \
        -> tuple[jax.Array, jax.Array]:
    """NCCF for every (frame, lag): f32[B, T, L] twice — with the ballast
    (pitch-search variant) and without (POV variant)
    (ref: ComputeNccf / ballast handling, pitch-functions.cc)."""
    lags = cfg.lags()
    W, shift = cfg.window_size, cfg.frames_shift
    maxlag = int(lags[-1])
    B, N = resampled.shape
    T = max(0, (N - (W + maxlag)) // shift + 1)
    if T == 0:
        Z = jnp.zeros((B, 0, len(lags)), jnp.float32)
        return Z, Z
    starts = jnp.arange(T) * shift
    idx0 = starts[:, None] + jnp.arange(W)[None, :]
    x0 = resampled[:, idx0]                               # [B,T,W]
    x0 = x0 - jnp.mean(x0, axis=-1, keepdims=True)
    # shifted windows for every lag: gather [B,T,L,W]
    idx1 = idx0[:, None, :] + jnp.asarray(lags)[None, :, None]
    x1 = resampled[:, idx1]                               # [B,T,L,W]
    x1 = x1 - jnp.mean(x1, axis=-1, keepdims=True)
    cross = jnp.einsum("btw,btlw->btl", x0, x1)
    e0 = jnp.sum(x0 * x0, axis=-1)[..., None]             # [B,T,1]
    e1 = jnp.sum(x1 * x1, axis=-1)                        # [B,T,L]
    # ballast ~ (soft-min-f0 window energy)^2 guard (ref ballast term)
    mean_sq = (e0[..., 0] / W)
    ballast = (cfg.nccf_ballast * mean_sq * W) ** 0  # shape helper (ones)
    ballast = cfg.nccf_ballast * jnp.maximum(mean_sq, 1e-10)[..., None]
    denom_pitch = jnp.sqrt(e0 * e1 + ballast) + 1e-10
    denom_pov = jnp.sqrt(e0 * e1) + 1e-10
    return cross / denom_pitch, jnp.clip(cross / denom_pov, -1.0, 1.0)


@partial(jax.jit, static_argnums=(2,))
def _viterbi_track(local_cost: jax.Array, trans: jax.Array,
                   L: int) -> jax.Array:
    """Min-plus Viterbi over lag candidates: local_cost f32[B,T,L],
    trans f32[L,L]; returns best lag index per frame i32[B,T]
    (ref: the online Viterbi in pitch-functions.cc:1229-1272)."""
    B, T = local_cost.shape[:2]

    def step(carry, lc):        # carry f32[B,L]; lc f32[B,L]
        tot = carry[:, :, None] + trans[None]          # [B,Lprev,L]
        best_prev = jnp.argmin(tot, axis=1)            # [B,L]
        cur = jnp.min(tot, axis=1) + lc
        return cur, best_prev

    init = local_cost[:, 0]
    carry, backptrs = jax.lax.scan(
        step, init, jnp.swapaxes(local_cost[:, 1:], 0, 1))

    def back(carry, bp):        # walk backpointers in reverse
        idx = carry
        prev = jnp.take_along_axis(bp, idx[:, None], axis=1)[:, 0]
        return prev, idx

    last = jnp.argmin(carry, axis=1)                   # [B]
    first, rest = jax.lax.scan(back, last, backptrs, reverse=True)
    path = jnp.concatenate([first[:, None],
                            jnp.swapaxes(rest, 0, 1)], axis=1)
    return path


def compute_pitch(cfg: PitchConfig, wave) -> tuple[jax.Array, jax.Array]:
    """wave f32[B, N] → (pitch_hz f32[B,T], nccf_pov f32[B,T])
    (ref: ComputeKaldiPitch, pitch-functions.cc)."""
    wave = jnp.asarray(wave, jnp.float32)
    resampled = linear_resample(cfg, wave)
    nccf_pitch, nccf_pov = compute_nccf(cfg, resampled)
    lags = cfg.lags().astype(np.float32)
    L = len(lags)
    if nccf_pitch.shape[1] == 0:
        z = jnp.zeros(nccf_pitch.shape[:2], jnp.float32)
        return z, z
    loglag = np.log(lags)
    trans = (cfg.penalty_factor
             * (loglag[:, None] - loglag[None, :]) ** 2).astype(np.float32)
    local = (1.0 - nccf_pitch
             + cfg.lag_bias * jnp.asarray(loglag - loglag[0]))
    path = _viterbi_track(local, jnp.asarray(trans), L)
    pitch = cfg.resample_freq / jnp.asarray(lags)[path]
    pov_nccf = jnp.take_along_axis(nccf_pov, path[..., None], axis=2)[..., 0]
    return pitch, pov_nccf


def nccf_to_pov_feature(c: jax.Array) -> jax.Array:
    """ref: NccfToPovFeature (pitch-functions.cc): 2((1.0001−c)^0.15 − 1)."""
    return 2.0 * (jnp.power(1.0001 - c, 0.15) - 1.0)


def _sliding_mean(x: jax.Array, w: jax.Array, left: int, right: int):
    """Weighted sliding mean of x (weights w) with edge-clamped windows."""
    B, T = x.shape
    idx = jnp.clip(jnp.arange(T)[:, None]
                   + jnp.arange(-left, right + 1)[None, :], 0, T - 1)
    xs, ws = x[:, idx], w[:, idx]
    return jnp.sum(xs * ws, axis=-1) / jnp.maximum(
        jnp.sum(ws, axis=-1), 1e-10)


def process_pitch(pcfg: ProcessPitchConfig, pitch_hz: jax.Array,
                  nccf_pov: jax.Array) -> jax.Array:
    """(pitch, pov-NCCF) → feature rows f32[B, T, dim]
    (ref: OnlineProcessPitch, pitch-functions.h:314: POV feature,
    POV-weighted mean-normalized log pitch, delta log pitch)."""
    log_pitch = jnp.log(jnp.maximum(pitch_hz, 1e-10))
    # POV weight p(voiced) from NCCF (ref NccfToPov polynomial, approx.)
    c = jnp.clip(nccf_pov, -1.0, 1.0)
    pov_weight = jnp.clip(1.001 - 1.0 / (1.0 + jnp.exp(10.0 * c - 2.0)),
                          0.0, 1.0)
    cols = []
    if pcfg.add_pov_feature:
        cols.append(pcfg.pov_scale * nccf_to_pov_feature(c))
    if pcfg.add_normalized_log_pitch:
        mean = _sliding_mean(log_pitch, pov_weight,
                             pcfg.normalization_left_context,
                             pcfg.normalization_right_context)
        cols.append(pcfg.pitch_scale * (log_pitch - mean))
    if pcfg.add_delta_pitch:
        # regression delta over ±delta_window (Kaldi delta formula)
        D = pcfg.delta_window
        num = jnp.zeros_like(log_pitch)
        den = 0.0
        B, T = log_pitch.shape
        for d in range(1, D + 1):
            plus = log_pitch[:, jnp.clip(jnp.arange(T) + d, 0, T - 1)]
            minus = log_pitch[:, jnp.clip(jnp.arange(T) - d, 0, T - 1)]
            num = num + d * (plus - minus)
            den += 2 * d * d
        cols.append(pcfg.delta_pitch_scale * num / den)
    if pcfg.add_raw_log_pitch:
        cols.append(log_pitch)
    return jnp.stack(cols, axis=-1)


def compute_and_process_pitch(cfg: PitchConfig, pcfg: ProcessPitchConfig,
                              wave) -> jax.Array:
    """Offline one-call pipeline (ref: compute-and-process-kaldi-pitch-feats
    tool, src/pitch/compute-and-process-kaldi-pitch-feats.cc)."""
    pitch, pov = compute_pitch(cfg, wave)
    return process_pitch(pcfg, pitch, pov)


class StreamPitch:
    """Chunked streaming wrapper (ref: StreamPitch::ProcessWave,
    pitch-functions.h:432-520).  Keeps the waveform tail needed for frame
    context and re-emits only newly-complete frames; the tracking rerun over
    the kept context keeps stream ≈ offline (the reference recomputes with
    lookahead latency the same way)."""

    def __init__(self, cfg: PitchConfig, pcfg: ProcessPitchConfig,
                 batch: int = 1):
        self.cfg, self.pcfg = cfg, pcfg
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self._wave = np.zeros((self.batch, 0), np.float32)
        self._emitted = 0

    def process_wave(self, chunk: np.ndarray, end: bool = False) -> np.ndarray:
        self._wave = np.concatenate(
            [self._wave, np.asarray(chunk, np.float32)], axis=1)
        feats = np.asarray(compute_and_process_pitch(
            self.cfg, self.pcfg, self._wave))
        T = feats.shape[1]
        ready = T if end else self._emitted  # hold frames until EOS refines
        if not end:
            # frames older than the normalization right context are stable
            ready = max(self._emitted,
                        T - self.pcfg.normalization_right_context - 1)
        out = feats[:, self._emitted:ready]
        self._emitted = ready
        return out


def merge_features(fbank: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """Per-frame (fbank ‖ pitch) merge, truncating to the shorter stream
    (ref: DnnPitchFeat::MergeFeat, src/nnet/nnet-feature-pitch-api.cc)."""
    T = min(fbank.shape[-2], pitch.shape[-2])
    return np.concatenate([np.asarray(fbank)[..., :T, :],
                           np.asarray(pitch)[..., :T, :]], axis=-1)


class ArbitraryResample:
    """Resample a signal at arbitrary (possibly non-uniform) time points
    (ref: ArbitraryResample, src/pitch/resample.h:72-120 — used by the
    Kaldi pitch extractor to evaluate NCCF lags off the sample grid).

    ``sample_points``: output times in seconds.  Each output is a
    windowed-sinc (Hanning-windowed, ``num_zeros`` half-lobes) interpolation
    of the input at that time; evaluation is one dense [P, N] matmul so it
    is one gemm for batched inputs.
    """

    def __init__(self, num_samples_in: int, samp_rate_in: float,
                 filter_cutoff: float, sample_points, num_zeros: int = 4):
        assert 0 < filter_cutoff < samp_rate_in / 2
        self.num_samples_in = int(num_samples_in)
        pts = np.asarray(sample_points, np.float64)
        half_width = num_zeros / (2.0 * filter_cutoff)
        t_in = np.arange(num_samples_in) / samp_rate_in        # [N]
        delta = t_in[None, :] - pts[:, None]                   # [P, N]
        inside = np.abs(delta) < half_width
        x = np.where(inside, delta, 0.0)
        window = 0.5 * (1.0 + np.cos(np.pi * filter_cutoff / num_zeros
                                     * 2.0 * x))
        sinc = 2 * filter_cutoff * np.sinc(2 * filter_cutoff * x)
        self.weights = jnp.asarray(
            np.where(inside, window * sinc / samp_rate_in, 0.0), jnp.float32)

    def resample(self, wave) -> jax.Array:
        """f32[..., N] → f32[..., P] values at the sample points."""
        wave = jnp.asarray(wave, jnp.float32)
        return jnp.einsum("...n,pn->...p", wave, self.weights)
