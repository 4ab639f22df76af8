"""Batched log-mel filterbank (FBANK) frontend.

Capability parity with the reference's streaming FBANK frontend — the
closed-source HTK-config extractor behind ``FeatureExtractor``
(ref: src/nnet/FeatureExtractor.h:14-87 with conf src/nnet/fbanks.cfg:
25 ms window / 10 ms shift / 40 chans / hamming / dither 0.1) and the Kaldi
fbank used by the v1/v2 pipelines (ref: src/v1-asrbin/conf/fbank.80.conf,
Kaldi OnlineNnet2FeaturePipeline) — re-designed for the device: the whole
batch of waveforms becomes one framing gather + window multiply + rFFT + one
[bins × fft] matmul, jit/vmap/pjit-compatible.

Includes the streaming chunked wrapper (sample carry across calls — the
``ExtractFeat``/``ExtractFeat_Last`` contract) and exponential-forgetting
live CMVN (ref fbanks.cfg NORMVAR*/LiveCMN options).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from asr_decoder_tpu.utils.config import ConfigOptions, flag


@dataclass
class FbankConfig:
    sample_rate: int = flag(16000, "Waveform sample rate")
    frame_length_ms: float = flag(25.0, "Window length (ms)")
    frame_shift_ms: float = flag(10.0, "Frame shift (ms)")
    num_bins: int = flag(40, "Number of mel channels")
    low_freq: float = flag(20.0, "Lowest mel-bank frequency")
    high_freq: float = flag(0.0, "Highest frequency (<=0: nyquist+offset)")
    preemphasis: float = flag(0.97, "Pre-emphasis coefficient")
    dither: float = flag(0.0, "Dither amplitude (0 = deterministic)")
    remove_dc: bool = flag(True, "Subtract per-frame mean")
    window_type: str = flag("povey", "povey|hamming|hanning|rectangular")
    use_power: bool = flag(True, "Power spectrum (else magnitude)")
    use_log: bool = flag(True, "Log of mel energies")
    snip_edges: bool = flag(True, "Only emit fully-contained frames")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.window_size:
            n *= 2
        return n


def _window_fn(cfg: FbankConfig) -> np.ndarray:
    M = cfg.window_size
    a = 2 * np.pi / (M - 1)
    i = np.arange(M)
    if cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(M)
    else:
        raise ValueError(f"unknown window {cfg.window_type!r}")
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Kaldi-style triangular mel filterbank matrix [num_bins, fft//2+1]."""
    nfft = cfg.fft_size
    nyquist = cfg.sample_rate / 2
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_lo = mel_scale(cfg.low_freq)
    mel_hi = mel_scale(high)
    delta = (mel_hi - mel_lo) / (cfg.num_bins + 1)
    fft_freqs = np.arange(nfft // 2 + 1) * (cfg.sample_rate / nfft)
    mel_freqs = mel_scale(fft_freqs)
    banks = np.zeros((cfg.num_bins, nfft // 2 + 1), np.float32)
    for b in range(cfg.num_bins):
        left = mel_lo + b * delta
        center = mel_lo + (b + 1) * delta
        right = mel_lo + (b + 2) * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def num_frames(cfg: FbankConfig, num_samples: int) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.window_size:
            return 0
        return 1 + (num_samples - cfg.window_size) // cfg.window_shift
    return (num_samples + cfg.window_shift // 2) // cfg.window_shift


def compute_fbank(cfg: FbankConfig, wave, dither_key=None):
    """wave f32[B, N] (16-bit PCM scale) → features f32[B, T, num_bins].

    Pure and jittable; the mel matrix and window are numpy constants closed
    over per config.
    """
    wave = jnp.asarray(wave, jnp.float32)
    B, N = wave.shape
    T = num_frames(cfg, N)
    if T <= 0:
        return jnp.zeros((B, 0, cfg.num_bins), jnp.float32)
    win = cfg.window_size
    idx = (jnp.arange(T)[:, None] * cfg.window_shift
           + jnp.arange(win)[None, :])
    frames = wave[:, idx]                                    # [B,T,win]
    if cfg.dither > 0 and dither_key is not None:
        frames = frames + cfg.dither * jax.random.normal(
            dither_key, frames.shape)
    if cfg.remove_dc:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    if cfg.preemphasis > 0:
        first = frames[..., :1] * (1.0 - cfg.preemphasis)
        rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
        frames = jnp.concatenate([first, rest], axis=-1)
    frames = frames * jnp.asarray(_window_fn(cfg))
    spec = jnp.fft.rfft(frames, n=cfg.fft_size, axis=-1)
    power = jnp.square(spec.real) + jnp.square(spec.imag)
    if not cfg.use_power:
        power = jnp.sqrt(power)
    mel = jnp.einsum("btf,mf->btm", power, jnp.asarray(mel_banks(cfg)),
                     preferred_element_type=jnp.float32)
    if cfg.use_log:
        mel = jnp.log(jnp.maximum(mel, 1.1921e-7))  # FLT_EPSILON floor
    return mel


class StreamingFbank:
    """Chunked waveform → features with sample carry across calls.

    The ``ExtractFeat`` / ``ExtractFeat_Last`` contract of the reference
    frontend (ref: src/nnet/FeatureExtractor.h:58-80): chunk boundaries must
    not change the features (stream-vs-offline equivalence).
    """

    def __init__(self, cfg: FbankConfig, batch: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        """ref: FeatureExtractor::Reset — call per utterance."""
        self._carry = np.zeros((self.batch, 0), np.float32)

    def accept(self, wave: np.ndarray, end: bool = False) -> jnp.ndarray:
        """wave f32[B, n] chunk; returns the newly ready frames [B, t, M]."""
        cfg = self.cfg
        wave = np.concatenate([self._carry, np.asarray(wave, np.float32)],
                              axis=1)
        if end:
            feats = compute_fbank(cfg, wave)
            self._carry = np.zeros((self.batch, 0), np.float32)
            return feats
        T = num_frames(cfg, wave.shape[1])
        if T <= 0:
            self._carry = wave
            return jnp.zeros((self.batch, 0, cfg.num_bins), jnp.float32)
        consumed = T * cfg.window_shift
        usable = (T - 1) * cfg.window_shift + cfg.window_size
        feats = compute_fbank(cfg, wave[:, :usable])
        self._carry = wave[:, consumed:]
        return feats


@dataclass
class CmvnConfig:
    """Live mean/variance normalization — capability parity with the
    LiveCMN / NORMVAR options of the reference frontend config
    (ref: src/nnet/fbanks.cfg NORMVAR/NORMVARFLOOR/NORMVARFORGETTINGFACTOR)."""
    norm_mean: bool = flag(True, "Subtract running mean")
    norm_var: bool = flag(False, "Divide by running stddev")
    forgetting_factor: float = flag(0.992, "Exponential forgetting factor")
    var_floor: float = flag(1e-4, "Variance floor")

    def register(self, opts: ConfigOptions, prefix: str = "") -> None:
        opts.register_dataclass(self, prefix)


def live_cmvn(cfg: CmvnConfig, feats, state=None):
    """Exponential-forgetting streaming CMVN.

    feats f32[B,T,D]; state = (mean [B,D], var [B,D]) or None to boot from
    the first frame.  Returns (normalized, new_state); jittable (scan).
    """
    B, T, D = feats.shape
    if state is None:
        state = (feats[:, 0], jnp.ones((B, D), jnp.float32))
    rho = cfg.forgetting_factor

    def step(carry, x):
        mean, var = carry
        mean = rho * mean + (1 - rho) * x
        var = rho * var + (1 - rho) * jnp.square(x - mean)
        y = x
        if cfg.norm_mean:
            y = y - mean
        if cfg.norm_var:
            y = y / jnp.sqrt(jnp.maximum(var, cfg.var_floor))
        return (mean, var), y

    (mean, var), ys = jax.lax.scan(step, state, jnp.swapaxes(feats, 0, 1))
    return jnp.swapaxes(ys, 0, 1), (mean, var)


def utterance_cmvn(feats, norm_var: bool = False, eps: float = 1e-4):
    """Whole-utterance CMVN (offline; Kaldi apply-cmvn equivalent)."""
    mean = jnp.mean(feats, axis=1, keepdims=True)
    out = feats - mean
    if norm_var:
        std = jnp.sqrt(jnp.maximum(
            jnp.mean(jnp.square(out), axis=1, keepdims=True), eps))
        out = out / std
    return out
