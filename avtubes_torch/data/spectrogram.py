"""Log-spectrogram front end, scipy parity, PyTorch.

Counterpart of `avtubes/data/spectrogram.py`.  The function computed is

    _, _, S = scipy.signal.spectrogram(x, sr, nperseg=512, noverlap=1)
    spec = log(S + 1e-7) / 12

With scipy defaults that means: tukey(0.25) *periodic* window, per-segment
constant detrend (mean removal), hop = nperseg - noverlap = 511, PSD
density scaling 1/(fs * sum(win^2)), one-sided with non-DC/non-Nyquist
bins doubled.  For 22.05 kHz x 10 s input the output is (257, 431).

The numpy half (config, window, DFT matrices, PSD scale, quantizers, the
audio transports and the two host references) is the port's own copy: the
port imports nothing from the JAX package.  The torch half is the batched
`log_spectrogram`, which dispatches on static shape and dtype between the
transports and hands waveforms to `avtubes_torch.ops.stft` — the
hand-written CUDA kernel for a tensor on the card, its plain PyTorch
version for a tensor on the CPU.  The real DFT stays in IEEE float32 on
both: TF32 or bf16 inputs cost about 1e-2 absolute in the log-spectrogram.

The log-mel front end (`mel_filterbank`, `log_mel_spectrogram`) is opt-in
and on no main path: the linear PSD power (`_power_spectrum`, which the
plain log-spectrogram shares) times an HTK-scale, Slaney-normalized
filterbank, then the same log and scale.  In the JAX package it is an XLA
matmul at HIGHEST precision, not a Pallas kernel, so here it is a library
matmul in IEEE float32 (the caller keeps TF32 off, as for the plain
log-spectrogram).  K1 emits the log of the
power, not the power, so it does not serve this function.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def tukey_periodic(nperseg: int, alpha: float = 0.25) -> np.ndarray:
    """Periodic Tukey window == scipy.signal.get_window(('tukey', a), M)."""
    npts = nperseg + 1  # periodic = symmetric(M+1) minus last point
    n = np.arange(npts, dtype=np.float64)
    edge = alpha * (npts - 1) / 2.0
    w = np.ones(npts)
    left = n < edge
    w[left] = 0.5 * (1 + np.cos(np.pi * (n[left] / edge - 1)))
    right = n > (npts - 1) - edge
    w[right] = 0.5 * (1 + np.cos(np.pi * ((n[right] - (npts - 1) + edge) / edge)))
    return w[:nperseg]


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    samplerate: int = 22050
    seconds: int = 10
    nperseg: int = 512
    noverlap: int = 1
    tukey_alpha: float = 0.25
    log_offset: float = 1e-7
    normalize_std: float = 12.0

    @property
    def hop(self) -> int:
        return self.nperseg - self.noverlap

    @property
    def num_samples(self) -> int:
        return self.samplerate * self.seconds

    @property
    def num_frames(self) -> int:
        return (self.num_samples - self.nperseg) // self.hop + 1

    @property
    def num_freqs(self) -> int:
        return self.nperseg // 2 + 1

    @property
    def shape(self) -> tuple[int, int]:
        """(freq, time) like scipy's output."""
        return (self.num_freqs, self.num_frames)


def _dft_matrices(cfg: SpectrogramConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices of shape (nperseg, num_freqs), window folded in."""
    n = np.arange(cfg.nperseg, dtype=np.float64)[:, None]
    k = np.arange(cfg.num_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.nperseg
    win = tukey_periodic(cfg.nperseg, cfg.tukey_alpha)[:, None]
    return (np.cos(ang) * win), (-np.sin(ang) * win)


def _onesided_scale(cfg: SpectrogramConfig) -> np.ndarray:
    """PSD density scale per frequency bin, with one-sided doubling."""
    win = tukey_periodic(cfg.nperseg, cfg.tukey_alpha)
    scale = 1.0 / (cfg.samplerate * float(np.sum(win * win)))
    s = np.full(cfg.num_freqs, 2.0 * scale)
    s[0] = scale
    if cfg.nperseg % 2 == 0:
        s[-1] = scale  # Nyquist bin not doubled
    return s


def quantize_int16_waveform(wav: np.ndarray) -> np.ndarray:
    """Host-side int16 transport quantization — the exact inverse of
    `as_float_waveform`'s 1/32768 rescale (lossless round trip for floats
    that came from 16-bit PCM).  Keep the two in lockstep."""
    return np.clip(np.rint(wav * 32768.0), -32768, 32767).astype(np.int16)


#: fixed-point scale for int16 log-spectrogram transport.  The normalized
#: log-spectrogram is bounded in [log(1e-7)/12 ~ -1.3432, ~+2] (the lower
#: bound is exact — log_offset floors the power), so 16000 leaves 2x
#: headroom (32767/16000 = 2.048) and quantizes at 1/32000 ~ 3.1e-5
#: absolute — under the 2e-4 scipy-parity tolerance of the float32 path.
SPEC_INT16_SCALE = 16000.0


def quantize_int16_spectrogram(spec: np.ndarray) -> np.ndarray:
    """Host-side int16 transport quantization of a normalized log-spectrogram
    (inverse applied by `log_spectrogram`'s passthrough branch)."""
    return np.clip(np.rint(spec * SPEC_INT16_SCALE),
                   -32768, 32767).astype(np.int16)


#: fixed-point scale for the opt-in int8 log-spectrogram transport: the same
#: [-2.048, +2.048] range as the int16 transport (127/62 = 2.048) at
#: 1/124 ~ 8.1e-3 absolute quantization.  That is NOT parity-grade; it
#: exists for thin client->server links and must be validated per
#: deployment.
SPEC_INT8_SCALE = 62.0


def quantize_int8_spectrogram(spec: np.ndarray) -> np.ndarray:
    """Host-side int8 transport quantization of a normalized log-spectrogram
    (inverse applied by `log_spectrogram`'s passthrough branch)."""
    return np.clip(np.rint(spec * SPEC_INT8_SCALE), -128, 127).astype(np.int8)


def spec_int16_to_int8(spec16: np.ndarray) -> np.ndarray:
    """Requantize an int16-transport spectrogram to the int8 transport."""
    return np.clip(np.rint(spec16.astype(np.float32)
                           * (SPEC_INT8_SCALE / SPEC_INT16_SCALE)),
                   -128, 127).astype(np.int8)


#: the audio transport family: how a waveform crosses the host->device (or
#: client->server) boundary.  `log_spectrogram`'s static shape/dtype
#: dispatch decodes every one of them, so any consumer accepts any member.
AUDIO_TRANSPORTS = ("float32", "int16", "spec_int16", "spec_int8")


def audio_payload_spec(transport: str, cfg: SpectrogramConfig
                       ) -> tuple[tuple[int, ...], np.dtype]:
    """Per-sample (shape, dtype) of a transport's wire payload."""
    if transport == "float32":
        return (cfg.num_samples,), np.dtype(np.float32)
    if transport == "int16":
        return (cfg.num_samples,), np.dtype(np.int16)
    if transport == "spec_int16":
        return cfg.shape, np.dtype(np.int16)
    if transport == "spec_int8":
        return cfg.shape, np.dtype(np.int8)
    raise ValueError(f"unknown audio transport {transport!r}; "
                     f"expected one of {AUDIO_TRANSPORTS}")


def prepare_audio_payload(waves: np.ndarray, transport: str,
                          cfg: SpectrogramConfig) -> np.ndarray:
    """Host-side encode of (n, num_samples) float waveforms into a
    transport's wire payload (the batched counterpart of the training
    pipeline's `_finalize_waveform`).  The spec transports compute the host
    log-spectrogram per row: the native C++ STFT where it is available, the
    float32 numpy path otherwise; `log_spectrogram`'s passthrough branch is
    the decoder for every output."""
    waves = np.ascontiguousarray(np.asarray(waves), dtype=np.float32)
    if waves.ndim != 2 or waves.shape[1] != cfg.num_samples:
        raise ValueError(f"expected (n, {cfg.num_samples}) float waveforms, "
                         f"got {waves.shape}")
    if transport == "float32":
        return waves
    if transport == "int16":
        return quantize_int16_waveform(waves)
    if transport not in ("spec_int16", "spec_int8"):
        raise ValueError(f"unknown audio transport {transport!r}; "
                         f"expected one of {AUDIO_TRANSPORTS}")
    from avtubes_torch import native

    rows = []
    for w in waves:
        out = native.log_spectrogram_i16(w, cfg.samplerate, cfg.nperseg, cfg.noverlap,
                                         cfg.num_freqs, cfg.num_frames)
        rows.append(out if out is not None
                    else quantize_int16_spectrogram(log_spectrogram_np_f32(w, cfg)))
    spec16 = np.stack(rows)
    return spec_int16_to_int8(spec16) if transport == "spec_int8" else spec16


def log_spectrogram_np_f32(x: np.ndarray,
                           cfg: SpectrogramConfig = SpectrogramConfig()) -> np.ndarray:
    """Float32 HOST log-spectrogram: stride-trick framing (zero-copy),
    pocketfft rfft, float32 elementwise tail.  Agrees with
    `log_spectrogram_np` to ~2e-7 — used by the 'spec_*' audio transports,
    where the host ships the (F, T) spectrogram instead of the waveform."""
    fcount, nperseg, hop = cfg.num_frames, cfg.nperseg, cfg.hop
    x = np.ascontiguousarray(x, np.float32)
    needed = (fcount - 1) * hop + nperseg
    if x.shape[-1] < needed:
        # as_strided would silently read past the buffer — a short waveform
        # is a caller bug (prepare to cfg.num_samples first)
        raise ValueError(
            f"waveform length {x.shape[-1]} < {needed} required for "
            f"{fcount} frames; prepare to cfg.num_samples first")
    frames = np.lib.stride_tricks.as_strided(
        x, (fcount, nperseg), (x.strides[0] * hop, x.strides[0]))
    frames = frames - frames.mean(axis=-1, keepdims=True, dtype=np.float32)
    win = tukey_periodic(nperseg, cfg.tukey_alpha).astype(np.float32)
    spec = np.fft.rfft(frames * win, nperseg, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    power *= _onesided_scale(cfg).astype(np.float32)
    out = np.log(power + np.float32(cfg.log_offset)) / np.float32(cfg.normalize_std)
    return np.ascontiguousarray(out.T)


def log_spectrogram_np(x: np.ndarray, cfg: SpectrogramConfig = SpectrogramConfig()) -> np.ndarray:
    """Float64 numpy reference (bit-comparable to scipy; used in tests/tools)."""
    fcount, nperseg, hop = cfg.num_frames, cfg.nperseg, cfg.hop
    idx = np.arange(fcount)[:, None] * hop + np.arange(nperseg)[None, :]
    frames = x[idx].astype(np.float64)
    frames = frames - frames.mean(axis=-1, keepdims=True)
    win = tukey_periodic(cfg.nperseg, cfg.tukey_alpha)
    spec = np.fft.rfft(frames * win, cfg.nperseg, axis=-1)
    power = np.abs(spec) ** 2
    power *= _onesided_scale(cfg)
    return (np.log(power + cfg.log_offset) / cfg.normalize_std).T


# ------------------------------------------------------------------ torch

def as_float_waveform(x: torch.Tensor) -> torch.Tensor:
    """Accept int16 PCM transport: integer inputs are scaled by 1/32768 —
    the exact inverse of `quantize_int16_waveform` (and of the WAV reader's
    PCM16 normalization, so the round trip is lossless for 16-bit sources).
    Shipping waveforms as int16 halves the host-to-device bytes."""
    if not x.dtype.is_floating_point:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x.to(torch.float32)


def frame_signal(x: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(..., num_samples) -> (..., num_frames, nperseg), any hop.

    A strided *view* (`Tensor.unfold`): no framed copy is made here.  (The
    JAX package builds the same frames with a stride-(nperseg-1) reshape
    because XLA has no strided views; the CUDA kernel does not call this at
    all — it computes each frame's offset itself.)"""
    return x.unfold(-1, cfg.nperseg, cfg.hop)[..., : cfg.num_frames, :]


@functools.lru_cache(maxsize=16)
def _dft_constants(cfg: SpectrogramConfig, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 (cos, sin, PSD scale) of `cfg` on `device`; read-only, shared."""
    cosm, sinm = _dft_matrices(cfg)
    mk = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
    return mk(cosm), mk(sinm), mk(_onesided_scale(cfg))


def _power_spectrum(x: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """(..., num_samples) waveform -> one-sided PSD power (..., T, F) float32.

    Framing (a strided view), constant detrend, two float32 products against
    the window-folded cos/sin matrices, PSD density scale: scipy's S before
    the log.  The products are IEEE float32 only while TF32 is off for
    matmuls (PyTorch's default, and every CLI's)."""
    x = as_float_waveform(x)
    cosm, sinm, scale = _dft_constants(cfg, x.device)
    frames = frame_signal(x, cfg)                          # (..., T, nperseg)
    frames = frames - frames.mean(dim=-1, keepdim=True)    # constant detrend
    re = frames @ cosm                                     # (..., T, F)
    im = frames @ sinm
    return (re * re + im * im) * scale


def mel_filterbank(cfg: SpectrogramConfig, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(num_freqs, n_mels) float64 triangular mel filterbank: HTK mel scale
    (2595 log10(1 + f/700)), area-normalized (Slaney) triangles.  The JAX
    package's numpy function, copied."""
    fmax = fmax if fmax is not None else cfg.samplerate / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    freqs = np.linspace(0, cfg.samplerate / 2.0, cfg.num_freqs)
    fb = np.zeros((cfg.num_freqs, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-12)
        down = (hi - freqs) / max(hi - ctr, 1e-12)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] *= 2.0 / max(hi - lo, 1e-12)  # Slaney area norm
    return fb


@functools.lru_cache(maxsize=16)
def _mel_constants(cfg: SpectrogramConfig, n_mels: int, device: torch.device) -> torch.Tensor:
    """`mel_filterbank(cfg, n_mels)` as float32 on `device`; read-only, shared."""
    return torch.tensor(mel_filterbank(cfg, n_mels), dtype=torch.float32, device=device)


def log_mel_spectrogram(x: torch.Tensor, cfg: SpectrogramConfig = SpectrogramConfig(),
                        n_mels: int = 128) -> torch.Tensor:
    """Batched log-mel spectrogram: (..., num_samples) -> (..., n_mels, T)
    float32: the linear PSD power, `power @ mel_filterbank`, log(. + 1e-7) / 12.
    On the card the products are IEEE float32 only while
    `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default;
    `core/device.py::disable_tf32` in every CLI)."""
    mel = _power_spectrum(x, cfg) @ _mel_constants(cfg, n_mels, x.device)
    spec = torch.log(mel + cfg.log_offset) / cfg.normalize_std
    return spec.transpose(-1, -2).contiguous()             # (..., M, T)


def log_spectrogram(x: torch.Tensor,
                    cfg: SpectrogramConfig = SpectrogramConfig(),
                    impl: str = "kernel") -> torch.Tensor:
    """Batched log-spectrogram: (..., num_samples) -> (..., F, T) float32.

    Output matches log(scipy spectrogram + 1e-7) / 12 in float32.

    Transport-aware: when `x` already has the (F, T) spectrogram shape it is
    a host-computed payload ('spec_int16' / 'spec_int8') — int8 inputs are
    dequantized by 1/SPEC_INT8_SCALE, other integers by 1/SPEC_INT16_SCALE,
    floats pass through.  The branch is on static shape and dtype, so every
    call site works with any transport unchanged.

    impl: 'kernel' — the CUDA kernel for a tensor on the card, the plain
    version for a tensor on the CPU; 'plain' — the plain PyTorch version
    wherever the tensor lies (what the kernel is held against).
    """
    if x.ndim >= 2 and tuple(x.shape[-2:]) == cfg.shape:
        if x.dtype == torch.int8:
            return x.to(torch.float32) * (1.0 / SPEC_INT8_SCALE)
        if not x.dtype.is_floating_point:
            return x.to(torch.float32) * (1.0 / SPEC_INT16_SCALE)
        return x.to(torch.float32)
    from avtubes_torch.ops.stft import log_spectrogram_fused

    return log_spectrogram_fused(x, cfg, impl=impl)
