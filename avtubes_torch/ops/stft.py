"""Fused log-spectrogram: the CUDA kernel, its plain version, the wrapper.

Replaces the TPU kernel `_stft_kernel` of `avtubes/ops/stft.py` (launched
by `_log_spectrogram_pallas`, entry `log_spectrogram_fused`).  The kernel
is `csrc/stft.cu`, written by hand for sm_90a and bound through `ctypes`:
it frames the waveform itself (no framed copy), removes each frame's mean,
takes the window-folded real DFT with IEEE float32 FMAs, and writes
log((re^2 + im^2) * scale + offset) / std as (B, F, T).  It reads int16 PCM
directly, applying `as_float_waveform`'s 1/32768 on load.

The function is bound by bytes on this card (one read of the waveform, one
write of the spectrogram); this kernel takes the dense DFT
(4*B*T*nperseg*F float32 FLOPs on the CUDA cores) and is bound by those
operations instead, far from the function's bound.  See the note at the
head of `csrc/stft.cu`.

`log_spectrogram_fused` takes the plain version only for a tensor that
lies on the CPU.  For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avtubes_torch.data.spectrogram import (
    SpectrogramConfig,
    _dft_matrices,
    _onesided_scale,
    as_float_waveform,
    frame_signal,
)


@functools.lru_cache(maxsize=16)
def _constants(cfg: SpectrogramConfig, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 (cos, sin, scale) of `cfg` on `device`; read-only, shared."""
    cosm, sinm = _dft_matrices(cfg)
    mk = lambda a: torch.tensor(a, dtype=torch.float32, device=device).contiguous()
    return mk(cosm), mk(sinm), mk(_onesided_scale(cfg))


def log_spectrogram_plain(x: torch.Tensor,
                          cfg: SpectrogramConfig = SpectrogramConfig()
                          ) -> torch.Tensor:
    """Plain PyTorch version: (..., num_samples) -> (..., F, T) float32.

    The same arithmetic as the kernel, as tensor operations: strided framing
    view, constant detrend, two float32 products against the cos/sin
    matrices, PSD scale, log, normalise, transpose.  On the card the
    products are IEEE float32 only while
    `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).  The CPU tests use it and the kernel
    is held against it on the card; it is no yardstick of speed.
    """
    x = as_float_waveform(x)
    cosm, sinm, scale = _constants(cfg, x.device)
    frames = frame_signal(x, cfg)                          # (..., T, nperseg)
    frames = frames - frames.mean(dim=-1, keepdim=True)    # constant detrend
    re = frames @ cosm                                     # (..., T, F)
    im = frames @ sinm
    power = (re * re + im * im) * scale
    spec = torch.log(power + cfg.log_offset) / cfg.normalize_std
    return spec.transpose(-1, -2).contiguous()             # (..., F, T)


def _bind():
    from avtubes_torch.ops._build import load_library

    fn = load_library("stft").avt_log_spectrogram
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def log_spectrogram_cuda(x: torch.Tensor,
                         cfg: SpectrogramConfig = SpectrogramConfig()
                         ) -> torch.Tensor:
    """Launch the CUDA kernel: (B, num_samples) float32 or int16 PCM on the
    card -> (B, F, T) float32.  Launches on the current stream and does not
    synchronise.  Raises on anything the kernel does not take and on a
    refused launch; it never takes another implementation."""
    if not x.is_cuda:
        raise ValueError(f"log_spectrogram_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"waveform must be float32 or int16 PCM, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"expected (B, num_samples), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("waveform must be contiguous")
    b, n = x.shape
    t, f = cfg.num_frames, cfg.num_freqs
    if t < 1 or n < (t - 1) * cfg.hop + cfg.nperseg:
        raise ValueError(f"waveform length {n} too short for {t} frames of "
                         f"{cfg.nperseg} at hop {cfg.hop}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    cosm, sinm, scale = _constants(cfg, x.device)
    out = torch.empty((b, f, t), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    fn = _bind()
    err = fn(x.data_ptr(), int(x.dtype == torch.int16), cosm.data_ptr(),
             sinm.data_ptr(), scale.data_ptr(), out.data_ptr(), b, n,
             cfg.nperseg, cfg.hop, t, f, cfg.log_offset, cfg.normalize_std,
             x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"avt_log_spectrogram launch failed: CUDA error {err}")
    log_spectrogram_cuda.launches += 1
    return out


#: launches of the CUDA kernel by this process (a plain int; the smoke
#: script sets it to 0 before the served requests and reads it after)
log_spectrogram_cuda.launches = 0


def log_spectrogram_fused(x: torch.Tensor,
                          cfg: SpectrogramConfig = SpectrogramConfig(),
                          impl: str = "kernel") -> torch.Tensor:
    """(..., num_samples) waveform -> (..., F, T) log-spectrogram.

    impl='kernel': the CUDA kernel when `x` is on the card (or an error),
    the plain version only because `x` lies on the CPU.  impl='plain': the
    plain version wherever `x` lies."""
    if impl == "plain" or (impl == "kernel" and not x.is_cuda):
        return log_spectrogram_plain(x, cfg)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    lead = x.shape[:-1]
    out = log_spectrogram_cuda(x.reshape(-1, x.shape[-1]).contiguous(), cfg)
    return out.reshape(*lead, *cfg.shape)
