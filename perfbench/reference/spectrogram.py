"""The log-spectrogram, plain: log(scipy.signal.spectrogram(x, sr,
nperseg, noverlap) + 1e-7) / 12, as a dense real DFT in float32.

scipy's defaults: a periodic Tukey(0.25) window, each segment's mean
removed before the window, PSD density scaling 1 / (fs * sum(win^2)), one
sided with every bin but DC and Nyquist doubled.  For 10 s at 22.05 kHz,
nperseg 512 and noverlap 1 the output is (257, 431).
"""

from __future__ import annotations

import numpy as np
import torch


def tukey_periodic(nperseg: int, alpha: float = 0.25) -> np.ndarray:
    """scipy.signal.get_window(('tukey', alpha), nperseg): the symmetric
    window of nperseg + 1 points without its last."""
    npts = nperseg + 1
    n = np.arange(npts, dtype=np.float64)
    edge = alpha * (npts - 1) / 2.0
    w = np.ones(npts)
    left = n < edge
    w[left] = 0.5 * (1 + np.cos(np.pi * (n[left] / edge - 1)))
    right = n > (npts - 1) - edge
    w[right] = 0.5 * (1 + np.cos(np.pi * ((n[right] - (npts - 1) + edge) / edge)))
    return w[:nperseg]


def geometry(samplerate: int, seconds: int, nperseg: int, noverlap: int) -> dict:
    """Samples, hop, frames and frequency bins of one waveform."""
    hop = nperseg - noverlap
    num_samples = samplerate * seconds
    return {"num_samples": num_samples, "hop": hop, "nperseg": nperseg,
            "num_frames": (num_samples - nperseg) // hop + 1, "num_freqs": nperseg // 2 + 1}


def log_spectrogram(x: torch.Tensor, samplerate: int, seconds: int, nperseg: int,
                    noverlap: int, tukey_alpha: float = 0.25, log_offset: float = 1e-7,
                    normalize_std: float = 12.0) -> torch.Tensor:
    """(B, num_samples) float32 waveforms, or int16 PCM scaled by 1/32768
    -> (B, F, T) float32."""
    g = geometry(samplerate, seconds, nperseg, noverlap)
    x = x.to(torch.float32) * (1.0 / 32768.0) if not x.dtype.is_floating_point \
        else x.to(torch.float32)
    n = np.arange(nperseg, dtype=np.float64)[:, None]
    k = np.arange(g["num_freqs"], dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nperseg
    win = tukey_periodic(nperseg, tukey_alpha)
    cosm = torch.tensor(np.cos(ang) * win[:, None], dtype=torch.float32, device=x.device)
    sinm = torch.tensor(-np.sin(ang) * win[:, None], dtype=torch.float32, device=x.device)
    scale = np.full(g["num_freqs"], 2.0 / (samplerate * float(np.sum(win * win))))
    scale[0] /= 2.0
    if nperseg % 2 == 0:
        scale[-1] /= 2.0
    scale_t = torch.tensor(scale, dtype=torch.float32, device=x.device)
    frames = x.unfold(-1, nperseg, g["hop"])[..., : g["num_frames"], :]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    re = frames @ cosm
    im = frames @ sinm
    power = (re * re + im * im) * scale_t
    return (torch.log(power + log_offset) / normalize_std).transpose(-1, -2).contiguous()
