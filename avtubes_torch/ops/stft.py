"""Fused log-spectrogram: the CUDA kernels, the plain version, the wrapper.

Replaces the TPU kernel `_stft_kernel` of `avtubes/ops/stft.py` (launched
by `_log_spectrogram_pallas`, entry `log_spectrogram_fused`).  The kernels
are in `csrc/stft.cu`, written by hand for sm_90a and bound through
`ctypes`.  Both frame the waveform themselves (no framed copy), remove each
frame's mean BEFORE the window, transform in IEEE float32, and write
log((re^2 + im^2) * scale + offset) / std as (B, F, T); both read int16 PCM
directly, applying `as_float_waveform`'s 1/32768 on load.

The function is bound by bytes on this card (one read of the waveform, one
write of the spectrogram; a real FFT is a few FLOPs per byte), so the
design is about launching little and storing coalesced, not arithmetic:

  * `nperseg` in `FFT_NPERSEG` (the serving shape, 512, among them): one
    warp per frame runs a real FFT — the frame packed as nperseg/2 complex
    values, radix-2 decimation in frequency with the first stages in
    registers and the last five across lanes by shuffles, the real-FFT split
    step, the epilogue — and a block of 16 or 32 frames stages its results
    in shared memory to store runs along t.  Twiddles and window come from
    tables made here on the host in float64 and rounded once (`fft_tables`).
  * any other `nperseg`: the dense real DFT against (nperseg, F) cos/sin
    matrices on the CUDA cores, bound by operations the function does not
    need (4*B*T*nperseg*F FLOPs); it takes any geometry.

The choice is made on `nperseg` alone (`algorithm_for`), never on a build
or a launch that failed.  See the note at the head of `csrc/stft.cu`.

`log_spectrogram_plain` (dense, on tensors) is the plain version of the
function; `log_spectrogram_fft_plain` writes the FFT kernel's algorithm out
on tensors with the same host tables, for the CPU tests.

`log_spectrogram_fused` takes the plain version only for a tensor that
lies on the CPU.  For a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from avtubes_torch.data.spectrogram import (
    SpectrogramConfig,
    _dft_constants,
    _onesided_scale,
    _power_spectrum,
    as_float_waveform,
    frame_signal,
    tukey_periodic,
)

#: frame lengths the FFT kernel is instantiated for; every other length takes
#: the dense kernel
FFT_NPERSEG = (256, 512, 1024)
#: lanes of a warp: the FFT's last log2(32) stages run across them
_LANES = 32
#: frames per block of the FFT kernel, by frame length: the longer the run of
#: floats a block stores along t, the fewer blocks fill the card.  At 512,
#: `csrc/stft.cu` also has 16, which the smoke script times beside it (they
#: measure alike at a serving batch).
FFT_TILE = {256: 32, 512: 32, 1024: 16}


def algorithm_for(cfg: SpectrogramConfig) -> str:
    """'fft' or 'dense': which kernel `log_spectrogram_cuda` launches."""
    return "fft" if cfg.nperseg in FFT_NPERSEG else "dense"


def _bit_reverse(i: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


@functools.lru_cache(maxsize=16)
def fft_tables(cfg: SpectrogramConfig) -> dict[str, np.ndarray]:
    """Host tables of the FFT kernel for `cfg`, computed in float64 and
    rounded once to float32 (read-only, shared):

      window    (nperseg,)  the periodic Tukey window
      twiddles  (4, M)      M = nperseg/2: cos, sin of 2*pi*j/M (the complex
                            FFT's roots W_M^j = cos - i sin), then cos, sin of
                            2*pi*j/nperseg (the split step's W_N^j), j < M
      scale     (M + 1,)    the one-sided PSD scale per bin
      index     (M,) int64  where bin k of the complex FFT ends up: a radix-2
                            decimation in frequency leaves Z[k], k = E*k2 + k1,
                            at register bitrev(k1) of lane bitrev(k2), i.e. at
                            flat position bitrev(k1)*32 + bitrev(k2); index[p]
                            is the k found at position p (E = M/32)
    """
    n = cfg.nperseg
    if n not in FFT_NPERSEG:
        raise ValueError(f"the FFT kernel takes nperseg in {FFT_NPERSEG}, got {n}")
    m = n // 2
    e = m // _LANES
    j = np.arange(m, dtype=np.float64)
    twiddles = np.stack([np.cos(2 * np.pi * j / m), np.sin(2 * np.pi * j / m),
                         np.cos(2 * np.pi * j / n), np.sin(2 * np.pi * j / n)])
    p = np.arange(m, dtype=np.int64)
    reg, lane = p // _LANES, p % _LANES
    index = e * _bit_reverse(lane, 5) + _bit_reverse(reg, int(math.log2(e)))
    return {"window": tukey_periodic(n, cfg.tukey_alpha).astype(np.float32),
            "twiddles": twiddles.astype(np.float32),
            "scale": _onesided_scale(cfg).astype(np.float32),
            "index": index}


def fft_kernel_table(cfg: SpectrogramConfig) -> np.ndarray:
    """`fft_tables(cfg)` in the order the FFT kernel's lanes read them:
    (7 E + 9, 32) float32, E = nperseg / 64, one value per lane in every row,
    so each read is one coalesced load.  Pure indexing of the tables above —
    no new arithmetic.  Rows, by register r < E unless noted:

      [0, E)        window[64 r + 2 lane]       (real part of z[lane + 32 r])
      [E, 2E)       window[64 r + 2 lane + 1]   (imaginary part)
      [2E, 4E)      cos, sin of W_M^(lane * bitrev(r))
      [4E, 4E+8)    cos, sin by lane stage s < 4 (h = 16 >> s): W_(2h)^(lane mod h)
                    on the upper lanes of a pair, 1 on the lower
      [4E+8, 6E+8)  cos, sin of W_N^k, k = E bitrev5(lane) + bitrev(r)
      [6E+8, 7E+8)  scale[k] / 4
      7E+8          scale[M] / 4 (the Nyquist bin) in every lane
    """
    tab = fft_tables(cfg)
    m = cfg.nperseg // 2
    e = m // _LANES
    cos_m, sin_m, cos_n, sin_n = tab["twiddles"]
    lane = np.arange(_LANES)
    k = tab["index"].reshape(e, _LANES)                 # bin at (register, lane)
    k1 = k[:, :1] % e                                   # bitrev(r)
    n = 2 * (lane[None, :] + _LANES * np.arange(e)[:, None])
    stage_c, stage_s = np.ones((4, _LANES), np.float32), np.zeros((4, _LANES), np.float32)
    for s in range(4):
        h = 16 >> s
        upper = (lane & h) != 0
        idx = (lane & (h - 1)) * (m // (2 * h))
        stage_c[s, upper], stage_s[s, upper] = cos_m[idx[upper]], sin_m[idx[upper]]
    quarter = np.float32(0.25) * tab["scale"]           # exact: a power of two
    return np.concatenate([
        tab["window"][n], tab["window"][n + 1],
        cos_m[lane * k1], sin_m[lane * k1], stage_c, stage_s,
        cos_n[k], sin_n[k], quarter[k],
        np.full((1, _LANES), quarter[m], np.float32)]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _fft_constants(cfg: SpectrogramConfig, device: torch.device
                   ) -> dict[str, torch.Tensor]:
    """`fft_tables(cfg)` as tensors on `device`; read-only, shared."""
    return {k: torch.from_numpy(v).to(device).contiguous()
            for k, v in fft_tables(cfg).items()}


@functools.lru_cache(maxsize=16)
def _fft_kernel_table(cfg: SpectrogramConfig, device: torch.device) -> torch.Tensor:
    """`fft_kernel_table(cfg)` on `device`; read-only, shared."""
    return torch.from_numpy(fft_kernel_table(cfg)).to(device).contiguous()


def log_spectrogram_plain(x: torch.Tensor,
                          cfg: SpectrogramConfig = SpectrogramConfig()
                          ) -> torch.Tensor:
    """Plain PyTorch version: (..., num_samples) -> (..., F, T) float32.

    The function as tensor operations: the linear PSD power of
    `data/spectrogram.py::_power_spectrum` (strided framing view, constant
    detrend, two float32 products against the window-folded cos/sin
    matrices, PSD scale; the log-mel front end shares it), log, normalise,
    transpose.  On the card the products are IEEE float32 only while
    `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
    The CPU tests use it and the kernels are held against it on the card;
    it is no yardstick of speed.
    """
    power = _power_spectrum(x, cfg)                        # (..., T, F)
    spec = torch.log(power + cfg.log_offset) / cfg.normalize_std
    return spec.transpose(-1, -2).contiguous()             # (..., F, T)


def _butterflies(re: torch.Tensor, im: torch.Tensor, axis: int, size: int,
                 wr: torch.Tensor, wi: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One radix-2 decimation-in-frequency stage along `axis` (negative):
    within every run of `size` elements, a = a + b and b = (a - b) * W^j for
    the pairs (j, j + size/2); `wr - i*wi` holds W^j, j < size/2."""
    half = size // 2
    shape = list(re.shape)
    groups = shape[axis] // size
    view = shape[:axis] + [groups, 2, half] + shape[len(shape) + axis + 1:]
    tail = [1] * (-axis - 1)
    wr, wi = wr.reshape(half, *tail), wi.reshape(half, *tail)
    re, im = re.reshape(view), im.reshape(view)
    pair = axis - 1
    ar, br = re.select(pair, 0), re.select(pair, 1)
    ai, bi = im.select(pair, 0), im.select(pair, 1)
    dr, di = ar - br, ai - bi
    out_re = torch.stack([ar + br, dr * wr + di * wi], dim=pair)
    out_im = torch.stack([ai + bi, di * wr - dr * wi], dim=pair)
    return out_re.reshape(shape), out_im.reshape(shape)


def real_fft_by_tables(frames: torch.Tensor, twiddles: torch.Tensor,
                       index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., nperseg) windowed frames -> (re, im) of TWICE their one-sided
    spectrum, bins 0..nperseg/2, by the FFT kernel's algorithm on tensors.

    `twiddles` (4, M) and `index` (M,) are `fft_tables`' (in the frames'
    dtype, so the tests can run it in float64 against the float32 tables).
    The frame is packed as M = nperseg/2 complex values laid out as
    (register, lane) = (n // 32, n % 32); radix-2 stages run down the
    register axis, then the twiddle W_M^(lane*k1), then five stages across
    the lanes; the digit-reversed order is undone by a gather where the
    kernel folds it into the split step's shuffles."""
    cos_m, sin_m, cos_n, sin_n = twiddles
    m = frames.shape[-1] // 2
    e = m // _LANES
    lead = frames.shape[:-1]
    re = frames[..., 0::2].reshape(*lead, e, _LANES)
    im = frames[..., 1::2].reshape(*lead, e, _LANES)
    size = e
    while size >= 2:                                   # stages in registers
        step = m // size
        re, im = _butterflies(re, im, -2, size, cos_m[::step][: size // 2],
                              sin_m[::step][: size // 2])
        size //= 2
    # register r now holds k1 = bitrev(r); the twiddle between the two parts
    k1 = index[::_LANES] % e                           # position r*32 -> k1
    tw = k1[:, None] * torch.arange(_LANES, device=frames.device)[None, :]
    re, im = re * cos_m[tw] + im * sin_m[tw], im * cos_m[tw] - re * sin_m[tw]
    size = _LANES
    while size >= 2:                                   # stages across lanes
        step = m // size
        re, im = _butterflies(re, im, -1, size, cos_m[::step][: size // 2],
                              sin_m[::step][: size // 2])
        size //= 2
    # natural order: Z[index[p]] is the value at flat position p
    where = torch.empty_like(index)
    where[index] = torch.arange(m, device=frames.device)
    zr = re.reshape(*lead, m)[..., where]
    zi = im.reshape(*lead, m)[..., where]
    # split step: bin k pairs with bin (M - k) mod M;
    # 2 X[k] = (Z + P) + W_N^k (Z - P) / i with P = conj(Z[M - k])
    mirror = (m - torch.arange(m, device=frames.device)) % m
    pr, pi = zr[..., mirror], zi[..., mirror]
    odd_r, odd_i = zi + pi, pr - zr
    xr = (zr + pr) + (odd_r * cos_n + odd_i * sin_n)
    xi = (zi - pi) + (odd_i * cos_n - odd_r * sin_n)
    nyquist = 2.0 * (zr[..., :1] - zi[..., :1])        # real, like bin 0
    return (torch.cat([xr, nyquist], dim=-1),
            torch.cat([xi, torch.zeros_like(nyquist)], dim=-1))


def log_spectrogram_fft_plain(x: torch.Tensor,
                              cfg: SpectrogramConfig = SpectrogramConfig()
                              ) -> torch.Tensor:
    """The FFT kernel's algorithm written out on tensors (tests only; the
    port's paths never call it): (..., num_samples) -> (..., F, T) float32.

    The same host tables as the kernel and the same order of work: detrend,
    window, `real_fft_by_tables`, epilogue (the transform's factor 2 comes
    out of the scale as 1/4 of the power: exact).  No library transform is
    called."""
    x = as_float_waveform(x)
    tab = _fft_constants(cfg, x.device)
    frames = frame_signal(x, cfg)
    frames = (frames - frames.mean(dim=-1, keepdim=True)) * tab["window"]
    xr, xi = real_fft_by_tables(frames, tab["twiddles"], tab["index"])
    power = (xr * xr + xi * xi) * (0.25 * tab["scale"])
    spec = torch.log(power + cfg.log_offset) * (1.0 / cfg.normalize_std)
    return spec.transpose(-1, -2).contiguous()


def _bind(algorithm: str):
    from avtubes_torch.ops._build import load_library

    fn = getattr(load_library("stft"), f"avt_log_spectrogram_{algorithm}")
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # (x, is_int16, tables..., out, 6 ints, offset, std, device, stream)
        tables = [p] if algorithm == "fft" else [p, p, p]
        fn.argtypes = [p, i, *tables, p, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def log_spectrogram_cuda(x: torch.Tensor,
                         cfg: SpectrogramConfig = SpectrogramConfig(), *,
                         frames_per_block: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel that `algorithm_for(cfg)` names: (B,
    num_samples) float32 or int16 PCM on the card -> (B, F, T) float32.
    Launches on the current stream and does not synchronise.  Raises on
    anything the kernel does not take and on a refused launch; it never
    takes another implementation.  `frames_per_block` is for measuring the
    FFT kernel's other block size; callers leave it at `FFT_TILE`'s."""
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
    if cfg.hop < 1:
        raise ValueError(f"hop must be positive, got {cfg.hop}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    out = torch.empty((b, f, t), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    algorithm = algorithm_for(cfg)
    if frames_per_block is not None and algorithm != "fft":
        raise ValueError("frames_per_block is the FFT kernel's")
    fn = _bind(algorithm)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_int16 = int(x.dtype == torch.int16)
    if algorithm == "fft":
        table = _fft_kernel_table(cfg, x.device)
        err = fn(x.data_ptr(), is_int16, table.data_ptr(), out.data_ptr(), b, n,
                 cfg.nperseg, cfg.hop, t, frames_per_block or FFT_TILE[cfg.nperseg],
                 cfg.log_offset, cfg.normalize_std, x.device.index, stream)
    else:
        cosm, sinm, scale = _dft_constants(cfg, x.device)
        err = fn(x.data_ptr(), is_int16, cosm.data_ptr(), sinm.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), b, n, cfg.nperseg, cfg.hop,
                 t, f, cfg.log_offset, cfg.normalize_std, x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"avt_log_spectrogram_{algorithm} launch failed: "
                           f"CUDA error {err}")
    log_spectrogram_cuda.launches += 1
    return out


#: launches of a CUDA kernel by this process (a plain int; the smoke
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
