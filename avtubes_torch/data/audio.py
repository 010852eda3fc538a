"""Host-side audio I/O: minimal RIFF/WAVE reader + waveform preparation.

Own copy of `avtubes/data/audio.py` (numpy and struct only; the port
imports nothing from the JAX package).  RIFF is parsed directly with numpy,
so no audio library is needed.  Output follows soundfile's convention:
float64 in [-1, 1] for integer PCM, native floats passed through; shape
(N,) for mono, (N, C) otherwise.

`prepare_waveform` is the fixed-length policy of the original training
data loader: tile audio shorter than `seconds`, clip to [-1, 1], take the
first `samplerate * seconds` samples.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file. Returns (samples, samplerate).

    Integer PCM is normalized to [-1, 1) float64 (soundfile convention);
    IEEE-float wavs are returned as-is (float64).  Multi-channel audio is
    returned as (N, C); mono as (N,).
    """
    with open(path, "rb") as f:
        data = f.read()
    return parse_wav(data, name=str(path))


def parse_wav(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, int]:
    """`read_wav` over an in-memory buffer (serving requests arrive as
    bytes, not files).  Same output convention; `name` labels errors."""
    path = name
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:  # truncated file: struct.error is not a
                raise ValueError(  # ValueError, so it would not skip-count
                    f"{path}: truncated fmt chunk ({len(body)} bytes)")
            audio_format, channels, samplerate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if audio_format == 0xFFFE and chunk_size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_format, channels, samplerate, bits)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, samplerate, bits = fmt

    if audio_format == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        samples = np.frombuffer(raw, dtype=dtype).astype(np.float64)
    elif audio_format == 1:  # integer PCM
        if bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float64) / float(1 << 23)
        elif bits in _PCM_DTYPES:
            ints = np.frombuffer(raw, dtype=_PCM_DTYPES[bits])
            if bits == 8:  # 8-bit wav is unsigned
                samples = (ints.astype(np.float64) - 128.0) / 128.0
            else:
                samples = ints.astype(np.float64) / float(1 << (bits - 1))
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format {audio_format}")

    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, samplerate


def write_wav(path: str | Path, samples: np.ndarray, samplerate: int) -> None:
    """Write mono/stereo PCM16 WAV (test-fixture and tooling helper)."""
    samples = np.asarray(samples)
    channels = 1 if samples.ndim == 1 else samples.shape[1]
    ints = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    raw = ints.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(raw)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, samplerate,
                            samplerate * channels * 2, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(raw)))
        f.write(raw)


def prepare_waveform(samples: np.ndarray, samplerate: int, seconds: int = 10) -> np.ndarray:
    """Tile short audio, clip to [-1, 1], truncate to `seconds`."""
    samples = np.asarray(samples)
    if samples.ndim > 1:  # reference data is mono; downmix defensively
        samples = samples.mean(axis=1)
    target = samplerate * seconds
    if samples.shape[0] == 0:  # empty data chunk: a decode failure, not a
        raise ValueError("empty waveform")  # ZeroDivisionError below
    if samples.shape[0] < target:
        n = int(target / samples.shape[0]) + 1
        samples = np.tile(samples, n)
    out = samples[:target].copy()
    np.clip(out, -1.0, 1.0, out=out)
    return out
