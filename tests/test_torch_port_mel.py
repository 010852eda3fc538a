"""The port's log-mel front end against the JAX package's: the filterbank
bit for bit, `log_mel_spectrogram` against the JAX function and the float64
oracle of `tests/test_spectrogram.py` (2e-4), and the plain log-spectrogram
unchanged now that it shares `_power_spectrum` with the mel path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig
from avtubes.data.spectrogram import log_mel_spectrogram as jax_log_mel_spectrogram
from avtubes.data.spectrogram import log_spectrogram as jax_log_spectrogram
from avtubes.data.spectrogram import log_spectrogram_np
from avtubes.data.spectrogram import mel_filterbank as jax_mel_filterbank
from avtubes_torch.data.spectrogram import (
    SpectrogramConfig,
    _dft_matrices,
    _onesided_scale,
    _power_spectrum,
    log_mel_spectrogram,
    mel_filterbank,
)
from avtubes_torch.ops.stft import log_spectrogram_plain

ATOL = 2e-4   # tests/test_spectrogram.py's bar for the JAX function against the oracle
GEOMETRIES = [(8000, 1, 40), (16000, 2, 64), (22050, 10, 128)]


def _cfgs(samplerate: int, seconds: int):
    return (JaxSpectrogramConfig(samplerate=samplerate, seconds=seconds),
            SpectrogramConfig(samplerate=samplerate, seconds=seconds))


def _waves(cfg: SpectrogramConfig, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, cfg.num_samples)).astype(np.float32)


def _oracle(x: np.ndarray, cfg: JaxSpectrogramConfig, n_mels: int) -> np.ndarray:
    """tests/test_spectrogram.py's float64 oracle: the filterbank applied to
    the linear power undone from the float64 log-spectrogram."""
    lin = np.exp(log_spectrogram_np(x, cfg) * cfg.normalize_std) - cfg.log_offset
    mel = jax_mel_filterbank(cfg, n_mels).T @ lin
    return np.log(mel + cfg.log_offset) / cfg.normalize_std


@pytest.mark.parametrize("n_mels", [64, 128])
@pytest.mark.parametrize("samplerate,seconds", [(22050, 10), (8000, 1)])
def test_mel_filterbank_is_the_jax_package_s_bit_for_bit(samplerate, seconds, n_mels):
    jcfg, cfg = _cfgs(samplerate, seconds)
    got, want = mel_filterbank(cfg, n_mels), jax_mel_filterbank(jcfg, n_mels)
    assert got.dtype == want.dtype == np.float64 and got.shape == (cfg.num_freqs, n_mels)
    assert np.array_equal(got, want)
    assert np.array_equal(mel_filterbank(cfg, n_mels, fmin=50.0, fmax=3000.0),
                          jax_mel_filterbank(jcfg, n_mels, fmin=50.0, fmax=3000.0))


def test_mel_filterbank_properties():
    """tests/test_spectrogram.py's properties: non-negative triangles with one
    contiguous support each, and Slaney areas of about 1 over Hz."""
    cfg = SpectrogramConfig()
    fb = mel_filterbank(cfg, 64)
    assert (fb >= 0).all()
    for m in range(64):
        nz = np.nonzero(fb[:, m])[0]
        assert nz.size > 0 and (np.diff(nz) == 1).all()
    df = cfg.samplerate / 2.0 / (cfg.num_freqs - 1)
    areas = fb.sum(axis=0) * df
    assert np.all(np.abs(areas[5:-5] - 1.0) < 0.2), areas[5:-5]


@pytest.mark.parametrize("samplerate,seconds,n_mels", GEOMETRIES)
def test_log_mel_spectrogram_matches_the_jax_function_and_the_oracle(samplerate, seconds,
                                                                     n_mels):
    jcfg, cfg = _cfgs(samplerate, seconds)
    x = _waves(cfg, 2, seed=samplerate)
    got = log_mel_spectrogram(torch.from_numpy(x), cfg, n_mels)
    assert got.dtype == torch.float32 and got.shape == (2, n_mels, cfg.num_frames)
    got = got.numpy()
    want = np.asarray(jax_log_mel_spectrogram(jnp.asarray(x), jcfg, n_mels))
    np.testing.assert_allclose(got, want, atol=ATOL)
    for i in range(2):
        np.testing.assert_allclose(got[i], _oracle(x[i], jcfg, n_mels), atol=ATOL)


def test_log_mel_spectrogram_takes_int16_pcm_and_any_leading_axes():
    jcfg, cfg = _cfgs(8000, 1)
    pcm = (np.random.default_rng(1).standard_normal((3, cfg.num_samples)) * 3000
           ).astype(np.int16)
    got = log_mel_spectrogram(torch.from_numpy(pcm), cfg, 40)
    want = np.asarray(jax_log_mel_spectrogram(jnp.asarray(pcm), jcfg, 40))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    one = log_mel_spectrogram(torch.from_numpy(pcm[0]), cfg, 40)
    assert one.shape == (40, cfg.num_frames)
    assert torch.equal(one, got[0])


def test_the_plain_log_spectrogram_is_unchanged_by_sharing_the_power_spectrum():
    """Bit-equal to the formula it had before it called `_power_spectrum`
    (written out here), and within the JAX function's bar of it."""
    jcfg, cfg = _cfgs(22050, 10)
    x = torch.from_numpy(_waves(cfg, 2, seed=3))
    cosm, sinm = (torch.tensor(a, dtype=torch.float32) for a in _dft_matrices(cfg))
    scale = torch.tensor(_onesided_scale(cfg), dtype=torch.float32)
    frames = x.unfold(-1, cfg.nperseg, cfg.hop)[..., :cfg.num_frames, :]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    re, im = frames @ cosm, frames @ sinm
    power = (re * re + im * im) * scale
    before = (torch.log(power + cfg.log_offset) / cfg.normalize_std).transpose(-1, -2)
    assert torch.equal(_power_spectrum(x, cfg), power)
    got = log_spectrogram_plain(x, cfg)
    assert torch.equal(got, before.contiguous())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_log_spectrogram(
        jnp.asarray(x.numpy()), jcfg)), atol=ATOL)
