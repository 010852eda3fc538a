"""Port of the log-spectrogram front end (K1 module) against the JAX package.

The same numpy-made waveforms go through `avtubes.data.spectrogram` /
`avtubes.ops.stft` (Pallas in interpret mode) and through
`avtubes_torch.data.spectrogram` / `avtubes_torch.ops.stft` on the CPU,
where the port's wrapper takes the kernel's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from avtubes.data import spectrogram as jspec
from avtubes.ops.stft import _log_spectrogram_pallas
from avtubes_torch.data import spectrogram as tspec
from avtubes_torch.ops import stft as tstft

# float32 DFT sums in another order on each side, then a log: the JAX
# package's own scipy-parity bar
ATOL = 2e-4
# the interpret-mode Pallas kernel vs XLA is itself held to 5e-4
ATOL_PALLAS = 5e-4


def _cfgs(seconds):
    return (jspec.SpectrogramConfig(samplerate=8000, seconds=seconds),
            tspec.SpectrogramConfig(samplerate=8000, seconds=seconds))


def _waves(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    return np.clip(rng.randn(batch, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)


def test_config_and_constants_are_the_same():
    jcfg, tcfg = _cfgs(2)
    assert tcfg.shape == jcfg.shape and tcfg.hop == jcfg.hop
    assert tspec.SpectrogramConfig().shape == (257, 431)
    for a, b in zip(tspec._dft_matrices(tcfg), jspec._dft_matrices(jcfg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tspec._onesided_scale(tcfg),
                                  jspec._onesided_scale(jcfg))
    assert tspec.AUDIO_TRANSPORTS == jspec.AUDIO_TRANSPORTS


@pytest.mark.parametrize("batched", [False, True])
def test_log_spectrogram_matches_jax(batched, monkeypatch):
    jcfg, tcfg = _cfgs(2)
    x = _waves(tcfg, 3, 0)
    x = x if batched else x[0]
    want = np.asarray(jspec.log_spectrogram(jnp.asarray(x), jcfg))
    got = tspec.log_spectrogram(torch.from_numpy(x), tcfg, impl="kernel").numpy()
    assert got.shape == want.shape == (*x.shape[:-1], *tcfg.shape)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # on a CPU tensor the wrapper IS the plain version: held by routing (the
    # wrapper hands back the very tensor the plain version returns), not by
    # comparing two float32 evaluations, which a loaded host need not repeat
    # bit for bit
    sentinel = torch.full(got.shape, 7.0)
    calls = []

    def spy(x_, cfg_):
        calls.append((x_, cfg_))
        return sentinel

    monkeypatch.setattr(tstft, "log_spectrogram_plain", spy)
    wave = torch.from_numpy(x)
    assert tspec.log_spectrogram(wave, tcfg, impl="kernel") is sentinel
    assert len(calls) == 1 and calls[0][0].data_ptr() == wave.data_ptr() and calls[0][1] == tcfg


def test_plain_matches_pallas_interpret():
    jcfg, tcfg = _cfgs(2)
    x = _waves(tcfg, 2, 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_log_spectrogram_pallas(jnp.asarray(x), jcfg, tile=32))
    got = tstft.log_spectrogram_plain(torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_PALLAS)


def test_matches_own_numpy_references():
    _, tcfg = _cfgs(1)
    x = _waves(tcfg, 2, 2)
    got = tspec.log_spectrogram(torch.from_numpy(x), tcfg).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], tspec.log_spectrogram_np(x[i], tcfg),
                                   atol=ATOL)
        np.testing.assert_allclose(tspec.log_spectrogram_np_f32(x[i], tcfg),
                                   tspec.log_spectrogram_np(x[i], tcfg), atol=1e-5)


@pytest.mark.parametrize("transport", tspec.AUDIO_TRANSPORTS)
def test_transport_dispatch_matches_jax(transport):
    jcfg, tcfg = _cfgs(1)
    x = _waves(tcfg, 2, 3)
    payload = tspec.prepare_audio_payload(x, transport, tcfg)
    shape, dtype = tspec.audio_payload_spec(transport, tcfg)
    assert payload.shape[1:] == shape and payload.dtype == dtype
    assert (shape, dtype) == jspec.audio_payload_spec(transport, jcfg)
    # the numpy encoders are own copies: same bytes as the JAX package's
    # (int16 rounding of a float32 host spectrogram may differ by one step
    # between the native and the numpy encoder, so compare decoded values)
    want = np.asarray(jspec.log_spectrogram(jnp.asarray(payload), jcfg))
    got = tspec.log_spectrogram(torch.from_numpy(payload), tcfg).numpy()
    assert got.shape == (2, *tcfg.shape) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and every transport decodes to the float32 answer within its own step
    ref = tspec.log_spectrogram(torch.from_numpy(x), tcfg).numpy()
    step = {"float32": ATOL, "int16": 2e-3, "spec_int16": 1e-4,
            "spec_int8": 1.0 / tspec.SPEC_INT8_SCALE}[transport]
    np.testing.assert_allclose(got, ref, atol=step)


def test_quantizers_match_jax():
    rng = np.random.RandomState(4)
    w = (rng.rand(1000).astype(np.float32) * 2 - 1)
    s = (rng.rand(50, 7).astype(np.float32) * 3.3 - 1.34)
    np.testing.assert_array_equal(tspec.quantize_int16_waveform(w),
                                  jspec.quantize_int16_waveform(w))
    np.testing.assert_array_equal(tspec.quantize_int16_spectrogram(s),
                                  jspec.quantize_int16_spectrogram(s))
    np.testing.assert_array_equal(tspec.quantize_int8_spectrogram(s),
                                  jspec.quantize_int8_spectrogram(s))
    s16 = tspec.quantize_int16_spectrogram(s)
    np.testing.assert_array_equal(tspec.spec_int16_to_int8(s16),
                                  jspec.spec_int16_to_int8(s16))


def test_zero_waveform_is_exactly_the_floor():
    _, tcfg = _cfgs(1)
    out = tspec.log_spectrogram(torch.zeros(2, tcfg.num_samples), tcfg)
    floor = np.float32(np.log(np.float32(1e-7))) / np.float32(12.0)
    assert out.shape == (2, *tcfg.shape)
    assert torch.all(out == out[0, 0, 0])
    assert abs(float(out[0, 0, 0]) - float(floor)) <= 1e-6


def test_frame_signal_general_hop_matches_jax():
    jcfg = jspec.SpectrogramConfig(samplerate=4000, seconds=1, nperseg=128, noverlap=32)
    tcfg = tspec.SpectrogramConfig(samplerate=4000, seconds=1, nperseg=128, noverlap=32)
    x = _waves(tcfg, 2, 5)
    np.testing.assert_array_equal(
        tspec.frame_signal(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jspec.frame_signal(jnp.asarray(x), jcfg)))
    np.testing.assert_allclose(
        tspec.log_spectrogram(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jspec.log_spectrogram(jnp.asarray(x), jcfg)), atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensor_and_bad_impl():
    _, tcfg = _cfgs(1)
    x = torch.zeros(1, tcfg.num_samples)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tstft.log_spectrogram_cuda(x, tcfg)
    with pytest.raises(ValueError, match="impl"):
        tstft.log_spectrogram_fused(x, tcfg, impl="auto")
    assert tstft.log_spectrogram_cuda.launches == 0


# ---------------------------------------------------------------------------
# The FFT kernel's algorithm on tensors (`log_spectrogram_fft_plain`) and its
# host tables: held against the dense plain version, the JAX function and the
# interpret-mode Pallas kernel for every frame length the kernel takes.

def _fft_case(name, cfg):
    """(batch, num_samples) test clips, made from a seed with numpy."""
    rng = np.random.RandomState(7)
    t = np.arange(cfg.num_samples, dtype=np.float64) / cfg.samplerate
    bin_hz = cfg.samplerate / cfg.nperseg
    if name == "noise":
        x = np.clip(rng.randn(2, cfg.num_samples) * 0.2, -1, 1)
    elif name == "sine":          # full scale: at a bin's centre, and between two
        x = np.stack([np.sin(2 * np.pi * 20.0 * bin_hz * t),
                      np.sin(2 * np.pi * 20.5 * bin_hz * t)])
    elif name == "dc_offset":     # detrend precision
        x = 0.9 + 1e-3 * rng.randn(2, cfg.num_samples)
    elif name == "zero":
        x = np.zeros((2, cfg.num_samples))
    elif name == "int16":
        return tspec.quantize_int16_waveform(
            np.clip(rng.randn(2, cfg.num_samples) * 0.2, -1, 1).astype(np.float32))
    else:
        raise ValueError(name)
    return x.astype(np.float32)


FFT_CASES = ("noise", "sine", "dc_offset", "zero", "int16")


def _fft_cfgs(nperseg):
    kw = dict(samplerate=8000, seconds=2, nperseg=nperseg)
    return jspec.SpectrogramConfig(**kw), tspec.SpectrogramConfig(**kw)


def _reference(which, x, jcfg, tcfg):
    if which == "plain":
        return tstft.log_spectrogram_plain(torch.from_numpy(x), tcfg).numpy()
    if which == "jax":
        return np.asarray(jspec.log_spectrogram(jnp.asarray(x), jcfg))
    with pltpu.force_tpu_interpret_mode():
        wave = jspec.as_float_waveform(jnp.asarray(x))
        return np.asarray(_log_spectrogram_pallas(wave, jcfg, tile=32))


@pytest.mark.parametrize("reference", ["plain", "jax", "pallas_interpret"])
@pytest.mark.parametrize("case", FFT_CASES)
@pytest.mark.parametrize("nperseg", tstft.FFT_NPERSEG)
def test_fft_plain_matches(nperseg, case, reference):
    jcfg, tcfg = _fft_cfgs(nperseg)
    assert tstft.algorithm_for(tcfg) == "fft"
    x = _fft_case(case, tcfg)
    got = tstft.log_spectrogram_fft_plain(torch.from_numpy(x), tcfg).numpy()
    want = _reference(reference, x, jcfg, tcfg)
    assert got.shape == want.shape == (2, *tcfg.shape) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("nperseg", tstft.FFT_NPERSEG)
def test_fft_host_tables_against_float64_numpy(nperseg):
    _, tcfg = _fft_cfgs(nperseg)
    tab = tstft.fft_tables(tcfg)
    m = nperseg // 2
    np.testing.assert_array_equal(
        tab["window"], tspec.tukey_periodic(nperseg, tcfg.tukey_alpha).astype(np.float32))
    j = np.arange(m)
    for row, want in zip(tab["twiddles"], (np.cos(2 * np.pi * j / m), np.sin(2 * np.pi * j / m),
                                           np.cos(2 * np.pi * j / nperseg),
                                           np.sin(2 * np.pi * j / nperseg))):
        assert row.dtype == np.float32
        np.testing.assert_allclose(row, want, rtol=0, atol=6e-8)   # one rounding
    np.testing.assert_array_equal(tab["scale"], tspec._onesided_scale(tcfg).astype(np.float32))
    assert sorted(tab["index"].tolist()) == list(range(m))         # a permutation
    # the algorithm in float64 with these tables IS the real DFT of a
    # windowed, detrended frame, to the tables' own rounding
    rng = np.random.RandomState(3)
    frames = rng.randn(6, nperseg)
    frames = (frames - frames.mean(-1, keepdims=True)) * tab["window"].astype(np.float64)
    xr, xi = tstft.real_fft_by_tables(
        torch.from_numpy(frames), torch.from_numpy(tab["twiddles"].astype(np.float64)),
        torch.from_numpy(tab["index"]))
    want = 2.0 * np.fft.rfft(frames, axis=-1)
    peak = np.abs(want).max()
    np.testing.assert_allclose(xr.numpy(), want.real, rtol=0, atol=1e-6 * peak)
    np.testing.assert_allclose(xi.numpy(), want.imag, rtol=0, atol=1e-6 * peak)
    # DC and Nyquist are real, and neither is doubled by the scale
    assert float(xi[:, 0].abs().max()) == 0.0 and float(xi[:, -1].abs().max()) == 0.0
    assert tab["scale"][0] == tab["scale"][-1] == np.float32(0.5) * tab["scale"][1]


def test_algorithm_choice_depends_on_nperseg_alone():
    for nperseg, want in ((256, "fft"), (512, "fft"), (1024, "fft"), (400, "dense"),
                          (128, "dense"), (2048, "dense")):
        for sr, noverlap in ((8000, 1), (22050, nperseg // 2)):
            cfg = tspec.SpectrogramConfig(samplerate=sr, seconds=1, nperseg=nperseg,
                                          noverlap=noverlap)
            assert tstft.algorithm_for(cfg) == want
    with pytest.raises(ValueError, match="nperseg"):
        tstft.fft_tables(tspec.SpectrogramConfig(nperseg=400, noverlap=150))


@pytest.mark.parametrize("nperseg", tstft.FFT_NPERSEG)
def test_fft_kernel_table_is_the_host_tables_in_lane_order(nperseg):
    """Every row of the table the CUDA kernel reads, rebuilt entry by entry
    from `fft_tables` with the bit reversals written out as strings."""
    _, tcfg = _fft_cfgs(nperseg)
    tab = tstft.fft_tables(tcfg)
    got = tstft.fft_kernel_table(tcfg)
    m = nperseg // 2
    e = m // 32
    ebits = e.bit_length() - 1
    rev = lambda v, bits: int(format(v, f"0{bits}b")[::-1], 2) if bits else 0
    cos_m, sin_m, cos_n, sin_n = tab["twiddles"]
    assert got.shape == (7 * e + 9, 32) and got.dtype == np.float32
    for r in range(e):
        for lane in range(32):
            k = e * rev(lane, 5) + rev(r, ebits)
            assert tab["index"][r * 32 + lane] == k
            want = {0: tab["window"][64 * r + 2 * lane],
                    e: tab["window"][64 * r + 2 * lane + 1],
                    2 * e: cos_m[lane * rev(r, ebits)], 3 * e: sin_m[lane * rev(r, ebits)],
                    4 * e + 8: cos_n[k], 5 * e + 8: sin_n[k],
                    6 * e + 8: np.float32(0.25) * tab["scale"][k]}
            for row, value in want.items():
                assert got[row + r, lane] == value, (row, r, lane)
    for s in range(4):
        h = 16 >> s
        for lane in range(32):
            j = (lane % h) * (m // (2 * h))
            c, sn = (cos_m[j], sin_m[j]) if lane & h else (1.0, 0.0)
            assert got[4 * e + s, lane] == c and got[4 * e + 4 + s, lane] == sn
    assert np.all(got[7 * e + 8] == np.float32(0.25) * tab["scale"][m])
