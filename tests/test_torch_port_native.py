"""The port's native host IO core against the JAX package's.

`avtubes_torch/native/avtubes_io.cc` is the port's own copy of
`avtubes/native/avtubes_io.cc`, built with the same flags into
`avtubes_torch/_build/`: every entry point must give bit-equal outputs to the
JAX package's on the same files (WAV single and batch, JPEG decode, the
shortest-side resize precise and DCT-scaled, bytes and file paths, the batch
decoders, the int16 host spectrogram, the fused training clip), decline the
same malformed and adversarial inputs, and step aside under its own kill
switch.  The cases follow tests/test_native.py and tests/test_native_fuzz.py.
"""

import struct
from io import BytesIO

import numpy as np
import pytest

from avtubes import native as jn
from avtubes.data import transforms as jt
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpecCfg
from avtubes.data.spectrogram import log_spectrogram_np_f32, quantize_int16_spectrogram
from avtubes_torch import native as tn
from avtubes_torch.data import transforms as tt
from avtubes_torch.data.audio import prepare_waveform, read_wav, write_wav


@pytest.fixture(autouse=True)
def both_libraries(monkeypatch):
    monkeypatch.delenv(tn.KILL_SWITCH, raising=False)
    monkeypatch.delenv("AVTUBES_NO_NATIVE", raising=False)
    if not (tn.available() and jn.available()):
        pytest.skip("a native library is unavailable (needs g++ and libjpeg)")


def _photo(h, w, seed=0):
    """Photo-like content: smooth gradients plus mild noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx / max(w, 1) * 255, yy / max(h, 1) * 255,
                    (xx + yy) / max(h + w, 1) * 255], -1) + rng.randn(h, w, 3) * 8
    return np.clip(img, 0, 255).astype(np.uint8)


def _save_jpeg(path, img, quality=92):
    from PIL import Image

    Image.fromarray(img).save(path, quality=quality)
    return path


def _wav_bytes(n_samples=256, sr=8000, fmt_size=16, data_size=None, fmt=1, bits=16,
               channels=1):
    """Hand-rolled RIFF/WAVE whose header fields may lie."""
    pcm = np.zeros(n_samples * channels, {16: np.int16, 32: np.int32, 8: np.uint8}[bits])
    if fmt == 3:
        pcm = np.zeros(n_samples * channels, np.float32)
    pcm = pcm.tobytes()
    if data_size is None:
        data_size = len(pcm)
    block = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt, channels, sr, sr * block, block, bits)
    body = b"fmt " + struct.pack("<I", fmt_size) + fmt_body[:max(fmt_size, 0)]
    body += b"data" + struct.pack("<I", data_size) + pcm
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _same(a, b):
    """Both None, or equal arrays of one dtype (tuples element by element)."""
    if a is None or b is None:
        assert a is None and b is None, (a is None, b is None)
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- build

def test_the_library_builds_from_the_port_s_own_source():
    info = tn.build_info()
    assert info["library"].startswith("libavtubes_torch_io-")
    assert (tn.BUILD_DIR / info["library"]).exists()
    assert tn.BUILD_DIR.parent.name == "avtubes_torch"
    assert info["jpeg_lib_version"] == "62"
    assert tn._SRC.parent.parent.name == "avtubes_torch"


@pytest.mark.parametrize("h,w,target", [(480, 640, 246), (640, 480, 224), (641, 448, 224),
                                        (1, 64, 8), (64, 1, 48), (300, 300, 224),
                                        (257, 198, 96)])
def test_shortest_side_dims_equal_the_jax_package_s(h, w, target):
    assert tn.shortest_side_dims(h, w, target) == jn.shortest_side_dims(h, w, target)
    assert tt.shortest_side_dims(h, w, target) == jn.shortest_side_dims(h, w, target)


def test_the_pillow_route_builds_and_decodes_the_same(tmp_path):
    """The route taken where the host has no libjpeg headers: the vendored
    ABI-62 headers and the libjpeg Pillow's wheel bundles."""
    import ctypes
    import subprocess

    routes = dict((r, (c, lib)) for r, c, lib in tn._routes())
    if "pillow" not in routes:
        pytest.skip("Pillow links a system libjpeg here: no bundled libjpeg-*.so.62")
    cflags, libs = routes["pillow"]
    out = tmp_path / "libpillow_route.so"
    subprocess.run(["make", "-s", "-B", "-C", str(tn._DIR), f"OUT={out}",
                    f"JPEG_CFLAGS={cflags}", f"JPEG_LIBS={libs}"],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    tn._bind(lib)
    p = _save_jpeg(tmp_path / "t.jpg", _photo(480, 640))
    got = np.empty((224, 224, 3), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    for scaled in (0, 1):
        assert lib.avt_decode_jpeg_shortest(str(p).encode(), 224, 224,
                                            got.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                            ctypes.byref(oh), ctypes.byref(ow), scaled)
        np.testing.assert_array_equal(got, tn.decode_jpeg_shortest(p, 224, 224, bool(scaled)))


# --------------------------------------------------------------------- WAV

def _wav_case(tmp_path, case):
    p = tmp_path / f"{case}.wav"
    rng = np.random.RandomState(0)
    if case == "mono_short":
        write_wav(p, np.clip(rng.randn(22050 * 3) * 0.4, -1, 1), 22050)
    elif case == "mono_long":
        write_wav(p, np.clip(rng.randn(8000 * 3) * 0.4, -1, 1), 8000)
    elif case == "other_rate":
        write_wav(p, np.clip(rng.randn(16000) * 0.4, -1, 1), 16000)
    elif case == "handrolled":
        p.write_bytes(_wav_bytes())
    elif case == "stereo16":
        p.write_bytes(_wav_bytes(channels=2))
    elif case == "float32":
        p.write_bytes(_wav_bytes(fmt=3, bits=32))
    elif case == "int32":
        p.write_bytes(_wav_bytes(bits=32))
    elif case == "pcm8":
        p.write_bytes(_wav_bytes(bits=8))
    elif case == "lying_size":
        p.write_bytes(_wav_bytes(data_size=0xFFFFFFF0))
    elif case == "short_fmt":
        p.write_bytes(_wav_bytes(fmt_size=8))
    elif case == "garbage":
        p.write_bytes(b"RIFFgarbage-not-a-wave-file")
    return p


WAV_CASES = ("mono_short", "mono_long", "other_rate", "handrolled", "stereo16", "float32",
             "int32", "pcm8", "lying_size", "short_fmt", "garbage", "missing")


@pytest.mark.parametrize("case", WAV_CASES)
def test_wav_decode_prepared_equals_the_jax_package_s(tmp_path, case):
    p = _wav_case(tmp_path, case)
    got = tn.decode_wav_prepared(p, 1 if case != "mono_long" else 2, 8000 * 2)
    _same(got, jn.decode_wav_prepared(p, 1 if case != "mono_long" else 2, 8000 * 2))
    if case in ("pcm8", "short_fmt", "garbage", "missing"):
        assert got is None
    else:
        assert got is not None


def test_wav_decode_matches_the_python_path(tmp_path):
    p = _wav_case(tmp_path, "mono_short")
    out, sr = tn.decode_wav_prepared(p, 10, 22050 * 10)
    samples, _ = read_wav(p)
    assert sr == 22050
    np.testing.assert_array_equal(out, prepare_waveform(samples, sr, 10).astype(np.float32))


def test_wav_batch_equals_the_jax_package_s(tmp_path):
    paths = [_wav_case(tmp_path, c) for c in WAV_CASES]
    got_out, got_rates = tn.decode_wav_batch(paths, 1, 8000, threads=4)
    want_out, want_rates = jn.decode_wav_batch(paths, 1, 8000, threads=4)
    np.testing.assert_array_equal(got_rates, want_rates)
    ok = got_rates > 0   # failed rows of the output stay uninitialised
    np.testing.assert_array_equal(got_out[ok], want_out[ok])
    assert ok.sum() == 8 and not ok[-1]


# -------------------------------------------------------------------- JPEG

@pytest.mark.parametrize("shape", [(48, 64), (480, 640), (257, 198)])
def test_jpeg_decode_equals_the_jax_package_s(tmp_path, shape):
    from PIL import Image

    p = _save_jpeg(tmp_path / "t.jpg", _photo(*shape, seed=1), quality=95)
    got = tn.decode_jpeg(p)
    _same(got, jn.decode_jpeg(p))
    np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")))
    assert tn.jpeg_size(p) == jn.jpeg_size(p) == shape


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("crop", [0, 224])
@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (300, 300), (900, 300)])
def test_jpeg_shortest_equals_the_jax_package_s(tmp_path, shape, crop, scaled):
    p = _save_jpeg(tmp_path / "t.jpg", _photo(*shape, seed=3))
    got = tn.decode_jpeg_shortest(p, 224, crop=crop, scaled=scaled)
    _same(got, jn.decode_jpeg_shortest(p, 224, crop=crop, scaled=scaled))
    if not scaled:   # full resolution: within one level of PIL
        ref = np.asarray(tt.host_resize_shortest(tt.open_rgb(p), 224))
        ref = tt.host_center_crop(ref, crop) if crop else ref
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shape", [(480, 640), (257, 198), (900, 300)])
def test_jpeg_bytes_equal_the_file_path_and_the_jax_package(tmp_path, shape, scaled):
    p = _save_jpeg(tmp_path / "t.jpg", _photo(*shape, seed=7))
    data = p.read_bytes()
    got = tn.decode_jpeg_shortest_bytes(data, 224, crop=224, scaled=scaled)
    _same(got, tn.decode_jpeg_shortest(p, 224, crop=224, scaled=scaled))
    _same(got, jn.decode_jpeg_shortest_bytes(data, 224, crop=224, scaled=scaled))


def test_jpeg_bytes_reject_what_is_not_a_jpeg():
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, "PNG")
    for data in (buf.getvalue(), b"\xff\xd8\xffgarbage", b""):
        assert tn.decode_jpeg_shortest_bytes(data, 224, crop=224) is None
        assert jn.decode_jpeg_shortest_bytes(data, 224, crop=224) is None
    with pytest.raises(ValueError):
        tn.decode_jpeg_shortest_bytes(b"\xff\xd8\xff", 224, crop=0)
    with pytest.raises(ValueError):
        tn.decode_jpeg_shortest_batch([], 224, crop=0)


def test_jpeg_shortest_rounding_tie(tmp_path):
    """641x448 -> 320.5 exactly: both sides round half to even (320)."""
    p = _save_jpeg(tmp_path / "tie.jpg", np.random.RandomState(6).randint(
        0, 256, (641, 448, 3), np.uint8))
    got = tn.decode_jpeg_shortest(p, 224, crop=0, scaled=False)
    assert got.shape == (320, 224, 3)
    _same(got, jn.decode_jpeg_shortest(p, 224, crop=0, scaled=False))


@pytest.mark.parametrize("scaled", [False, True])
def test_jpeg_batches_equal_the_jax_package_s(tmp_path, scaled):
    paths = [_save_jpeg(tmp_path / f"{i}.jpg", _photo(256 + 16 * i, 320, seed=i))
             for i in range(5)] + [tmp_path / "missing.jpg"]
    got = tn.decode_jpeg_shortest_batch(paths, 224, 224, threads=3, scaled=scaled)
    want = jn.decode_jpeg_shortest_batch(paths, 224, 224, threads=3, scaled=scaled)
    assert list(got[1]) == list(want[1]) == [1] * 5 + [0]
    np.testing.assert_array_equal(got[0][:5], want[0][:5])
    for i in range(5):
        np.testing.assert_array_equal(got[0][i], tn.decode_jpeg_shortest(
            paths[i], 224, crop=224, scaled=scaled))
    same = [_save_jpeg(tmp_path / f"s{i}.jpg", _photo(32, 32, seed=i)) for i in range(4)]
    got = tn.decode_jpeg_batch(same + [tmp_path / "missing.jpg"], 32, 32, threads=3)
    want = jn.decode_jpeg_batch(same + [tmp_path / "missing.jpg"], 32, 32, threads=3)
    assert list(got[1]) == list(want[1]) == [1] * 4 + [0]
    np.testing.assert_array_equal(got[0][:4], want[0][:4])


@pytest.mark.parametrize("hw", [(1, 1), (1, 64), (64, 1), (3, 97), (16, 16)])
def test_extreme_geometry_equals_the_jax_package_s(tmp_path, hw):
    p = _save_jpeg(tmp_path / "g.jpg", np.random.RandomState(5).randint(
        0, 255, (*hw, 3), np.uint8), quality=95)
    for short in (8, 48):
        got = tn.decode_jpeg_shortest(p, short, crop=0, scaled=False)
        assert got is not None and got.shape[:2] == tn.shortest_side_dims(*hw, short)
        _same(got, jn.decode_jpeg_shortest(p, short, crop=0, scaled=False))
    _same(tn.decode_jpeg_shortest(p, 8, crop=32, scaled=False),
          jn.decode_jpeg_shortest(p, 8, crop=32, scaled=False))


def _giant_sof_jpeg(tmp_path, h, w):
    """A real JPEG whose SOF0 claims h x w."""
    p = _save_jpeg(tmp_path / f"giant{h}x{w}.jpg", np.zeros((8, 8, 3), np.uint8), 90)
    raw = bytearray(p.read_bytes())
    i = raw.find(b"\xff\xc0")
    raw[i + 5:i + 9] = struct.pack(">HH", h, w)
    p.write_bytes(bytes(raw))
    return p


@pytest.mark.parametrize("hw", [(30000, 30000), (2, 30000)], ids=["giant", "extreme_aspect"])
def test_untrusted_header_dims_are_declined(tmp_path, hw):
    p = _giant_sof_jpeg(tmp_path, *hw)
    for mod in (tn, jn):
        assert mod.jpeg_size(p) == hw
        if hw == (30000, 30000):
            assert mod.decode_jpeg(p) is None
        assert mod.decode_jpeg_shortest(p, 224, crop=224) is None
        assert mod.decode_jpeg_shortest(p, 224, crop=0) is None
        assert list(mod.decode_jpeg_shortest_batch([p], 224, 224, threads=2)[1]) == [0]
        assert mod.decode_clip_train([p, p], 224, 64, 0, 0, threads=2) is None


# ------------------------------------------------------------- spectrogram

@pytest.mark.parametrize("samplerate,seconds", [(22050, 2), (8000, 1), (16000, 2)])
def test_log_spectrogram_i16_equals_the_jax_package_s(samplerate, seconds):
    cfg = JaxSpecCfg(samplerate=samplerate, seconds=seconds)
    wav = np.clip(np.random.RandomState(0).randn(cfg.num_samples) * 0.3, -1, 1)
    wav = wav.astype(np.float32)
    args = (cfg.samplerate, cfg.nperseg, cfg.noverlap, cfg.num_freqs, cfg.num_frames)
    got = tn.log_spectrogram_i16(wav, *args)
    _same(got, jn.log_spectrogram_i16(wav, *args))
    ref = quantize_int16_spectrogram(log_spectrogram_np_f32(wav, cfg))
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 2


def test_log_spectrogram_i16_rejections():
    assert tn.log_spectrogram_i16(np.zeros(4096, np.float32), 16000, 500, 1, 251, 8) is None
    wav = np.zeros(512 + 3 * 511, np.float32)
    with pytest.raises(ValueError, match="frequency"):
        tn.log_spectrogram_i16(wav, 22050, 512, 1, num_freqs=129, num_frames=4)
    with pytest.raises(ValueError, match="STFT frames"):
        tn.log_spectrogram_i16(wav, 22050, 512, 1, num_freqs=257, num_frames=5)


def test_decode_wav_spec_batch_equals_the_jax_package_s(tmp_path):
    cfg = JaxSpecCfg(samplerate=8000, seconds=1)
    rng = np.random.RandomState(1)
    paths = []
    for i in range(3):
        p = tmp_path / f"w{i}.wav"
        write_wav(p, np.clip(rng.randn(8000 if i != 1 else 3000) * 0.4, -1, 1), 8000)
        paths.append(p)
    paths += [tmp_path / "missing.wav", _wav_case(tmp_path, "garbage")]
    args = (paths, 1, 8000, cfg.samplerate, cfg.nperseg, cfg.noverlap, cfg.num_freqs,
            cfg.num_frames)
    got, rates = tn.decode_wav_spec_batch(*args, threads=2)
    want, want_rates = jn.decode_wav_spec_batch(*args, threads=2)
    assert rates.tolist() == want_rates.tolist() == [8000, 8000, 8000, 0, 0]
    np.testing.assert_array_equal(got[:3], want[:3])
    with pytest.raises(ValueError, match="frequency"):
        tn.decode_wav_spec_batch([paths[0]], 1, 512 + 511, 22050, 512, 1, 129, 2)


# ------------------------------------------------------------- fused clip

def test_decode_clip_train_equals_the_per_frame_path_and_the_jax_package(tmp_path,
                                                                       monkeypatch):
    paths = [_save_jpeg(tmp_path / f"{i}.jpg", _photo(120, 160, seed=i)) for i in range(4)]
    fused = tt.host_load_train_clip(paths, np.random.RandomState(7), 96)
    np.testing.assert_array_equal(fused, jt.host_load_train_clip(
        paths, np.random.RandomState(7), 96))
    monkeypatch.setattr(tn, "decode_clip_train", lambda *a, **k: None)
    per_frame = tt.host_load_train_clip(paths, np.random.RandomState(7), 96)
    assert fused.shape == per_frame.shape == (4, 96, 96, 3)
    np.testing.assert_array_equal(fused, per_frame)


def test_decode_clip_train_declines_a_window_a_frame_does_not_cover(tmp_path):
    paths = [_save_jpeg(tmp_path / f"{i}.jpg", np.random.RandomState(3).randint(
        0, 256, (h, w, 3), np.uint8)) for i, (h, w) in
             enumerate([(480, 120), (120, 120), (480, 120), (480, 120)])]
    assert tn.decode_clip_train(paths, 106, 96, 200, 5, scaled=True) is None
    assert jn.decode_clip_train(paths, 106, 96, 200, 5, scaled=True) is None
    got = tn.decode_clip_train(paths, 106, 96, 5, 5, threads=2, scaled=True)
    assert got is not None and got.min() != got.max()
    _same(got, jn.decode_clip_train(paths, 106, 96, 5, 5, threads=2, scaled=True))


# -------------------------------------------------------------------- fuzz

def _mutants(data: bytes, rng: np.random.RandomState, n: int):
    """Byte flips (half of them in the header), truncations, extensions."""
    arr = np.frombuffer(data, np.uint8).copy()
    for k in range(n):
        if k % 3 == 0:
            m = arr.copy()
            idx = rng.randint(0, min(64, len(m)) if k % 2 else len(m),
                              size=rng.randint(1, 9))
            m[idx] ^= rng.randint(1, 256, size=idx.size).astype(np.uint8)
            yield m.tobytes()
        elif k % 3 == 1:
            yield data[:rng.randint(0, len(data))]
        else:
            yield data + rng.randint(0, 256, rng.randint(1, 128), dtype=np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["wav", "wav_spec", "jpeg", "jpeg_bytes"])
def test_mutated_files_give_the_jax_package_s_answers(tmp_path, kind):
    """Seeded corruptions of a valid file: the process survives every entry
    point, and the port declines, and decodes, exactly what the JAX package
    does."""
    rng = np.random.RandomState(42)
    if kind.startswith("wav"):
        base = tmp_path / "base.wav"
        write_wav(base, np.clip(rng.randn(8000) * 0.3, -1, 1), 8000)
    else:
        base = _save_jpeg(tmp_path / "base.jpg", rng.randint(0, 255, (48, 64, 3), np.uint8), 90)
    paths = []
    for i, mut in enumerate(_mutants(base.read_bytes(), rng, 30)):
        p = tmp_path / f"m{i}{base.suffix}"
        p.write_bytes(mut)
        paths.append(p)
        if kind == "wav":
            _same(tn.decode_wav_prepared(p, 1, 8000), jn.decode_wav_prepared(p, 1, 8000))
        elif kind == "jpeg":
            assert tn.jpeg_size(p) == jn.jpeg_size(p)
            _same(tn.decode_jpeg(p), jn.decode_jpeg(p))
            _same(tn.decode_jpeg_shortest(p, 96, crop=64), jn.decode_jpeg_shortest(p, 96, crop=64))
        elif kind == "jpeg_bytes":
            for scaled in (False, True):
                _same(tn.decode_jpeg_shortest_bytes(mut, 96, 64, scaled),
                      jn.decode_jpeg_shortest_bytes(mut, 96, 64, scaled))
    if kind == "wav":
        got, want = tn.decode_wav_batch(paths, 1, 8000, 4), jn.decode_wav_batch(paths, 1, 8000, 4)
    elif kind == "wav_spec":
        args = (paths, 1, 8000, 8000, 512, 1, 257, (8000 - 1) // 511)
        got, want = tn.decode_wav_spec_batch(*args, threads=4), jn.decode_wav_spec_batch(
            *args, threads=4)
    else:
        got = tn.decode_jpeg_shortest_batch(paths, 96, 64, threads=4)
        want = jn.decode_jpeg_shortest_batch(paths, 96, 64, threads=4)
        _same(tn.decode_clip_train(paths[:16], 96, 64, 0, 0, threads=4),
              jn.decode_clip_train(paths[:16], 96, 64, 0, 0, threads=4))
    np.testing.assert_array_equal(got[1], want[1])
    ok = got[1] > 0
    np.testing.assert_array_equal(got[0][ok], want[0][ok])


# ------------------------------------------------------------- kill switch

def test_the_kill_switch_forces_the_python_paths_of_the_port_only(tmp_path, monkeypatch,
                                                                  capsys):
    p = _save_jpeg(tmp_path / "t.jpg", _photo(120, 160))
    w = _wav_case(tmp_path, "mono_short")
    monkeypatch.setattr(tn, "_said", set())   # the reason is said once a process
    monkeypatch.setenv(tn.KILL_SWITCH, "1")
    assert tn.disabled() and not tn.available()
    assert tn.decode_jpeg(p) is None and tn.decode_wav_prepared(w, 1, 8000) is None
    assert tn.decode_jpeg_shortest_bytes(p.read_bytes(), 64, 64) is None
    assert tn.build_info() == {}
    assert jn.available()   # the JAX package reads its own switch
    # the callers take their Python paths: PIL, numpy
    from PIL import Image

    want = np.asarray(Image.open(p).convert("RGB").resize(
        tuple(reversed(tn.shortest_side_dims(120, 160, 64))), Image.BICUBIC))
    np.testing.assert_array_equal(tt.host_load_eval_frame(p, 64),
                                  tt.host_center_crop(want, 64))
    assert "AVTUBES_TORCH_NO_NATIVE is set" in capsys.readouterr().err
    monkeypatch.setenv(tn.KILL_SWITCH, "0")
    assert tn.available()
