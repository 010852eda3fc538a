"""The port's real-data loaders on its native IO core, against the JAX
package's.

With native decode on in both packages the training clip, the evaluation
frame, the served frame under `fast=True`, the prepared WAV, the audio
transports and the batched hard-way loader are bit-equal to the JAX
package's on the same files and `RandomState`; with both switched off the
Python paths are too.  The crop a clip draws does not depend on the path
that decoded it, and `make_hardway_loader` picks its mode as the JAX
package does (`AVTUBES_EVAL_LOADER`).
"""

from io import BytesIO

import numpy as np
import pytest

from avtubes import native as jn
from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data import pipeline as jpipe
from avtubes.data import spectrogram as jspec
from avtubes.data import transforms as jt
from avtubes_torch import native as tn
from avtubes_torch.core.config import DataConfig
from avtubes_torch.data import pipeline as tpipe
from avtubes_torch.data import spectrogram as tspec
from avtubes_torch.data import transforms as tt
from avtubes_torch.data.audio import write_wav

SR, SEC, IMG = 8000, 1, 64


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv(tn.KILL_SWITCH, raising=False)
    monkeypatch.delenv("AVTUBES_EVAL_LOADER", raising=False)
    if not (tn.available() and jn.available()):
        pytest.skip("a native library is unavailable (needs g++ and libjpeg)")


@pytest.fixture
def python_only(monkeypatch):
    """Both packages' PIL and numpy paths."""
    monkeypatch.setattr(jn, "available", lambda: False)
    monkeypatch.setenv(tn.KILL_SWITCH, "1")


def _photo(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx / w * 255, yy / h * 255, (xx + yy) / (h + w) * 255], -1)
    return np.clip(img + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _jpeg(path, img, **kw):
    from PIL import Image

    Image.fromarray(img).save(path, quality=90, **kw)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A hard-way tree (frames/<id>.jpg + audio/<id>.wav) and training clips
    (videos/<id>/<i>.jpg) of photo-like JPEGs: one CMYK frame (libjpeg
    declines it, PIL reads it), one undecodable frame, one garbage WAV."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tree")
    for d in ("frames", "audio", "videos"):
        (root / d).mkdir()
    rng = np.random.RandomState(0)
    ids = [f"v{i}" for i in range(7)]
    for i, v in enumerate(ids):
        hw = [(80, 96), (96, 80), (70, 90), (90, 90), (72, 100), (80, 96), (88, 76)][i]
        if v == "v2":
            Image.fromarray(_photo(*hw, i)).convert("CMYK").save(root / "frames" / f"{v}.jpg",
                                                                  quality=90)
        elif v == "v4":
            (root / "frames" / f"{v}.jpg").write_bytes(b"\xff\xd8\xffnot a jpeg")
        else:
            _jpeg(root / "frames" / f"{v}.jpg", _photo(*hw, i))
        if v == "v5":
            (root / "audio" / f"{v}.wav").write_bytes(b"RIFFgarbage-not-a-wave-file")
        else:
            n = SR * SEC if i % 2 else SR * SEC // 3     # some short: tiled
            write_wav(root / "audio" / f"{v}.wav", np.clip(rng.randn(n) * 0.3, -1, 1), SR)
        (root / "videos" / v).mkdir()
        for f in range(3):
            _jpeg(root / "videos" / v / f"{f}.jpg", _photo(*hw, 10 * i + f))
    return root, ids


def _cfgs(transport="int16", **kw):
    args = dict(image_size=IMG, frame_density=3, samplerate=SR, audio_seconds=SEC,
                audio_transport=transport, n_threads=3, **kw)
    return DataConfig(**args), JaxDataConfig(**args)


def _same_batches(got, want):
    assert [b["id"] for b in got] == [b["id"] for b in want]
    for a, b in zip(got, want):
        for k in ("frame", "waveform"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _concat(batches):
    return {"id": [i for b in batches for i in b["id"]],
            **{k: np.concatenate([b[k] for b in batches]) for k in ("frame", "waveform")}}


# ---------------------------------------------------------- training clip

@pytest.mark.parametrize("decode", ["native", "python"])
@pytest.mark.parametrize("clip", ["v0", "v1", "v6"])
def test_host_load_train_clip_equals_the_jax_package_s(tree, clip, decode, request):
    if decode == "python":
        request.getfixturevalue("python_only")
    root, _ = tree
    paths = sorted((root / "videos" / clip).glob("*.jpg"))
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    got = tt.host_load_train_clip(paths, a, IMG, threads=2)
    np.testing.assert_array_equal(got, jt.host_load_train_clip(paths, b, IMG, threads=2))
    assert got.shape == (3, IMG, IMG, 3)
    assert a.randint(1 << 30) == b.randint(1 << 30)


def test_the_crop_does_not_depend_on_the_path_that_decoded(tree, monkeypatch):
    """Fused call, per-frame native (the fused call declined) and PIL (the
    native core off) draw one crop, from frame 0's resized geometry: the
    rng streams stay in step and the clips agree to libjpeg's scaling."""
    root, _ = tree
    paths = sorted((root / "videos" / "v0").glob("*.jpg"))
    rngs = [np.random.RandomState(11) for _ in range(3)]
    fused = tt.host_load_train_clip(paths, rngs[0], IMG)
    monkeypatch.setattr(tn, "decode_clip_train", lambda *a, **k: None)
    per_frame = tt.host_load_train_clip(paths, rngs[1], IMG)
    monkeypatch.setenv(tn.KILL_SWITCH, "1")
    pil = tt.host_load_train_clip(paths, rngs[2], IMG)
    np.testing.assert_array_equal(fused, per_frame)
    assert np.abs(fused.astype(int) - pil.astype(int)).mean() < 4.0
    nxt = {r.randint(1 << 30) for r in rngs}
    assert len(nxt) == 1


def test_clip_train_source_passes_its_decode_threads(tree, monkeypatch):
    root, ids = tree
    seen = []
    real = tn.decode_clip_train
    monkeypatch.setattr(tn, "decode_clip_train",
                        lambda *a, **k: seen.append(k["threads"]) or real(*a, **k))
    t_cfg, j_cfg = _cfgs(clip_decode_threads=3)
    got = tpipe.ClipTrainSource(root, ids, t_cfg).load(0, np.random.RandomState(1))
    want = jpipe.ClipTrainSource(root, ids, j_cfg).load(0, np.random.RandomState(1))
    assert seen == [3]
    for k in ("clip", "waveform"):
        np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------- frames and payloads

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_eval_frames_equal_the_jax_package_s(tree, fmt, fast):
    root, _ = tree
    np.testing.assert_array_equal(tt.host_load_eval_frame(root / "frames" / "v1.jpg", IMG),
                                  jt.host_load_eval_frame(root / "frames" / "v1.jpg", IMG))
    buf = BytesIO()
    from PIL import Image

    Image.fromarray(_photo(120, 160, 3)).save(buf, fmt)
    got = tt.eval_frame_from_bytes(buf.getvalue(), IMG, fast=fast)
    np.testing.assert_array_equal(got, jt.eval_frame_from_bytes(buf.getvalue(), IMG, fast=fast))
    if fast and fmt == "JPEG":
        np.testing.assert_array_equal(got, tn.decode_jpeg_shortest_bytes(
            buf.getvalue(), IMG, IMG, scaled=True))
    else:       # the exact path
        np.testing.assert_array_equal(got, tt.eval_frame_from_bytes(buf.getvalue(), IMG))


@pytest.mark.parametrize("decode", ["native", "python"])
@pytest.mark.parametrize("transport", ["float32", "int16", "spec_int16", "spec_int8"])
def test_load_prepared_wav_equals_the_jax_package_s(tree, transport, decode, request):
    if decode == "python":
        request.getfixturevalue("python_only")
    root, _ = tree
    t_cfg, j_cfg = _cfgs(transport)
    for v in ("v0", "v1"):
        got = tpipe.load_prepared_wav(root / "audio" / f"{v}.wav", t_cfg)
        want = jpipe.load_prepared_wav(root / "audio" / f"{v}.wav", j_cfg)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_a_wav_the_native_core_declines_is_skipped(tree):
    root, _ = tree
    with pytest.raises(tpipe.SkippedSampleError, match="native WAV decode failed"):
        tpipe.load_prepared_wav(root / "audio" / "v5.wav", _cfgs()[0])


@pytest.mark.parametrize("transport", ["spec_int16", "spec_int8"])
def test_prepare_audio_payload_equals_the_jax_package_s(transport):
    t_cfg = tspec.SpectrogramConfig(samplerate=16000, seconds=2)
    j_cfg = jspec.SpectrogramConfig(samplerate=16000, seconds=2)
    waves = np.clip(np.random.RandomState(2).randn(3, t_cfg.num_samples) * 0.3, -1, 1)
    got = tspec.prepare_audio_payload(waves, transport, t_cfg)
    np.testing.assert_array_equal(got, jspec.prepare_audio_payload(waves, transport, j_cfg))
    native_rows = [tn.log_spectrogram_i16(w.astype(np.float32), 16000, t_cfg.nperseg,
                                          t_cfg.noverlap, t_cfg.num_freqs, t_cfg.num_frames)
                   for w in waves]
    if transport == "spec_int16":
        np.testing.assert_array_equal(got, np.stack(native_rows))


# ------------------------------------------------------ hard-way loaders

@pytest.mark.parametrize("transport", ["float32", "int16", "spec_int16", "spec_int8"])
def test_the_batched_loader_equals_the_per_sample_loader_and_the_jax_package_s(tree,
                                                                             transport):
    root, ids = tree
    t_cfg, j_cfg = _cfgs(transport)
    batched = tpipe.BatchedHardwayLoader(root, ids, t_cfg, 3)
    got = list(batched.epoch(0))
    per_sample = tpipe.make_hardway_loader(root, ids, t_cfg, 3, mode="per_sample")
    want = list(per_sample.epoch(0))
    # v2 (CMYK) is retried through PIL; v4 (no JPEG) and v5 (no WAV) are
    # skipped, which the per-sample loader's batches close over
    assert [b["id"] for b in got] == [["v0", "v1", "v2"], ["v3"], ["v6"]]
    assert [b["id"] for b in want] == [["v0", "v1", "v2"], ["v3", "v6"]]
    _same_batches([_concat(got)], [_concat(want)])
    assert batched.skipped == batched.epoch_skipped == per_sample.skipped == 2
    assert len(batched) == 3
    jax_batched = list(jpipe.BatchedHardwayLoader(root, ids, j_cfg, 3).epoch(0))
    _same_batches(got, jax_batched)


def test_the_batched_loader_yields_nothing_for_an_all_bad_batch(tree, capsys):
    root, _ = tree
    loader = tpipe.BatchedHardwayLoader(root, ["v4", "v5"], _cfgs()[0], 2)
    assert list(loader.epoch(3)) == []
    assert loader.skipped == 2
    out = capsys.readouterr().out
    assert "epoch 3: skipping sample: v4" in out and "skipping sample: v5" in out


@pytest.mark.parametrize("env,mode,transport,want", [
    (None, None, "int16", "per_sample"),
    (None, None, "float32", "per_sample"),
    (None, None, "spec_int16", "batched"),
    (None, None, "spec_int8", "batched"),
    ("batched", None, "int16", "batched"),
    ("per_sample", None, "spec_int16", "per_sample"),
    ("batched", "per_sample", "int16", "per_sample"),
    (None, "batched", "int16", "batched"),
])
def test_the_loader_mode_follows_the_jax_package(tree, monkeypatch, env, mode, transport,
                                                 want):
    root, ids = tree
    if env is not None:
        monkeypatch.setenv("AVTUBES_EVAL_LOADER", env)
    t_cfg, j_cfg = _cfgs(transport)
    got = tpipe.make_hardway_loader(root, ids, t_cfg, 2, mode=mode)
    jax = jpipe.make_hardway_loader(root, ids, j_cfg, 2, mode=mode)
    kind = "batched" if isinstance(got, tpipe.BatchedHardwayLoader) else "per_sample"
    jax_kind = "batched" if isinstance(jax, jpipe.BatchedHardwayLoader) else "per_sample"
    assert kind == jax_kind == want
    # without the native core the batched mode falls back to per-sample
    monkeypatch.setenv(tn.KILL_SWITCH, "1")
    assert isinstance(tpipe.make_hardway_loader(root, ids, t_cfg, 2, mode=mode),
                      tpipe.BatchLoader)
