"""The port's tools against the JAX package's: `tools/loadtest.py` (the
same request bytes; a sweep against a live port server that serves an int8
artifact on the CPU), `cli/profile.py` in its three modes on the CPU (and
the training modes' table of the step's parts), `utils/debug.py`
(`shape_report` against the JAX package's report, `trace`, `StepTimer`),
`data/sampler.py` against the JAX package's sampler, the offline dataset
tools (`tools/validate`, `create_training_set`, `convert_to_jpg`,
`convert_jpg_to_mp4`, `download_flickr`: offline only) and `cli/doctor`
with `--device cpu`."""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models import AVENet as JaxAVENet
from avtubes.tools import loadtest as jax_loadtest
from avtubes.utils.debug import shape_report as jax_shape_report
from avtubes_torch.cli import profile
from avtubes_torch.cli.serve import LocalizerHTTPServer, build_handler
from avtubes_torch.core.export import export_localizer
from avtubes_torch.core.serving import ArtifactRunner, MicroBatcher
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.tools import loadtest
from avtubes_torch.utils.debug import StepTimer, shape_report, trace

torch.set_num_threads(2)
IMG = 32
TINY = ["--device", "cpu", "--steps", "2", "--batch_size", "2", "--image_size", str(IMG),
        "--frame_density", "2", "--samplerate", "8000", "--audio_seconds", "1"]


@pytest.mark.parametrize("source_hw", [None, (48, 40)])
def test_synth_payload_is_the_jax_tool_s_bytes(source_hw):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        assert (loadtest.synth_payload(a, IMG, 8000, 1, source_hw=source_hw)
                == jax_loadtest.synth_payload(b, IMG, 8000, 1, source_hw=source_hw))


@pytest.fixture()
def int8_server():
    """A live port server on the CPU, in this process, serving an int8
    artifact of seeded weights."""
    model = AVENet(generator=torch.Generator().manual_seed(0), quant_int8=True)
    blob = export_localizer(model, SpectrogramConfig(samplerate=8000, seconds=1),
                            image_size=IMG)
    runner = ArtifactRunner(blob, max_batch=4, device="cpu")
    batcher = MicroBatcher(runner, window_ms=2.0)
    handler = build_handler(batcher, runner.meta, request_timeout_s=120.0)
    handler.log_message = lambda self, fmt, *args: None
    srv = LocalizerHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        batcher.close()
        assert not thread.is_alive()


def test_loadtest_against_a_live_int8_server(int8_server, capsys):
    """What tests/test_serving.py:387-407 asserts of the JAX tool, and the
    artifact's quant in /healthz and /stats."""
    loadtest.main(["--url", int8_server, "--concurrency", "1,2", "--requests", "4",
                   "--payloads", "2", "--timeout_s", "300"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    server_line = next(ln for ln in lines if "server" in ln)
    assert server_line["server"]["image_size"] == IMG
    assert server_line["server"]["quant"] == "int8"
    levels = [ln for ln in lines if "concurrency" in ln]
    assert len(levels) == 2
    for level in levels:
        assert level["errors"] == 0
        assert level["ok"] == 4
        assert level["requests_per_sec"] > 0
        assert level["p50_ms"] > 0
        assert level["server_stats"]["batches"] >= 1
        assert level["server_stats"]["quant"] == "int8"


@pytest.mark.parametrize("mode", [["infer"], ["infer", "--quant", "int8"], ["train"],
                                  ["train3d"]], ids=["infer", "infer_int8", "train", "train3d"])
def test_profile_runs_each_mode_on_the_cpu_and_writes_a_trace(tmp_path, capsys, mode):
    times = profile.main(["--mode", *mode, *TINY, "--logdir", str(tmp_path)])
    assert len(times) == 2 and all(t > 0 for t in times)
    printed = capsys.readouterr().out
    assert "step 1:" in printed and "clips/s" in printed and str(tmp_path) in printed
    (written,) = tmp_path.glob("*.pt.trace.json")
    assert json.loads(written.read_text())["traceEvents"]


@pytest.mark.parametrize("mode", ["train", "train3d"])
def test_profile_prints_the_step_s_parts_on_the_cpu(tmp_path, capsys, mode):
    profile.main(["--mode", mode, *TINY, "--logdir", str(tmp_path)])
    printed = capsys.readouterr().out.splitlines()
    head = next(i for i, line in enumerate(printed) if line.startswith("span "))
    assert printed[head].split() == ["span", "count", "host", "ms", "device", "ms", "idle", "ms"]
    rows = {line.split()[0]: line.split()[1:] for line in printed[head + 1:head + 6]}
    assert list(rows) == ["train.step", "train.input", "train.forward", "train.backward",
                          "train.optimizer"]
    for count, host_ms, device_ms, idle_ms in rows.values():
        # two traced steps; no card, so no device or idle time
        assert count == "2" and float(host_ms) > 0 and device_ms == idle_ms == "-"


def test_shape_report_totals_the_jax_package_s():
    report = shape_report(AVENet, quant_int8=True)      # the quant model: the same tensors
    want = jax_shape_report(JaxAVENet(), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 257, 15, 1)))
    assert report.splitlines()[-1] == want.splitlines()[-1]
    assert len(report.splitlines()) == len(want.splitlines())
    assert "num_batches_tracked" not in report
    assert "imgnet.layer4.1.conv2.weight" in report


def test_step_timer_and_trace_on_the_cpu(tmp_path):
    timer = StepTimer()
    assert np.isnan(timer.mean())
    with trace(str(tmp_path), "cpu") as log_dir:
        for _ in range(3):
            time.sleep(0.01)
            timer.tick(torch.ones(2) * 2)
    assert log_dir == str(tmp_path) and len(timer.history) == 3
    assert all(dt >= 0.009 for dt in timer.history)
    assert timer.mean(last=2) == pytest.approx(np.mean(timer.history[-2:]))
    assert list(tmp_path.glob("*.pt.trace.json"))


# ------------------------------------------------ sampler and dataset tools

@pytest.mark.parametrize("length", [2, 5, 17, 100, 256, 257, 300, 1000])
@pytest.mark.parametrize("num,stride", [(16, 16), (16, 1), (8, 4), (4, 2), (2, 30)])
def test_the_sampler_is_the_jax_package_s(length, num, stride):
    from avtubes.data.sampler import sample_frame_indices as jax_sample
    from avtubes_torch.data.sampler import sample_frame_indices

    for wrap in (True, False):
        got = sample_frame_indices(length, num, stride, wrap=wrap)
        assert got == jax_sample(length, num, stride, wrap=wrap)
        assert len(got) == num
        if wrap:
            assert all(0 <= i < length for i in got)


def _write_mp4(path, frames=8, size=32):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (size, size))
    rng = np.random.RandomState(0)
    for _ in range(frames):
        writer.write(rng.randint(0, 255, (size, size, 3), dtype=np.uint8))
    writer.release()


def test_good_video_and_audio(tmp_path):
    from avtubes_torch.data.audio import write_wav
    from avtubes_torch.tools.validate import good_audio, good_video

    _write_mp4(tmp_path / "v.mp4")
    assert good_video(tmp_path / "v.mp4")
    (tmp_path / "bad.mp4").write_bytes(b"not a video")
    assert not good_video(tmp_path / "bad.mp4")
    write_wav(tmp_path / "a.wav", np.zeros(22050 * 2), 22050)
    assert good_audio(tmp_path / "a.wav")
    write_wav(tmp_path / "s.wav", np.zeros(100), 22050)
    assert not good_audio(tmp_path / "s.wav")


def test_prune_corrupt_pairs(tmp_path):
    from avtubes.tools.validate import prune_corrupt_pairs as jax_prune
    from avtubes_torch.data.audio import write_wav
    from avtubes_torch.tools.validate import prune_corrupt_pairs

    (tmp_path / "videos").mkdir()
    (tmp_path / "audio").mkdir()
    _write_mp4(tmp_path / "videos" / "good1.mp4")
    write_wav(tmp_path / "audio" / "good1.wav", np.zeros(44100), 22050)
    _write_mp4(tmp_path / "videos" / "noaudio.mp4")
    (tmp_path / "videos" / "corrupt.mp4").write_bytes(b"xx")
    write_wav(tmp_path / "audio" / "corrupt.wav", np.zeros(44100), 22050)
    bad = prune_corrupt_pairs(tmp_path, dry_run=True)
    assert sorted(bad) == ["corrupt", "noaudio"] == sorted(jax_prune(tmp_path, dry_run=True))
    assert (tmp_path / "videos" / "corrupt.mp4").exists()    # a dry run keeps files
    prune_corrupt_pairs(tmp_path, dry_run=False)
    assert not (tmp_path / "videos" / "corrupt.mp4").exists()
    assert (tmp_path / "videos" / "good1.mp4").exists()


def test_match_urls_to_ids_offline():
    from avtubes.tools.download_flickr import match_urls_to_ids as jax_match
    from avtubes_torch.tools.download_flickr import match_urls_to_ids

    urls = ["http://x.com/vid/12345_hd.mp4", "http://x.com/vid/99999.mp4"]
    ids = ["12345", "55555", "999"]
    assert match_urls_to_ids(urls, ids) == jax_match(urls, ids) == {
        "12345": "http://x.com/vid/12345_hd.mp4", "999": "http://x.com/vid/99999.mp4"}


def test_training_subsets_are_the_jax_package_s(tmp_path, capsys):
    from avtubes.tools.create_training_set import sample_subsets as jax_subsets
    from avtubes_torch.data.audio import write_wav
    from avtubes_torch.tools.create_training_set import eligible_ids, main, sample_subsets

    for d in ("videos", "audio", "md"):
        (tmp_path / d).mkdir()
    for i in range(20):
        (tmp_path / "videos" / f"{i}.mp4").write_bytes(b"x")
        write_wav(tmp_path / "audio" / f"{i}.wav", np.zeros(100), 100)
    (tmp_path / "md" / "flickr_test.csv").write_text("3,0\n4,0\n")
    pool = eligible_ids(tmp_path, exclude={"3", "4"})
    assert "3" not in pool and len(pool) == 18
    assert sample_subsets(pool, [1], seed=7) == jax_subsets(pool, [1], seed=7)
    main(["--root", str(tmp_path), "--metadata_dir", str(tmp_path / "md"), "--sizes", "1"])
    assert "eligible pool: 18 ids (2 excluded)" in capsys.readouterr().out
    rows = (tmp_path / "md" / "flickr_train1k.csv").read_text().splitlines()
    assert len(rows) == 18 and all(r.endswith(",0") for r in rows)


def test_convert_jpg_mp4_round_trip(tmp_path):
    pytest.importorskip("cv2")
    from PIL import Image

    from avtubes_torch.tools.convert_jpg_to_mp4 import frames_to_mp4
    from avtubes_torch.tools.convert_to_jpg import extract_clip
    from avtubes_torch.tools.validate import good_video

    fdir = tmp_path / "frames"
    fdir.mkdir()
    rng = np.random.RandomState(1)
    for i in range(6):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(fdir / f"{i}.jpg")
    mp4 = tmp_path / "out.mp4"
    assert frames_to_mp4(fdir, mp4, fps=5) == 6
    assert good_video(mp4)
    out = tmp_path / "extracted"
    assert extract_clip(mp4, out, frames=4, stride=2)
    assert sorted(p.name for p in out.glob("*.jpg")) == ["0.jpg", "1.jpg", "2.jpg", "3.jpg"]
    with pytest.raises(ValueError, match="no JPEGs"):
        frames_to_mp4(tmp_path / "extracted_none", tmp_path / "x.mp4")


# ------------------------------------------------------------------ doctor

def test_doctor_on_the_cpu_passes_a_synthetic_tree(tmp_path, capsys):
    from avtubes_torch.cli.doctor import main
    from avtubes_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(tmp_path, n_videos=2)
    rc = main(["--data_path", str(tmp_path), "--og_data_path", str(tmp_path),
               "--metadata_dir", str(tmp_path / "metadata"), "--device", "cpu",
               "--spot", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "doctor: OK" in out
    assert out.count("[PASS]") >= 4
    assert "[PASS] device     --device cpu" in out
    assert "2/2 clips spot-decoded" in out and "2/2 frames spot-decoded" in out


def test_doctor_fails_on_a_missing_tree_and_without_a_card(tmp_path, capsys):
    from avtubes_torch.cli.doctor import main

    (tmp_path / "videos").mkdir()
    rc = main(["--data_path", str(tmp_path), "--skip_device"])
    out = capsys.readouterr().out
    assert rc == 1 and "doctor: FAIL" in out and "[WARN] device     skipped" in out
    if torch.cuda.is_available():
        return
    rc = main(["--og_data_path", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "[FAIL] device     no CUDA card visible" in out
