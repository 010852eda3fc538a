"""The port's serving tools against the JAX package's: `tools/loadtest.py`
(the same request bytes; a sweep against a live port server that serves an
int8 artifact on the CPU), `cli/profile.py` in its three modes on the CPU,
and `utils/debug.py` (`shape_report` against the JAX package's report,
`trace`, `StepTimer`)."""

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
