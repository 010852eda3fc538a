"""The TimeSformer tube cell on the CPU at a small size (4 clips of 2
frames at 64^2; the tower 2 blocks of D 96 and 4 heads, in float32, put in
the published tower's place): a sound run is correct, and a run without the
temporal branch, or the float8 control, is not.  Its readers: the
sub-blocks' device time from hand-built spans, and the step's FLOPs.  The
control and the tower's faults at the cell's own size need a card
(`-m card`)."""

import functools
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, readings, run, spans, tower_spans
from perfbench.reference import timesformer

CELL = "fullmodel_train_timesformer"
SMALL_TOWER = {"embed_dim": 96, "depth": 2, "num_heads": 4}


def _overrides() -> dict:
    cfg = harness.load_cell(CELL).config
    vid = {**cfg["nets"]["video"], "img_size": 64, "num_frames": 2, **SMALL_TOWER}
    return {"config": {"compute_dtype": "float32", "image_size": 64, "audio": {"seconds": 1},
                       "nets": {"video": vid}},
            "params": {"batch": 4, "frames": 2, "pool": 3, "log_every": 2, "reference_chunk": 2}}


@pytest.fixture
def small_tower(monkeypatch):
    """The program builds the small tower where it builds TimeSformer-B/16."""
    from avtubes_torch.models import fullmodel

    monkeypatch.setattr(fullmodel, "TimeSformer", functools.partial(
        fullmodel.TimeSformer, dim=96, depth=2, heads=4))


def temporal_skipped(monkeypatch):
    """Every block leaves out its temporal attention."""
    from avtubes_torch.models.timesformer import Block

    monkeypatch.setattr(Block, "temporal", lambda self, x, frames: x)


def spatial_across_frames(monkeypatch):
    """Every block's spatial attention spans all the clip's frames at once."""
    from avtubes_torch.models.timesformer import Block, _norm

    def across(self, cls, x, frames):
        r = self.attn(_norm(torch.cat([cls, x], dim=1), self.norm1))
        return cls + r[:, :1], x + r[:, 1:]

    monkeypatch.setattr(Block, "spatial", across)


def test_a_sound_run_is_correct(small_tower):
    out = run.execute(CELL, 2 ** 31 + 3, 1.0, False, device="cpu", overrides=_overrides())
    assert out["correct"] is True, out["checks"]


def test_a_run_without_the_temporal_branch_is_not_correct(small_tower, monkeypatch):
    temporal_skipped(monkeypatch)
    out = run.execute(CELL, 2 ** 31 + 3, 1.0, False, device="cpu", overrides=_overrides())
    failed = [c.name for c in out["checks"] if not c.passed]
    assert out["correct"] is False and failed, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", [temporal_skipped, spatial_across_frames],
                         ids=lambda f: f.__name__)
def test_a_broken_tower_is_not_correct_at_the_cell_s_size(fault, card, monkeypatch):
    """At the cell's size the check's gradients and changes see these two
    faults; the cls token's residual taken from the first frame alone moves
    them less than bf16 rounding does (`PERF.md` section 2), and only the
    float32 comparison of `tests/test_torch_port_timesformer.py` sees it."""
    fault(monkeypatch)
    cell = harness.load_cell(CELL)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    got = readings.reading(cell, gen, 2 ** 31 + 77, "program", card)
    assert any(got[k] > v for k, v in harness.limits_of(cell).items()), got


def test_the_control_fails_a_limit_at_a_small_size():
    cell = harness.load_cell(CELL, _overrides())
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    got = readings.reading(cell, gen, 2 ** 31 + 77, "control", torch.device("cpu"))
    assert any(got[k] > v for k, v in harness.limits_of(cell).items()), got


@pytest.mark.card
def test_the_control_fails_a_limit_at_the_cell_s_size(card):
    cell = harness.load_cell(CELL)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic"
                                   / f"{cell.spec['generator']}.py")
    got = readings.reading(cell, gen, 2 ** 31 + 77, "control", card)
    assert any(got[k] > v for k, v in harness.limits_of(cell).items()), got


def _span(name, sid, parent, device_ms=None):
    return SimpleNamespace(name=name, id=sid, parent=parent, device_ms=device_ms)


def test_the_sub_block_readers_sum_the_forward_s_spans_and_leave_out_the_recomputation(
        monkeypatch):
    # two steps; step 1's forward holds two blocks' spans, one of them under
    # a nested span, its backward the recomputation's; step 2 one block's
    recorded = [_span("train.forward", 11, 10), _span("train.backward", 12, 10),
                _span("vid.temporal", 13, 11, 1.0), _span("vid.mlp", 14, 11, 4.0),
                _span("encode", 15, 11), _span("vid.temporal", 16, 15, 2.0),
                _span("vid.temporal", 17, 12, 50.0),
                _span("train.forward", 21, 20), _span("vid.temporal", 22, 21, 5.0)]
    steps = [SimpleNamespace(parts={"train.forward": recorded[0]}),
             SimpleNamespace(parts={"train.forward": recorded[7]})]
    monkeypatch.setattr(spans, "steps", lambda run: steps)
    monkeypatch.setattr(spans, "recorded", lambda: (recorded, "cudaStreamQuery"))
    assert tower_spans.forward_device_ms(None, "vid.temporal") == 4.0      # median of 3, 5
    assert tower_spans.forward_device_ms(None, "vid.mlp") == 4.0
    assert tower_spans.forward_device_ms(None, "vid.spatial") is None
    monkeypatch.setattr(spans, "recorded", lambda: None)                   # an older program
    assert tower_spans.forward_device_ms(None, "vid.temporal") is None


def test_mfu_reads_the_reference_s_flops_over_the_window():
    reader = harness.load_file_module(harness.BENCH_DIR / "metrics"
                                      / "mfu.train_timesformer.py")
    cell = harness.load_cell(CELL)
    flops = timesformer.train_step_flops(cell.config, cell.params["batch"])
    assert 46.5e12 < flops < 48.5e12     # ~15.7 TFLOP forward, three times, with the audio tower
    window = {"steps": 10, "window_s": 2.0}
    data = run.RunData(cell, "train", 1.0, window, None, None, {"bfloat16": 1e15})
    assert reader.read(data) == pytest.approx(100 * flops * 5 / 1e15)
    assert reader.read(run.RunData(cell, "train", 1.0, window, None, None, None)) is None


def test_the_configuration_is_timesformer_b16_at_its_published_widths():
    cfg = harness.load_cell(CELL).config
    vid = cfg["nets"]["video"]
    assert (vid["embed_dim"], vid["depth"], vid["num_heads"], vid["mlp_ratio"],
            vid["patch_size"], vid["layer_norm_eps"]) == (768, 12, 12, 4.0, 16, 1e-6)
    assert cfg["reduced"] == []
    count = timesformer.parameter_count(vid)
    assert 121e6 < count < 123e6, count          # 121.3 M and the 0.39 M of `proj`
