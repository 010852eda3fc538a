"""The Video Swin tube cell on the CPU at a small size (4 clips of 4 frames
at 64^2; the tower D 32, depths (2, 2, 2, 2), heads (2, 4, 4, 8), windows
(2, 2, 2) shifted by (1, 1, 1), in float32, put in the published tower's
place): a sound run is correct, and a run with the shift skipped, or the
float8 control, is not.  Its readers: the window attention's and the
merges' device time from hand-built spans, and the step's FLOPs; the
configuration's published widths; the reference's imports.  The control
and the tower's faults at the cell's own size need a card (`-m card`)."""

import functools
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, readings, run, spans, tower_spans
from perfbench.reference import swin3d

CELL = "fullmodel_train_swin3d"
SMALL_TOWER = {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [2, 4, 4, 8],
               "window_size": [2, 2, 2], "shift_size": [1, 1, 1]}


def _overrides() -> dict:
    cfg = harness.load_cell(CELL).config
    vid = {**cfg["nets"]["video"], "img_size": 64, "num_frames": 4, **SMALL_TOWER}
    return {"config": {"compute_dtype": "float32", "image_size": 64, "audio": {"seconds": 1},
                       "nets": {"video": vid}},
            "params": {"batch": 4, "frames": 4, "pool": 3, "log_every": 2, "reference_chunk": 2}}


@pytest.fixture
def small_tower(monkeypatch):
    """The program builds the small tower where it builds Video Swin-B."""
    from avtubes_torch.models import fullmodel

    monkeypatch.setattr(fullmodel, "Swin3D", functools.partial(
        fullmodel.Swin3D, dim=32, depths=(2, 2, 2, 2), heads=(2, 4, 4, 8), window=(2, 2, 2)))


def shift_skipped(monkeypatch):
    """Every odd block runs unshifted: no roll and no mask."""
    from avtubes_torch.models import swin3d as port

    clip = port.window_and_shift
    monkeypatch.setattr(port, "window_and_shift",
                        lambda grid, window, shift: (clip(grid, window, shift)[0], (0, 0, 0)))


def mask_dropped(monkeypatch):
    """The shifted windows attend across the wrap of the rolled grid."""
    from avtubes_torch.models import swin3d as port

    monkeypatch.setattr(port, "window_mask", lambda grid, window, shift, device: None)


def bias_dropped(monkeypatch):
    """No relative-position bias."""
    from avtubes_torch.models.swin3d import WindowAttention3D

    monkeypatch.setattr(WindowAttention3D, "position_bias",
                        lambda self, n: self.relative_position_bias_table.new_zeros(
                            self.heads, n, n))


FAULTS = (shift_skipped, mask_dropped, bias_dropped)


def test_a_sound_run_is_correct(small_tower):
    out = run.execute(CELL, 2 ** 31 + 3, 1.0, False, device="cpu", overrides=_overrides())
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_tower_is_not_correct_at_a_small_size(fault, small_tower, monkeypatch):
    fault(monkeypatch)
    out = run.execute(CELL, 2 ** 31 + 3, 1.0, False, device="cpu", overrides=_overrides())
    failed = [c.name for c in out["checks"] if not c.passed]
    assert out["correct"] is False and failed, out["checks"]


@pytest.mark.card
def test_a_tower_without_its_bias_is_not_correct_at_the_cell_s_size(card, monkeypatch):
    """At the cell's size the check sees the bias dropped (its tables get no
    gradient); the shift skipped and the mask dropped move its numbers less
    than bf16 rounding does at the published N(0, 0.02) start (`PERF.md`
    section 2), and only the float32 comparisons of
    `tests/test_torch_port_swin3d.py` and of the small runs above see them."""
    bias_dropped(monkeypatch)
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


@pytest.mark.parametrize("metric,name", [("window_attn_device_ms.train", "vid.window_attn"),
                                         ("merge_device_ms.train", "vid.merge")])
def test_the_readers_sum_the_forward_s_spans_and_leave_out_the_recomputation(
        metric, name, monkeypatch):
    # two steps; step 1's forward holds two spans, one under a nested span,
    # its backward the recomputation's; step 2 one
    recorded = [_span("train.forward", 11, 10), _span("train.backward", 12, 10),
                _span(name, 13, 11, 1.0), _span("encode", 15, 11), _span(name, 16, 15, 2.0),
                _span(name, 17, 12, 50.0), _span("train.forward", 21, 20),
                _span(name, 22, 21, 5.0)]
    steps = [SimpleNamespace(parts={"train.forward": recorded[0]}),
             SimpleNamespace(parts={"train.forward": recorded[6]})]
    monkeypatch.setattr(spans, "steps", lambda run: steps)
    monkeypatch.setattr(spans, "recorded", lambda: (recorded, "cudaStreamQuery"))
    reader = harness.load_file_module(harness.BENCH_DIR / "metrics" / f"{metric}.py")
    assert reader.read(None) == 4.0                                    # median of 3, 5
    assert tower_spans.forward_device_ms(None, "vid.other") is None
    monkeypatch.setattr(spans, "recorded", lambda: None)               # an older program
    assert reader.read(None) is None


def test_mfu_reads_the_reference_s_flops_over_the_window():
    reader = harness.load_file_module(harness.BENCH_DIR / "metrics" / "mfu.train_swin3d.py")
    cell = harness.load_cell(CELL)
    flops = swin3d.train_step_flops(cell.config, cell.params["batch"])
    tower = swin3d.tower_flops(cell.config["nets"]["video"], 1)
    assert 680e9 < tower < 700e9, tower          # ~344 GMAC a clip of 16 frames at 224^2
    assert 41e12 < flops < 44e12, flops          # the tower x 20 x 3, the audio tower, the head
    window = {"steps": 10, "window_s": 2.0}
    data = run.RunData(cell, "train", 1.0, window, None, None, {"bfloat16": 1e15})
    assert reader.read(data) == pytest.approx(100 * flops * 5 / 1e15)
    assert reader.read(run.RunData(cell, "train", 1.0, window, None, None, None)) is None


def test_the_configuration_is_swin_b_at_its_published_widths():
    cfg = harness.load_cell(CELL).config
    vid = cfg["nets"]["video"]
    assert (vid["embed_dim"], vid["depths"], vid["num_heads"], vid["window_size"],
            vid["shift_size"], vid["mlp_ratio"], vid["layer_norm_eps"]) == (
        128, [2, 2, 18, 2], [4, 8, 16, 32], [8, 7, 7], [4, 3, 3], 4.0, 1e-5)
    assert vid["patch_size"] == [1, 4, 4] and vid["merge_strides"] == [2, 2, 1]
    assert cfg["reduced"] == []
    count = swin3d.parameter_count(vid)
    # Swin-B's backbone, the last merge's 4C -> 2C map cut to C -> 2C (-1.57 M), `proj`
    assert 86.4e6 < count < 86.7e6, count


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.reference import swin3d\n"
            "import perfbench.weights_swin3d\n"
            "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    tops = set(out.stdout.split())
    assert "avtubes_torch" not in tops and not tops & set(harness.FORBIDDEN_MODULES), tops
