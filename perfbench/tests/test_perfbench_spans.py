"""The `program_span` readers on a hand-built trace and spans whose clock
lies a known offset from the trace's: the alignment by the anchor calls,
each part's device time, the host time of a step, and the device's idle
time inside steps (a gap under a synchronise in `train.input` counts toward
both idle metrics, one between steps toward neither)."""

import math
from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.run import RunData
from perfbench.trace import Trace

H0 = 1_790_000_000_000_000_000      # host ns at the trace's 0 less OFFSET
OFFSET = 100.0                      # trace us at host H0
ANCHOR = "cudaStreamQuery"
METRICS = ["input_device_ms.train", "forward_device_ms.train", "backward_device_ms.train",
           "optimizer_device_ms.train", "step_host_ms.train", "step_idle_ms.train",
           "sync_idle_ms.train"]


def _ns(us: float) -> int:
    return H0 + round(us * 1e3)


def _span(name, sid, parent, start_us, end_us, device_ms=None, anchor_us=None):
    return SimpleNamespace(
        name=name, id=sid, parent=parent, step=sid // 10, host_start_ns=_ns(start_us),
        host_end_ns=_ns(end_us), host_ms=(end_us - start_us) / 1e3, device_ms=device_ms,
        anchor_ns=(_ns(anchor_us), _ns(anchor_us + 1)) if anchor_us is not None else None)


def _step(base: int, t0: float, bounds: list[float], device: list[float]) -> list:
    """A root at `t0` and its four parts between `bounds`, with device ms."""
    out = [_span("train.step", base, None, t0, bounds[-1] + 10, sum(device), t0 + 1)]
    for i, name in enumerate(spans.PARTS):
        out.append(_span(name, base + 1 + i, base, bounds[i], bounds[i + 1], device[i]))
    return out


def _recorded():
    # host us: step 1 over 0..1000, step 2 over 1100..2000
    return (_step(10, 0, [2, 200, 500, 800, 990], [1.0, 4.0, 8.0, 2.0])
            + _step(20, 1100, [1102, 1300, 1600, 1800, 1990], [3.0, 6.0, 8.0, 2.0]), ANCHOR)


def _trace() -> Trace:
    t = OFFSET
    host = sorted([
        (t + 1, t + 2, ANCHOR),                          # step 1's anchor
        (t + 3, t + 8, "cudaLaunchKernel"),
        (t + 50, t + 150, "cudaStreamSynchronize"),      # in step 1's train.input
        (t + 600, t + 601, ANCHOR),                      # a query of someone else's
        (t + 1101, t + 1102, ANCHOR),                    # step 2's anchor
        (t + 1103, t + 1110, "cudaLaunchKernel"),
    ])
    device = [(t + 10, t + 60, "k1", "kernel"), (t + 140, t + 1000, "k2", "kernel"),
              (t + 1150, t + 1400, "k3", "kernel"), (t + 1420, t + 2000, "k4", "kernel")]
    return Trace((t + 0, t + 2010), device, host)


def _run(trace=None) -> RunData:
    return RunData(cell=None, kind="train", setup_s=0.0, window={}, tail={"steps": 2},
                   trace=_trace() if trace is None else trace, peaks=None)


def _read(name: str, run: RunData):
    return harness.load_file_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "recorded", _recorded)


def test_the_anchors_align_the_spans_and_a_decoy_call_is_not_taken(recorded, capsys):
    steps = spans.steps(_run())
    assert len(steps) == 2
    assert math.isclose(steps[0].start_us, OFFSET) and math.isclose(steps[1].start_us,
                                                                     OFFSET + 1100)
    # each step's first runtime call (its anchor) starts 1 us after it
    assert [s.misfit_us for s in steps] == pytest.approx([1.0, 1.0])
    assert '"misfit_us_worst": 1.0' in capsys.readouterr().err


def test_a_wide_first_anchor_does_not_set_the_offset(monkeypatch):
    got, call = _recorded()
    # a session's first anchor can take milliseconds between its reads
    first = next(s for s in got if s.anchor_ns)
    first.anchor_ns = (first.anchor_ns[0], first.anchor_ns[0] + 1_900_000)
    got += _step(30, 2100, [2102, 2300, 2600, 2800, 2990], [3.0, 6.0, 8.0, 2.0])
    monkeypatch.setattr(spans, "recorded", lambda: (got, call))
    t = _trace()
    third = Trace((t.window[0], OFFSET + 3010), t.device,
                  sorted(t.host + [(OFFSET + 2101, OFFSET + 2102, ANCHOR)]))
    steps = spans.steps(_run(third))
    assert [s.start_us for s in steps] == pytest.approx([OFFSET + 0, OFFSET + 1100,
                                                         OFFSET + 2100])


@pytest.mark.parametrize("name,want", [
    ("input_device_ms.train", 2.0), ("forward_device_ms.train", 5.0),
    ("backward_device_ms.train", 8.0), ("optimizer_device_ms.train", 2.0),
    ("step_host_ms.train", (1.0 + 0.9) / 2),
    # step 1: the window's first 10 us (in train.input) and the 80 us under
    # the synchronise; step 2: 20 us in train.forward
    ("step_idle_ms.train", (0.09 + 0.02) / 2),
    ("sync_idle_ms.train", (0.08 + 0.0) / 2),
])
def test_each_reader_on_the_hand_built_trace(recorded, name, want):
    assert _read(name, _run()) == pytest.approx(want)


def test_idle_under_a_synchronise_in_input_counts_and_between_steps_does_not(recorded):
    per = spans.idle_by_step(_run())
    assert per[0]["train.input"] == pytest.approx(0.09) and per[0]["sync"] == pytest.approx(0.08)
    assert per[1]["train.forward"] == pytest.approx(0.02) and per[1]["sync"] == 0.0
    # the 150 us gap between the steps (its middle at host 1075 us) is in neither
    assert sum(spans.step_idle(p) for p in per) == pytest.approx(0.11)


def test_without_the_recorder_or_the_anchor_call_every_reader_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert all(_read(name, _run()) is None for name in METRICS)
    monkeypatch.setattr(spans, "recorded", _recorded)
    t = _trace()
    bare = Trace(t.window, t.device, [h for h in t.host if h[2] != ANCHOR])
    assert all(_read(name, _run(bare)) is None for name in METRICS)


def test_the_program_s_recorder_is_what_the_readers_read():
    from avtubes_torch.utils import debug

    got = spans.recorded()
    assert got is not None and got[1] == debug.ANCHOR_CALL == ANCHOR
