"""The training step's spans (`utils/debug.py::span`, `train/steps.py`) on
the CPU at a tiny size: none recorded, and no profiler range (the
`RecordFunction` of `torch.profiler.record_function`) opened, with no
profiler running; under one, each step's tree (the root
`train.step` and its parts, one step id) with host intervals on the clock
of the exported Chrome trace; and a step's results bit-identical with
tracing on and off."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from avtubes_torch.core.config import OptimConfig
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.transforms import sample_augment_draws
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.train import steps
from avtubes_torch.train.state import create_train_state
from avtubes_torch.utils import debug

torch.set_num_threads(2)
B, T, IMG = 2, 2, 32
SPEC = SpectrogramConfig(samplerate=8000, seconds=1)
PARTS = ["train.input", "train.forward", "train.backward", "train.optimizer"]
KINDS = ["flagship", "tube3d", "1frame"]
#: how far a span's host start or end may lie from its own annotation's
ANNOTATION_US = 50.0


def _state(kind: str):
    model = (FullModel if kind == "tube3d" else AVENet)(
        generator=torch.Generator().manual_seed(0))
    return create_train_state(model, OptimConfig(learning_rate=1e-3))


def _inputs(kind: str, seed: int = 1) -> tuple:
    g = torch.Generator().manual_seed(seed)
    waves = (torch.randn(B, SPEC.num_samples, generator=g) * 0.1).clamp(-1, 1)
    if kind == "1frame":
        frames = torch.randint(0, 256, (B, IMG, IMG, 3), generator=g, dtype=torch.uint8)
        return frames, waves, torch.tensor([True, False])
    clips = torch.randint(0, 256, (B, T, IMG, IMG, 3), generator=g, dtype=torch.uint8)
    if kind == "tube3d":
        return clips, waves, torch.tensor([False, True])
    return clips, waves, sample_augment_draws(B, g, "random", IMG)


def _step(kind: str, state, inputs: tuple) -> dict:
    if kind == "flagship":
        return steps.hardway_fused_train_step(state, *inputs, SPEC, 0.1, IMG)
    if kind == "tube3d":
        return steps.train3d_fused_step(state, *inputs, SPEC)
    return steps.hardway_1frame_fused_step(state, *inputs, SPEC)


@pytest.fixture(scope="module")
def warm():
    """A first profiler range in a process takes about a millisecond to
    start; warm it before any interval is compared."""
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("warm"):
            pass


def test_off_a_step_records_no_span_and_opens_no_profiler_range(monkeypatch):
    entered = []
    enter = torch._C._autograd._record_function_with_args_enter

    def spy(name, *args):
        if name.startswith("train."):
            entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter", spy)
    debug.clear_spans()
    state = _state("flagship")
    _step("flagship", state, _inputs("flagship"))
    assert entered == [] and debug.finished_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):     # the spy sees spans when on
        _step("flagship", state, _inputs("flagship"))
    assert entered == ["train.step", *PARTS]


def _annotation_misfit_us(spans: list, trace_file) -> float:
    """The largest distance between a span's host start or end and its own
    annotation's in the exported trace, with the trace's base added back."""
    data = json.loads(trace_file.read_text())
    base = int(data["baseTimeNanoseconds"])
    annotations = {e["name"]: e for e in data["traceEvents"]
                   if e.get("cat") == "user_annotation" and e["name"].startswith("train.")}
    assert set(annotations) == {s.name for s in spans}
    worst = 0.0
    for s in spans:
        e = annotations[s.name]
        worst = max(worst, abs((s.host_start_ns - base) / 1e3 - e["ts"]),
                    abs((s.host_end_ns - base) / 1e3 - (e["ts"] + e["dur"])))
    return worst


@pytest.mark.parametrize("kind", KINDS)
def test_a_step_under_the_profiler_records_its_tree_on_the_trace_s_clock(tmp_path, warm,
                                                                         kind):
    state = _state(kind)
    _step(kind, state, _inputs(kind))                  # the step id advances
    # a host thread descheduled between a host read and the profiler's stamp
    # moves one reading by milliseconds: up to three traced steps, one of
    # which must fit
    for attempt in range(3):
        step_id = state.step
        debug.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _step(kind, state, _inputs(kind, 2))
        spans = debug.finished_spans()
        assert sorted(s.name for s in spans) == sorted(["train.step", *PARTS])
        (root,) = [s for s in spans if s.name == "train.step"]
        assert root.parent is None and root.step == step_id and root.events is None
        for s in spans:
            assert s.step == step_id and s.device_ms is None
            if s is not root:
                assert s.parent == root.id
                assert root.host_start_ns <= s.host_start_ns <= s.host_end_ns <= root.host_end_ns
        assert [s.name for s in sorted(spans, key=lambda s: s.host_start_ns)] == \
            ["train.step", *PARTS]
        path = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(path))
        misfit = _annotation_misfit_us(spans, path)
        if misfit <= ANNOTATION_US:
            break
    assert misfit <= ANNOTATION_US


def test_an_unfused_step_records_its_root_and_three_parts():
    state = _state("1frame")
    frames = torch.randn(B, IMG, IMG, 3, generator=torch.Generator().manual_seed(3))
    spec = torch.randn(B, 257, 32, 1, generator=torch.Generator().manual_seed(4))
    debug.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        steps.hardway_1frame_train_step(state, frames, spec)
    spans = debug.finished_spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "train.step" and root.step == 0
    assert sorted(s.name for s in spans if s.parent == root.id) == sorted(PARTS[1:])


@pytest.mark.parametrize("kind", KINDS)
def test_tracing_on_and_off_gives_bit_identical_steps(kind):
    results = []
    for traced in (False, True):
        state = _state(kind)
        inputs = _inputs(kind)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                metrics = _step(kind, state, inputs)
        else:
            metrics = _step(kind, state, inputs)
        results.append((metrics, state))
    (m0, s0), (m1, s1) = results
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (n, a), (_, b) in zip(s0.model.state_dict().items(), s1.model.state_dict().items()):
        assert torch.equal(a, b), n
    for p0, p1 in zip(s0.model.parameters(), s1.model.parameters()):
        a0, a1 = s0.optimizer.state[p0], s1.optimizer.state[p1]
        assert a0.keys() == a1.keys()
        for k in a0:
            assert torch.equal(torch.as_tensor(a0[k]), torch.as_tensor(a1[k])), k
    assert s0.step == s1.step == 1
