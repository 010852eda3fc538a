"""The result line and the readers of the end-to-end metrics."""

import json
import math

from perfbench import harness, peaks, run


def test_the_last_line_has_the_keys_in_order_and_the_checks_last():
    checks = [harness.Check("loss_gap", 0.001, 0.01), harness.Check("grad_gap", 0.5, 0.1)]
    line = harness.result_line(True, 400, 0, {"setup_s": {"value": 12.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                                "memory_peak_bytes": 123}, None, checks)
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["checks"]["grad_gap"] == {"value": 0.5, "limit": 0.1}
    assert "\n" not in line
    traced = json.loads(harness.result_line(False, 1, 1, {}, {}, {"device_ops": [],
                                                                  "idle_gaps": []}, checks))
    assert list(traced)[-2:] == ["breakdown", "checks"]


def test_a_check_passes_only_at_or_under_its_limit_and_never_when_not_finite():
    assert harness.Check("a", 0.1, 0.1).passed
    assert not harness.Check("a", 0.11, 0.1).passed
    assert not harness.Check("a", math.inf, 1.0).passed
    assert not harness.Check("a", math.nan, 1.0).passed


def test_leaf_gaps_are_against_the_larger_of_the_leaf_and_the_median_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 0.001}
    gap, leaf = harness.worst_leaf_gap({"a": 1.1, "b": 2.0, "c": 0.5}, ref, ["a", "b", "c"])
    assert leaf == "c" and math.isclose(gap, 0.499)
    assert math.isclose(harness.median_leaf_gap({"a": 1.1, "b": 2.0, "c": 0.5}, ref,
                                                ["a", "b", "c"]), 0.1)
    gap, leaf = harness.worst_leaf_gap({"a": 1.0}, ref, ["a", "b"])
    assert leaf == "b" and gap == math.inf
    gap, leaf = harness.worst_leaf_gap({"a": math.nan, "b": 2.0}, ref, ["a", "b"])
    assert leaf == "a" and gap == math.inf


def _run(window, peaks=None):
    cell = harness.load_cell("avenet_train_flagship")
    return run.RunData(cell, "train", 3.5, window, None, None, peaks)


def test_the_training_rate_is_every_clip_over_the_window():
    r = _run({"clips": 2000, "window_s": 8.0, "steps": 100})
    rate = harness.load_file_module(harness.BENCH_DIR / "metrics" / "train_clips_per_s.py")
    assert rate.read(r) == 250.0
    assert harness.load_file_module(harness.BENCH_DIR / "metrics" / "setup_s.py").read(r) == 3.5


def test_mfu_is_the_reference_flops_of_the_window_over_the_bf16_peak():
    from perfbench.reference.flops import train_step_flops

    r = _run({"clips": 2000, "window_s": 8.0, "steps": 100},
             peaks.for_device("NVIDIA H100 80GB HBM3"))
    mfu = harness.load_file_module(harness.BENCH_DIR / "metrics" / "mfu.train.py").read(r)
    step = train_step_flops(r.cell.config, "flagship", 20, 16)
    assert math.isclose(mfu, 100 * step * 100 / 8.0 / 989e12)
    assert harness.load_file_module(harness.BENCH_DIR / "metrics" / "mfu.train.py").read(
        _run({"clips": 1, "window_s": 1.0, "steps": 1})) is None


def test_the_peak_table_knows_the_card_by_its_name():
    assert peaks.for_device("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    assert peaks.for_device("cpu") is None


def test_subseeds_take_seeds_larger_than_32_bits_and_differ_by_use():
    big = 2 ** 31 + 12345
    assert harness.subseed(big, "weights") != harness.subseed(big, "clips")
    assert harness.subseed(big, "weights") == harness.subseed(big, "weights")
    assert 0 <= harness.subseed(2 ** 40, "x") < 2 ** 63


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result(capfd):
    import faulthandler

    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    try:
        code = run.main(["--workload", "avenet_train_flagship", "--seed", str(2 ** 31 + 1),
                         "--seconds", "1", "--trace", "0"])
    finally:
        faulthandler.cancel_dump_traceback_later()
    out = capfd.readouterr()
    assert code != 0 and out.out == "" and "CUDA card" in out.err
