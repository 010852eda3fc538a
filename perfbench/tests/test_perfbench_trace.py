"""The device trace's arithmetic on a synthetic Chrome trace."""

import math

from perfbench import trace


def _trace():
    # window 0..1000 us; stream A 100..300 and 500..600, stream B 250..400
    # (overlapping A), a copy 700..710; host: a step annotation over
    # 0..1000, a sync 410..690
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.step", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 410, "dur": 280},
        {"ph": "X", "cat": "kernel", "name": "conv_a", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "bn_b", "ts": 250, "dur": 150},
        {"ph": "X", "cat": "kernel", "name": "conv_a", "ts": 500, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 10},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 100},
    ]


def test_busy_time_is_the_union_of_overlapping_streams():
    t = trace.parse_chrome_trace(_trace())
    assert math.isclose(t.window_s, 1e-3)
    # 100..400 (A and B merged) + 500..600 + 700..710 = 410 us
    assert math.isclose(trace.busy_seconds(t), 410e-6)
    assert len(t.kernels()) == 3 and len(t.kernels(("conv_a",))) == 2


def test_idle_gaps_are_named_by_the_innermost_host_event_at_their_middle():
    t = trace.parse_chrome_trace(_trace())
    assert trace.idle_gaps(t) == [(0, 100), (400, 500), (600, 700), (710, 1000)]
    names = trace.gap_names(t)
    assert math.isclose(names["cudaStreamSynchronize"], 200e-6)
    assert math.isclose(names["perfbench.step"], 100e-6 + 290e-6)
    assert math.isclose(sum(names.values()), 1e-3 - 410e-6)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "conv_a" and math.isclose(b["device_ops"][0][1], 300e-6)
    assert len(b["idle_gaps"]) <= 10


def test_short_gaps_are_pooled():
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 8},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 10}]
    names = trace.gap_names(trace.parse_chrome_trace(events))
    assert names == {trace.SHORT_GAP_NAME: 2e-6}
