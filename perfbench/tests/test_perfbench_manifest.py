"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from perfbench import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"][:3] == ["python3", "-m", "perfbench.run"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_the_allowed_keys_and_names(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for e in MANIFEST[group]:
        required = KEYS[group] - {"workloads"} if group != "workloads" else KEYS[group]
        assert required <= set(e) <= KEYS[group], e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_layers():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = [m["name"] for m in cell.metrics(trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics(trace=True), w["name"]
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_configs_are_used_and_their_files_found():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert cfg["source"] == c["source"]


def test_every_named_file_is_found():
    for w in MANIFEST["workloads"]:
        spec = harness.load_json(harness.BENCH_DIR / "workloads" / f"{w['name']}.json")
        assert (harness.BENCH_DIR / "traffic" / f"{spec['generator']}.py").is_file()
        assert spec["why"] == w["why"]
        assert set(spec["limits"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        reader = harness.load_file_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_a_full_check_fits_at_twenty_four_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
