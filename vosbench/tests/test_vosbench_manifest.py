"""The manifest keeps the contract's shape, and every piece it names is a
file of its own under vosbench/, found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from vosbench import manifest

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w
               for w in BENCH["command"])


def test_names_units_and_text_fields():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_configs_are_files_of_their_own_and_used():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert (ROOT / c["file"]).is_file() and c["name"] in used
        assert len(c["reduced"]) <= 16


def test_every_cell_finds_its_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(w["name"])
        assert (manifest.HERE / "drivers" / f"{cell.driver}.py").is_file()
        assert (manifest.HERE / "workloads" / f"{w['name']}.json").is_file()
        assert cell.limits, f"{w['name']} compares nothing"
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_have_readers_and_cells_report_enough():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_per_layer_moves_is_reported_by_all_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_run_seconds_fits_the_check_with_every_cell():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_are_finite_numbers(cell):
    limits = manifest.cell(cell).limits
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in limits.values())


def test_paths_hold_only_named_characters():
    for path in Path(manifest.HERE).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
