"""The benchmark's manifest and its files: names, units, files found by
name, metrics and the cells that report them, the check's time budget,
and no module of the harness importing JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "physicsbasedfwi2_tpu"}
PROGRAM = "physicsbasedfwi2_tpu_torch"


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["fwibench"]
    assert bench["command"] == ["python3", "fwibench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.is_relative_to(BENCH)
        cfg = json.loads(f.read_text())
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) == set(
            cfg["reduced"])
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits["steps"] >= 1 and limits["limits"]
    assert configs == {w["config"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_cells_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_check_fits_its_time(bench):
    # 24 cells, 2 + 14 runs each at run_seconds + 60 s, 180 s a cell to
    # compile, 1200 s spare
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere_and_a_reference_of_its_own():
    files = [f for f in BENCH.rglob("*.py") if "__pycache__" not in f.parts]
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in (BENCH / "reference").glob("*.py"):
        assert PROGRAM not in _imports(f), f
        text = f.read_text()
        assert "physicsbasedfwi2_tpu" not in text, f
