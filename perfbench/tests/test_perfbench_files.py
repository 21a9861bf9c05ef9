"""The benchmark's files: ``BENCHMARK.json`` to its schema, every file a
cell names found by name, names and units in their alphabets, every
per-layer metric's cells reporting the metric it moves, and no module of
the benchmark importing JAX or the JAX package (top-level names compared
whole)."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from perfbench_small_cells import BENCH, REPO

from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(BENCHMARK) == KEYS
    assert BENCHMARK["paths"] == ["perfbench"]
    assert BENCHMARK["command"][:2] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=[c["name"] for c in BENCHMARK["configs"]])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("perfbench/configs/")
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                   entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCHMARK["workloads"])


@pytest.mark.parametrize("entry", BENCHMARK["workloads"],
                         ids=[w["name"] for w in BENCHMARK["workloads"]])
def test_cells_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    cell = common.Cell(entry["name"], BENCHMARK)
    assert cell.kind in ("train", "serve")
    assert callable(common.generator(cell.traffic))
    for part in ("families", "reference", "roofline"):
        assert (BENCH / part / f"{cell.config['family']}.py").is_file()
    assert set(cell.settings["limits"]) == (
        {"logit_gap"} if cell.kind == "serve"
        else {"loss_gap", "grad1_gap", "change_gap"})
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(common.load_reader(m["name"]))


def test_names_units_and_arrows():
    names = [c["name"] for c in BENCHMARK["configs"]] + \
        [w["name"] for w in BENCHMARK["workloads"]] + \
        [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w["traffic"]) for w in BENCHMARK["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCHMARK["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", [cell])
            assert cell in reports, (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_report_an_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = [m for m in BENCHMARK["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in BENCHMARK["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and per, w["name"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    for path in BENCH.rglob("*.py"):
        bad = set(_imports(path)).intersection(common.FORBIDDEN)
        if bad:
            found[str(path)] = sorted(bad)
    assert not found
    # the names are compared whole: the port's package is not the JAX one
    assert "repro_torch" not in common.FORBIDDEN


def test_run_fails_without_a_card_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         BENCHMARK["workloads"][0]["name"], "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
