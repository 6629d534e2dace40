"""BENCHMARK.json against the benchmark's contract, and the imports of the
benchmark's files.  Run: python -m pytest -o addopts='' -p no:cacheprovider h100bench/tests"""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def reported(workload):
    return {m["name"] for m in metrics() if workload in m.get("workloads", [workload])}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    for key in ("source", "why"):
        assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    path = ROOT / entry["file"]
    assert path == HERE / "configs" / f"{entry['name']}.json" and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert (HERE / "scenes" / f"{cfg['scene']['maker']}.py").is_file()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "loops" / f"{traffic['loop']}.py").is_file()
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    names = reported(cell["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names and len(names & e2e) >= 2 and names - e2e
    # Every layer metric a cell reports moves an end-to-end metric it reports.
    for m in SPEC["per_layer"]:
        if m["name"] in names:
            assert m["moves"] in names


def test_cells_are_distinct_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric(m):
    e2e = m in SPEC["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {x["name"] for x in SPEC["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    assert len({x["name"] for x in metrics()}) == len(metrics())


def test_setup_bound():
    (setup,) = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (absolute)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    """No file of the benchmark imports JAX or the JAX package, compared by
    whole top-level names (the port's name begins with the JAX package's);
    the reference imports nothing of the port nor of the benchmark's
    program side."""
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        names = set(_imports(p))
        assert not names & {"jax", "jaxlib", "flax", "rvpt_tpu"}, p
    for p in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(p.read_text())
        names = set(_imports(p))
        assert "rvpt_tpu_torch" not in names, p
        rel = {n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level > 0}
        assert not rel & {"program", "loops", "harness"}, p
