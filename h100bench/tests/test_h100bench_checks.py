"""Runs of the cells at a small film on the CPU, the harness's look for a
card skipped: sound runs come out correct; the control (the reference in
bfloat16 in the program's place) and each fault a cell can have, planted
under the timed path, come out not correct; and a configuration, traffic
mix and metric added as new files are found with no code edit."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100bench.faults import FAULTS, plant, undo
from h100bench.harness import run_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FILM = (32, 18)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAFFIC = {w["name"]: w["traffic"] for w in SPEC["workloads"]}


def run(workload, control=False, seconds=0.2):
    return run_cell(workload, 20240601, seconds, False, time.perf_counter(),
                    device="cpu", film=FILM, control=control, log=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_and_control(workload):
    assert run(workload)["correct"]
    out = run(workload, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_caught(workload, fault):
    """``faults.py``: a step that returns its state unchanged; half of the
    batch left out, the mean taken over the rest; an answer altered (by
    1%) where it is produced."""
    traffic = json.loads((HERE / "traffic" / f"{TRAFFIC[workload]}.json").read_text())
    saved = plant(traffic["loop"], fault)
    try:
        out = run(workload)
    finally:
        undo(saved)
    assert not out["correct"], out["checks"]


def test_new_files_need_no_code_edit(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with
    their BENCHMARK.json entries, in a copy of the benchmark."""
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out", "tests"))
    (tmp_path / "rvpt_tpu_torch").symlink_to(ROOT / "rvpt_tpu_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "cornell-1080p.json").read_text())
    (tmp_path / "h100bench/configs/cornell-2b.json").write_text(
        json.dumps(dict(cfg, bounces=2)))
    (tmp_path / "h100bench/traffic/display-sync.json").write_text(json.dumps(
        {"loop": "display", "integrator": 9, "frames_in_flight": 1, "warmup": 2,
         "trace_iterations": 4}))
    (tmp_path / "h100bench/metrics/frames_done.py").write_text(
        '"""Frames completed in the window."""\n\n\ndef read(run):\n'
        '    return float(run.iterations)\n')
    (tmp_path / "h100bench/limits/cornell-2b-sync.json").write_text('{"px_off": 0.01}')
    spec["configs"].append({"name": "cornell-2b", "source": "test",
                            "file": "h100bench/configs/cornell-2b.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "cornell-2b-sync", "config": "cornell-2b",
                              "traffic": "display-sync", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["cornell-2b-sync"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, time; from h100bench.harness import run_cell; "
            "print(json.dumps(run_cell('cornell-2b-sync', 3, 0.2, False, "
            "time.perf_counter(), device='cpu', film=(16, 9))))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"] and out["metrics"]["frames_done"]["value"] >= 1


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result; in
    a directory that holds only the benchmark, too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                              CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and not res.stdout.strip()


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each cell on the card (python -m pytest -m cuda
    h100bench/tests on the card's machine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for w in CELLS:
        res = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", w,
                              "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.splitlines()[-1])["correct"]
