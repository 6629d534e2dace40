"""Readings of a cell's check over many seeds, and of its control, in one
process (set-up is paid once per seed, process start once):

    python3 -m h100bench.calibrate --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 2

With ``--fault-seeds``, each fault of ``faults.py`` is planted in the
program and read on those seeds.  Each line is JSON: {"seed", "control",
"fault", "checks", "metrics"}.  The lower reading of a number is the
largest over sound runs of the program; the upper, the smallest its
control gives (the reference in bfloat16 in the program's place) or, in a
training cell, a fault that reads ten times the lower or more.  The
benchmark's own runs never run this."""

import argparse
import json
import time

from h100bench.faults import FAULTS, plant, undo
from h100bench.harness import load_json, load_spec, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault-seeds", default="",
                   help="seeds on which each fault of faults.FAULTS is read")
    a = p.parse_args(argv)
    cell = next(w for w in load_spec()["workloads"] if w["name"] == a.workload)
    loop = load_json("traffic", cell["traffic"])["loop"]
    runs = ([(s, False, None) for s in a.seeds.split(",") if s]
            + [(s, True, None) for s in a.control_seeds.split(",") if s]
            + [(s, False, f) for f in FAULTS for s in a.fault_seeds.split(",") if s])
    for seed, control, fault in runs:
        saved = plant(loop, fault) if fault else []
        try:
            out = run_cell(a.workload, int(seed), a.seconds, False, time.perf_counter(),
                           control=control)
        finally:
            undo(saved)
        print(json.dumps({"seed": int(seed), "control": control, "fault": fault,
                          "checks": {k: c["value"] for k, c in out["checks"].items()},
                          "metrics": {k: m["value"] for k, m in out["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
