"""Run one cell of the benchmark once, on the card this process sees:

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Earlier lines name the card (nvidia-smi's name and power limit) and the
torch and CUDA versions; the last line is the result as one JSON object,
and the last lines on standard error the numbers the check compared,
each beside its limit.  Without a card, or with fewer cards than the cell
asks for, it exits with 2 and prints no result; with a module of JAX or
the JAX package loaded once the window has closed, with 3."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from h100bench.harness import card_lines, forbidden_modules, load_spec, run_cell

    cell = next((w for w in load_spec()["workloads"] if w["name"] == a.workload), None)
    if cell is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen",
              file=sys.stderr)
        return 2
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    for line in card_lines():
        print(line, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded once the window closed: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
