"""Readings for a cell's limits: the program and its control, seed by seed.

    python3 benchmark/control.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 2 --first-seed 3100000000

Runs the cell at its own size on the card, in one process: ``--seeds``
runs of the program (the lower readings) and ``--control-seeds`` of the
configuration's ``control`` (its stated lower-precision path, the upper
readings), each a short window at the cell's own load and the check
that a run makes. Prints one line a run and a summary: for each compared
number the largest program reading and the smallest control reading.
Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: the readings are taken on the card", file=sys.stderr)
        return 2
    readings = {"program": [], "control": []}
    plan = [("program", args.first_seed + i) for i in range(args.seeds)]
    plan += [("control", args.first_seed + 1000 + i) for i in range(args.control_seeds)]
    for side, seed in plan:
        t0 = time.perf_counter()
        result = harness.execute(args.workload, seed, args.seconds, False,
                                 control=side == "control")
        numbers = {k: c["value"] for k, c in result["checks"].items()}
        readings[side].append(numbers)
        print(json.dumps({"side": side, "seed": seed, "numbers": numbers,
                          "attempted": result["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    for name in readings["program"][0]:
        lower = max(r[name] for r in readings["program"])
        upper = min((r[name] for r in readings["control"]), default=None)
        print(json.dumps({"number": name, "lower": lower, "upper": upper,
                          "ratio": upper / lower if upper is not None and lower > 0 else None}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
