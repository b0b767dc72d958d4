"""The rank routes of K1 and K2 at every geometry the cost rule weighs.

    python zen_tpu_torch/benches/rank_geometry.py [--runs 10] [--rows all|fast]

For each of ``rank_store.PATH``'s rows (and K2 at K = 257, fs 8000 hop
1024, and K1 at K = 401): every geometry of the rank route that fits a
block (K2: ``freq_rank_plan``'s candidates, a tile and a run of outputs
a thread; K1: ``time_rank_geometry``'s, a run of
output rows a block, a lane run a thread and the adjacent columns a
block), run through ``_freq_launch`` / ``_time_launch``, its
output held bitwise against the plain twin, its device µs (CUDA events
behind a spin, the median of ``--runs`` calls) beside the cost rule's
price (``sort_us``). Then the fastest measured beside the rule's pick.
``--rows fast`` leaves out the two 4-minute-track rows and median2d's.
Prints the card's name and power limit, one line a geometry, one line a
row's verdict, then one JSON object. chip_smoke.py's phase 3 runs the
same (``run_rows``).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

TRACK = ("4-minute", "median2d")  # rows left out by --rows fast


def geometries(mc, kind, args, sms: int) -> list:
    """[(geometry, model µs, call)] of one row: K2's (tile, run),
    K1's (run, lane_run, cols)."""
    if kind == "freq":
        x, k, mode = args
        rows = x.numel() // x.shape[-1]
        return [((tile, run), us,
                 lambda x=x, k=k, mode=mode, t=tile, r=run: mc._freq_launch(
                     x, k, mode, "rank", tile=t, run=r))
                for us, tile, run in mc._freq_rank_plans(k, rows, x.shape[-1], mode, sms)]
    a, b, offs, start = args
    t_v, streams, f = a.shape[-2] + b.shape[-2], math.prod(a.shape[:-2]), a.shape[-1]
    planned, run1, fits = mc.time_rank_plan(offs, start, t_v)
    return [((run, lane, cols), us,
             lambda a=a, b=b, offs=offs, start=start, r=run, lr=lane, w=cols: mc._time_launch(
                 a, b, offs, start, 0.0, "rank", run=r, lane_run=lr, cols=w))
            for us, run, lane, cols in mc._time_rank_geometries(planned, t_v - start, run1,
                                                                streams, f, sms)]


def pick(mc, kind, args, sms: int) -> tuple:
    if kind == "freq":
        x, k, mode = args
        return mc.freq_rank_plan(k, x.numel() // x.shape[-1], x.shape[-1], mode, sms)
    a, b, offs, start = args
    return mc.time_rank_geometry(offs, start, a.shape[-2] + b.shape[-2], math.prod(a.shape[:-2]),
                                 a.shape[-1], sms)


def run_rows(torch, mc, device_us, runs: int, fast: bool, device="cuda", emit=print) -> dict:
    """{label: {geometry: µs}}, each geometry held bitwise to the twin."""
    from zen_tpu_torch.benches import rank_store

    import numpy as np

    sms = mc._sm_count(torch.device(device))
    rows = [r for r in rank_store.rows(torch, device) if r[0] in rank_store.PATH
            or "K=257" in r[0]]
    v = torch.from_numpy(np.random.default_rng(7).random((1, 900, 17), dtype=np.float32)
                         + np.float32(1e-3)).to(device)
    rows.append(("K1 single T=900 F=17 K=401 centered", "time",
                 (v, v[:, :0], tuple(range(-200, 201)), 0)))
    out = {}
    for label, kind, args in rows:
        if fast and any(t in label for t in TRACK):
            continue
        if kind == "freq":
            want = mc.sliding_median_boundary_plain(*args)
        else:
            want = mc.tap_median_time_plain(*args)
        chosen = pick(mc, kind, args, sms)
        times = {}
        for geometry, model, call in geometries(mc, kind, args, sms):
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"rank_geometry {label} {geometry}: differs from the twin")
            del got
            times[geometry] = device_us(torch, call, runs)[0]
            emit(f"rank_geometry {label} {geometry}: bitwise equal, {times[geometry]:.2f} us, "
                 f"cost rule {model:.1f} us")
        best = min(times, key=times.get)
        emit(f"rank_geometry {label}: fastest {best} {times[best]:.2f} us, cost rule picks "
             f"{chosen} {times[chosen]:.2f} us (medians of {runs})")
        out[label] = {"pick": list(chosen), "fastest": list(best),
                      "us": {"x".join(map(str, g)): v for g, v in times.items()}}
        del want, args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--rows", choices=("all", "fast"), default="all")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from zen_tpu_torch.benches.rank_store import device_us
    from zen_tpu_torch.ops import median_cuda as mc

    if not torch.cuda.is_available():
        raise SystemExit("rank_geometry times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = run_rows(torch, mc, device_us, args.runs, args.rows == "fast",
                   emit=lambda line: print(line, flush=True))
    print(json.dumps({"rank_geometry": out, "card": smi}))
    return out


if __name__ == "__main__":
    main()
