"""K1's warp route beside its rank and select routes on the card, for the
cost rule.

    python zen_tpu_torch/benches/warp_rows.py [--runs 30]

Times, each route forced through ``_time_launch``, K1's warp route (a
warp an output), its rank route at the wrapper's geometry
(``time_rank_geometry``: the walk from rank 0 or the steps) and its
select route, on rows of few to many outputs: the hop-32 step's K = 93
(one stream at B = 1 and B = 32, fleets of 4, 16 and 64 streams at B =
32) and K = 127, 187 and 255 on one stream at B = 32 (four taps a lane,
then eight). Each output is held bitwise against the plain twin; beside
the times, the cost rule's prices (``time_route_costs``) and its pick.
``WARP_BASE_US`` and ``WARP_OUTPUT_US`` (ops/median_cuda.py) are fitted to
the warp times (least squares of µs - LAUNCH_US on ceil(outputs / SMs) x
slots / 4). Prints the card's name and power limit, one line a row,
then one JSON object; chip_smoke.py's phase 3 runs the rows too.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32, the causal wrap


def rows(torch, device) -> list:
    """(label, a, b, offsets, start) of tap_median_time calls, inputs from
    one numpy seed, made on the card."""
    import numpy as np

    rng = np.random.default_rng(0)

    def mag(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32) + np.float32(1e-3)).to(device)

    out = [(f"K=93 C={c} H=183 B={b} F=65 (hop 32)", mag(c, 183, 65), mag(c, b, 65), K93, 183)
           for c, b in ((1, 1), (1, 32), (4, 32), (16, 32), (64, 32))]
    for k in (127, 187, 255):
        out.append((f"K={k} C=1 H={k - 1} B=32 F=65 causal", mag(1, k - 1, 65), mag(1, 32, 65),
                    tuple(range(-(k - 1), 1)), k - 1))
    return out


def device_us(torch, fn, runs: int) -> float:
    """One call's device µs: CUDA events behind a spin, the median of
    ``runs`` calls after one warm call."""
    import numpy as np

    def once():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3

    once()
    return float(np.median([once() for _ in range(runs)]))


def run_rows(torch, mc, runs: int, device: str, emit=print) -> dict:
    """Each row's routes timed and held against the twin; returns {label:
    {"us": {route: µs}, "costs": ..., "pick": ..., "outputs": n}}."""
    import functools
    import math

    sms = mc._sm_count(torch.device(device))
    result = {}
    for label, a, b, offs, start in rows(torch, device):
        t_v, streams, f = a.shape[-2] + b.shape[-2], math.prod(a.shape[:-2]), a.shape[-1]
        want = mc.tap_median_time_plain(a, b, offs, start)
        us = {}
        for route in ("warp", "rank", "select"):
            fn = functools.partial(mc._time_launch, a, b, offs, start, 0.0, route)
            if not torch.equal(fn(), want):
                raise SystemExit(f"warp_rows {label}: the {route} route differs from the twin")
            us[route] = device_us(torch, fn, runs)
        costs = mc.time_route_costs(offs, start, t_v, streams, f, sms)
        pick = mc.time_call_route(offs, start, t_v, streams, f, sms)
        outputs = streams * (t_v - start) * f
        result[label] = {"us": us, "costs": costs, "pick": pick, "outputs": outputs,
                         "slots": mc.time_warp_slots(len(offs))}
        emit(f"warp {label} ({outputs} outputs, {mc.time_warp_slots(len(offs))} taps a lane): "
             "bitwise equal; " + ", ".join(f"{r} {v:.2f} us" for r, v in us.items())
             + f" (medians of {runs}); cost rule "
             + ", ".join(f"{r} {'n/a' if c is None else f'{c:.1f}'}"
                         for r, c in zip(("rank", "select", "warp"), costs))
             + f": picks {pick}, fastest measured {min(us, key=us.get)}")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from zen_tpu_torch.ops import median_cuda as mc

    if not torch.cuda.is_available():
        raise SystemExit("warp_rows times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    result = run_rows(torch, mc, args.runs, "cuda", emit=lambda line: print(line, flush=True))
    print(json.dumps({"warp_rows": result, "card": smi}))
    return result


if __name__ == "__main__":
    main()
