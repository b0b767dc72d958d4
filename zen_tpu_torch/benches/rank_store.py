"""The wide median rows on the card, for comparing two trees in one call.

    python zen_tpu_torch/benches/rank_store.py [--tree DIR] [--label NAME] [--runs 30]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``step_walls.py`` does, so that one call on the card
can time another checkout's kernels beside this one's, in turns
(parent, change, change, parent), each in its own process. Times,
through the wrappers (``tap_median_time``, ``sliding_median_boundary``),
whichever route each tree's wrapper picks: the rows whose outputs are
too few to share a sort (``SEVEN``: hop 1 at 192 and 384 kHz, a whole
clip's 20,001 contiguous taps, K2's pre-padded rows past 57,000 taps and
its widest K under wrap, which the key store took and torch.kthvalue
beat), K2's store row of many outputs (R=4, K = 16,385), and the paths'
rank rows (``PATH``: hop 1024, pitch-track, hop 32 at B=32 and B=1,
offline pass 1 on the clip and the 4-minute track, median2d's fl 93 and
187 at the track's widths, fl 93 under both geometries and fl 187 under
each of its three borders and in bf16). Each
time is the card's µs for one call: CUDA events behind a spin, the
median of ``--runs`` calls after one warm call, or of 3 where that call
took over 100 ms. Beside it, the SHA-256 of the output's bytes: two
trees' outputs compare without a twin (whose gather may not hold a
tree's widest rows). A row the tree refuses prints
``refused`` and the ZenError. Prints the card's name and power limit,
one line a row, then one JSON object. chip_smoke.py's phase 3 times the
same rows' routes side by side (``rows``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

SLOW_US = 100_000.0  # a call past this is timed 3 times
# HPRConfig(fs, hop=1)'s causal time taps (the wrap border): two tap runs
K12801 = tuple(range(-25599, -19199)) + tuple(range(-6400, 1))  # 192 kHz, H = 25,599
K25601 = tuple(range(-51199, -38399)) + tuple(range(-12800, 1))  # 384 kHz, H = 51,199
K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32
WRAP_LIMIT = (1 << 21) - 1024 + 1  # K2's tap limit (median_cuda.MAX_FREQ_TAPS)
TRACK_H, TRACK_P = 2585, 41355  # the 4-minute track's pass-1 and pass-2 frames
# the rows that lost to torch.kthvalue on the key store or the shared sort,
# and the paths' rank rows: labels of rows()
SEVEN = (
    "K1 pair C=1 H=25599 B=32 F=3 K=12801 (192 kHz hop 1)",
    f"K2 R=2 F=64 K={WRAP_LIMIT} wrap",
    "K1 single T=20100 F=9 K=20001",
    "K1 pair C=1 H=51199 B=1 F=3 K=25601 (384 kHz hop 1)",
    "K2 R=1 F_in=58112 K=57857 valid",
    "K1 pair C=1 H=51199 B=32 F=3 K=25601 (384 kHz hop 1)",
    "K2 R=2 F_in=65792 K=65537 valid",
)
PATH = (
    "K2 R=32 F=2049 K=47 reflect (hop 1024)",
    "K2 R=8 F=8193 K=187 reflect (pitch-track)",
    "K1 pair C=1 H=183 B=32 F=65 K=93 (hop 32)",
    "K1 pair C=1 H=183 B=1 F=65 K=93 (hop 32)",
    "K2 R=41 F=8193 K=187 reflect (offline pass 1)",
    f"K2 R={TRACK_H} F=8193 K=187 reflect (4-minute pass 1)",
    f"K1 single T={TRACK_P}+92 F=513 K=93 (median2d fl 93)",
    f"K2 R={TRACK_H} F=8193 K=187 wrap (median2d fl 187)",
)


def rows(torch, device) -> list:
    """(label, kind, args): kind 'time' takes (a, b, offsets, start),
    'freq' (x, k, mode); inputs from one numpy seed, made on the card:
    PATH and K2 at K = 257 (fs 8000 hop 1024) first, so that no tree's
    wide rows (a parent's key store ran some for seconds) load the card
    before them, then SEVEN, K2's store row and its bf16 twin, median2d fl
    187's other two borders (valid on the padded rows, replicate) and its
    bf16 wrap, and fl 93's causal valid taps (PATH's fl 93 row is the
    geometry of its wrap and replicate borders, on the gathered rows)."""
    import numpy as np

    rng = np.random.default_rng(0)

    def mag(*shape, dtype=torch.float32):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device).to(dtype)

    return [
        (PATH[0], "freq", (mag(32, 2049), 47, "reflect")),
        (PATH[1], "freq", (mag(8, 8193), 187, "reflect")),
        (PATH[2], "time", (mag(1, 183, 65), mag(1, 32, 65), K93, 183)),
        (PATH[3], "time", (mag(1, 183, 65), mag(1, 1, 65), K93, 183)),
        (PATH[4], "freq", (mag(41, 8193), 187, "reflect")),
        (PATH[5], "freq", (mag(TRACK_H, 8193), 187, "reflect")),
        (PATH[6], "time", (mag(TRACK_P + 92, 513), mag(0, 513), tuple(range(-92, 1)), 92)),
        (PATH[7], "freq", (mag(TRACK_H, 8193), 187, "wrap")),
        ("K2 R=32 F=2049 K=257 reflect (fs 8000 hop 1024)", "freq", (mag(32, 2049), 257, "reflect")),
        (SEVEN[0], "time", (mag(1, 25_599, 3), mag(1, 32, 3), K12801, 25_599)),
        (SEVEN[1], "freq", (mag(2, 64), WRAP_LIMIT, "wrap")),
        (SEVEN[2], "time", (mag(1, 20_100, 9), mag(1, 0, 9), tuple(range(-20_000, 1)), 0)),
        (SEVEN[3], "time", (mag(1, 51_199, 3), mag(1, 1, 3), K25601, 51_199)),
        (SEVEN[4], "freq", (mag(1, 58_112), 57_857, "valid")),
        (SEVEN[5], "time", (mag(1, 51_199, 3), mag(1, 32, 3), K25601, 51_199)),
        (SEVEN[6], "freq", (mag(2, 65_792), 65_537, "valid")),
        ("K2 R=4 F=8193 K=16385 reflect", "freq", (mag(4, 8193), 16_385, "reflect")),
        ("K2 R=4 F=8193 K=16385 reflect bf16", "freq",
         (mag(4, 8193, dtype=torch.bfloat16), 16_385, "reflect")),
        (f"K2 R={TRACK_H} F=8193+186 K=187 valid (median2d fl 187)", "freq",
         (mag(TRACK_H, 8193 + 186), 187, "valid")),
        (f"K2 R={TRACK_H} F=8193 K=187 edge (median2d fl 187 replicate)", "freq",
         (mag(TRACK_H, 8193), 187, "edge")),
        (f"K2 R={TRACK_H} F=8193 K=187 wrap bf16 (median2d fl 187 bf16)", "freq",
         (mag(TRACK_H, 8193, dtype=torch.bfloat16), 187, "wrap")),
        (f"K1 single T={TRACK_P} F=513 K=93 causal (median2d fl 93 valid)", "time",
         (mag(TRACK_P, 513), mag(0, 513), tuple(range(-93, 0)), 0)),
    ]


def device_us(torch, fn, runs: int) -> tuple:
    """(µs, calls timed): one call's device time, the median over ``runs``
    calls (3 where the first took over SLOW_US), each behind a ~1 ms spin
    so that the events bracket device work, not the host's enqueue."""
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

    if once() > SLOW_US:
        runs = 3
    return float(np.median([once() for _ in range(runs)])), runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    import zen_tpu_torch
    from zen_tpu_torch import ZenError
    from zen_tpu_torch.ops import median_cuda as mc

    if not zen_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"zen_tpu_torch came from {zen_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("rank_store times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    from zen_tpu_torch.ops import _build

    _build.library()
    print(f"{args.label}: library built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {}
    for label, kind, call_args in rows(torch, "cuda"):
        wrapper = mc.tap_median_time if kind == "time" else mc.sliding_median_boundary

        def fn(wrapper=wrapper, call_args=call_args):
            return wrapper(*call_args)

        try:
            out = fn()
        except ZenError as err:
            result[label] = {"refused": str(err)}
            print(f"{args.label} {label}: refused ({err})", flush=True)
            continue
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
        us, runs = device_us(torch, fn, args.runs)
        result[label] = {"us": us, "runs": runs, "sha256": digest.hexdigest()[:16]}
        print(f"{args.label} {label}: {us:.2f} us (median of {runs}), sha256 "
              f"{digest.hexdigest()[:16]}", flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"rank_store": result, "label": args.label, "card": smi}))
    return result


if __name__ == "__main__":
    main()
