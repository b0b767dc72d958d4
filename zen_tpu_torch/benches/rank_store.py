"""The wide median rows on the card, for comparing two trees in one call.

    python zen_tpu_torch/benches/rank_store.py [--tree DIR] [--label NAME] [--runs 30]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``step_walls.py`` does, so that one call on the card
can time another checkout's kernels beside this one's, in turns
(parent, change, change, parent), each in its own process. Times,
through the wrappers (``tap_median_time``, ``sliding_median_boundary``),
the rows whose keys pass one block's shared memory (the rank routes'
key store), K1's 12,801 taps of 192 kHz hop 1 (shared memory, past
K1's old cap), and the paths' rank rows (K2 at K = 47, 187 and 257, K1
at K = 93), which take shared memory in both trees. Each time is the
card's µs for one call: CUDA events behind a spin, the median of
``--runs`` calls after one warm call, or of 3 where that call took over
100 ms. Beside it, the SHA-256 of the output's bytes: two trees'
outputs compare without a twin (whose gather may not hold a tree's
widest rows). A row the tree refuses prints ``refused`` and the
ZenError. Prints the card's name and power limit, one line a row, then
one JSON object.
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
WRAP_LIMIT = (1 << 21) - 1024 + 1  # K2's tap limit on the key store


def rows(torch, device) -> list:
    """(label, kind, args): kind 'time' takes (a, b, offsets, start),
    'freq' (x, k, mode); inputs from one numpy seed, made on the card."""
    import numpy as np

    rng = np.random.default_rng(0)

    def mag(*shape, dtype=torch.float32):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device).to(dtype)

    return [
        ("K2 R=32 F=2049 K=47 reflect", "freq", (mag(32, 2049), 47, "reflect")),
        ("K2 R=41 F=8193 K=187 reflect", "freq", (mag(41, 8193), 187, "reflect")),
        ("K2 R=32 F=2049 K=257 reflect", "freq", (mag(32, 2049), 257, "reflect")),
        ("K1 pair C=1 H=183 B=32 F=65 K=93", "time", (mag(1, 183, 65), mag(1, 32, 65), K93, 183)),
        ("K2 R=4 F=8193 K=16385 reflect", "freq", (mag(4, 8193), 16_385, "reflect")),
        ("K2 R=4 F=8193 K=16385 reflect bf16", "freq",
         (mag(4, 8193, dtype=torch.bfloat16), 16_385, "reflect")),
        ("K2 R=1 F_in=58112 K=57857 valid", "freq", (mag(1, 58_112), 57_857, "valid")),
        ("K2 R=2 F_in=65792 K=65537 valid", "freq", (mag(2, 65_792), 65_537, "valid")),
        (f"K2 R=2 F=64 K={WRAP_LIMIT} wrap", "freq", (mag(2, 64), WRAP_LIMIT, "wrap")),
        ("K1 pair C=1 H=25599 B=32 F=3 K=12801 (192 kHz hop 1)", "time",
         (mag(1, 25_599, 3), mag(1, 32, 3), K12801, 25_599)),
        ("K1 pair C=1 H=51199 B=32 F=3 K=25601 (384 kHz hop 1)", "time",
         (mag(1, 51_199, 3), mag(1, 32, 3), K25601, 51_199)),
        ("K1 single T=20100 F=9 K=20001", "time",
         (mag(1, 20_100, 9), mag(1, 0, 9), tuple(range(-20_000, 1)), 0)),
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
