"""Where a rank-route block's time goes, for comparing two trees in one call.

    python zen_tpu_torch/benches/rank_split.py [--tree DIR] [--label NAME] [--runs 30]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``rank_store.py`` does. Builds that tree's kernel
library and its two split builds (``_build.library(cut)``: with
``-DZEN_RANK_CUT`` 1 and 2 the rank kernels end after staging and after
the sort, ``csrc/rank_select.cuh``), all three at once, then times each
of ``rows()`` through the rank route (``_time_launch``,
``_freq_launch``, the tree's own tile and run) in each build: the whole
kernel, ending after staging and ending after the sort. The differences
read as staging (with the launch), sort and walk. Each time is the
card's µs for one call (``rank_store.device_us``: CUDA events behind a
spin, the median of ``--runs`` calls). Prints the card's name and power
limit, one line a row, then one JSON object. chip_smoke.py's phase 3
prints the same split (``split``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32
TRACK_H, TRACK_P = 2585, 41355  # the 4-minute track's pass-1 and pass-2 frames


def rows(torch, device) -> list:
    """(label, kind, args): kind 'time' takes (a, b, offsets, start),
    'freq' (x, k, mode); inputs from one numpy seed, made on the card:
    hop 32 (B=32, B=1), K=401 centered, median2d time fl 93 at the
    track's [41355, 513] (valid), K2's 4-minute pass 1, the clip's, hop
    1024, K=13 at the 512-stream shape, the key store row, median2d
    frequency fl 187 at [2585, 8193] (wrap) and pitch-track's K2."""
    import numpy as np

    rng = np.random.default_rng(4)

    def mag(*shape):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device)

    return [
        ("K1 K=93 [1, 183+32, 65] (hop 32)", "time", (mag(1, 183, 65), mag(1, 32, 65), K93, 183)),
        ("K1 K=93 [1, 183+1, 65] (hop 32, B=1)", "time",
         (mag(1, 183, 65), mag(1, 1, 65), K93, 183)),
        ("K1 K=401 [1, 900, 17]", "time",
         (mag(1, 900, 17), mag(1, 0, 17), tuple(range(-200, 201)), 0)),
        (f"K1 K=93 [{TRACK_P}+92, 513] (median2d fl 93)", "time",
         (mag(TRACK_P + 92, 513), mag(0, 513), tuple(range(-92, 1)), 92)),
        (f"K2 K=187 [{TRACK_H}, 8193] reflect (4-minute pass 1)", "freq",
         (mag(TRACK_H, 8193), 187, "reflect")),
        ("K2 K=187 [41, 8193] reflect (offline pass 1)", "freq", (mag(41, 8193), 187, "reflect")),
        ("K2 K=47 [32, 2049] reflect (hop 1024)", "freq", (mag(32, 2049), 47, "reflect")),
        ("K2 K=13 [8192, 513] reflect", "freq", (mag(8192, 513), 13, "reflect")),
        ("K2 K=16385 [4, 8193] reflect (key store)", "freq", (mag(4, 8193), 16_385, "reflect")),
        (f"K2 K=187 [{TRACK_H}, 8193] wrap (median2d fl 187)", "freq",
         (mag(TRACK_H, 8193), 187, "wrap")),
        ("K2 K=187 [8, 8193] reflect (pitch-track)", "freq", (mag(8, 8193), 187, "reflect")),
    ]


def split(torch, mc, device_us, runs: int, device="cuda") -> list:
    """[(label, whole, staging, sort, walk)] in µs for each of ``rows()``
    on ``mc``'s rank route: staging (with the launch) is the time of the
    build that ends after it, sort and walk the differences."""
    out = []
    for label, kind, args in rows(torch, device):
        if kind == "time":
            a, b, offs, start = args

            def run(cut, a=a, b=b, offs=offs, start=start):
                return mc._time_launch(a, b, offs, start, 0.0, "rank", cut=cut)
        else:
            x, k, mode = args

            def run(cut, x=x, k=k, mode=mode):
                return mc._freq_launch(x, k, mode, "rank", cut=cut)
        whole, stage, sort = (device_us(torch, lambda c=cut: run(c), runs)[0] for cut in (0, 1, 2))
        out.append((label, whole, stage, sort - stage, whole - sort))
        del args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import zen_tpu_torch
    from zen_tpu_torch.benches.rank_store import device_us
    from zen_tpu_torch.ops import _build
    from zen_tpu_torch.ops import median_cuda as mc

    if not zen_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"zen_tpu_torch came from {zen_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("rank_split times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(_build.library, (0, 1, 2)))
    print(f"{args.label}: three libraries built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = split(torch, mc, device_us, args.runs)
    for label, whole, stage, sort, walk in result:
        print(f"{args.label} split {label}: whole {whole:.2f} us; staging and launch {stage:.2f}, "
              f"sort {sort:.2f}, walk {walk:.2f} us (medians of {args.runs})", flush=True)
    print(json.dumps({"rank_split": {r[0]: dict(zip(("whole", "staging", "sort", "walk"), r[1:]))
                                     for r in result}, "label": args.label, "card": smi}))
    return result


if __name__ == "__main__":
    main()
