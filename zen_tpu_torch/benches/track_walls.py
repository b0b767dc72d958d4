"""The 4-minute track through ``HPRIOffline.process``, for comparing two trees in one call.

    python zen_tpu_torch/benches/track_walls.py [--tree DIR] [--label NAME] [--runs 5]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``step_walls.py`` does, so that one call on the card
can run another checkout's package beside this one's, in turns (parent,
change, change, parent), each in its own process. Separates a 4-minute
track (240 s at 44.1 kHz: tones, decaying noise bursts every 0.5 s and a
noise floor at 0.01, from one numpy seed) with BASELINE.json configs[0]
(``HPRIOffline(44100, 4096, 256, 2.5, 2.5)``, chip_smoke.py phase 8) on
the card: the mean host wall of ``--runs`` synchronized ``process()``
calls after one warm call, then one call under torch.profiler: its
device ops, their summed device time (device busy) and each median
kernel's, by name. Beside them the SHA-256 of the three stems' bytes:
two trees' outputs compare without a CPU run. Prints the card's name and
power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

FS = 44100.0
SECONDS = 240


def track(seed: int = 8):
    """The track's samples, float32 (chip_smoke.py's synthetic_mix)."""
    import numpy as np

    n = int(SECONDS * FS)
    t = np.arange(n) / FS
    mix = 0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
    rng = np.random.default_rng(seed)
    for onset in np.arange(0.25, SECONDS, 0.5):
        i = int(onset * FS)
        mix[i : i + 400] += rng.standard_normal(400) * np.exp(-np.arange(400) / 60)
    mix += 0.01 * rng.standard_normal(n)
    return mix.astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    import zen_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zen_tpu_torch import HPRIOffline

    if not zen_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"zen_tpu_torch came from {zen_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("track_walls times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sep = HPRIOffline(FS, 4096, 256, 2.5, 2.5, device="cuda")
    x = torch.from_numpy(track()).to("cuda")
    stems = sep.process(x)
    torch.cuda.synchronize()
    digest = hashlib.sha256(b"".join(s.contiguous().cpu().numpy().tobytes() for s in stems))
    t0 = time.perf_counter()
    for _ in range(args.runs):
        sep.process(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sep.process(x)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    medians = {name: us for name, us in by_name.items() if "median" in name}
    out = {"label": args.label, "card": smi, "wall_s": wall, "device_ops": len(ops),
           "device_busy_us": sum(by_name.values()) if ops else None,
           "median_kernels_us": medians, "sha256": digest.hexdigest()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
