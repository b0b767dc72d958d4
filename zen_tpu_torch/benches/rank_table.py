"""Where K1's rank route keeps its multiplicity table, timed on the card.

    python -m zen_tpu_torch.benches.rank_table [--runs 30] [--rounds 3]

``launch_rank`` (csrc/median_time.cu) puts the table in shared memory
beside the sorted keys where both fit the device's opt-in limit, and has
the walk read it from device memory through the read-only cache past
that (spans of about 57,000 rows). This times the same rank kernel both
ways at the shapes the paths give it: the library as built, and a second
build of a copy of the sources (under ``build/zen_tpu_torch/``) whose
``launch_rank`` always leaves the table in device memory. Each row is
held bitwise against the plain twin through both builds, then timed in
turns (shared, device, device, shared, ...) for ``--rounds`` pairs: each
time is the median of ``--runs`` single calls' device time
(``runtime.profiling.device_ms``). Prints the card's name and power
limit, then one line a row, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import median_cuda as mc
from ..runtime.profiling import device_ms

# launch_rank's choice, and what the device-memory build puts in its place
CHOICE = "const bool shared_table = keys + table <= static_cast<size_t>(optin);"
DEVICE_ONLY = "const bool shared_table = false;"
T93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32, causal wrap


def device_table_library():
    """The library built from a copy of the sources whose launch_rank
    never puts the table in shared memory."""
    root = _build.BUILD_DIR / "rank_table_device"
    src = root / "csrc"
    src.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        shutil.copy(f, src / f.name)
    text = (src / "median_time.cu").read_text()
    if text.count(CHOICE) != 1:
        raise SystemExit(f"launch_rank's table choice not found once in median_time.cu: {CHOICE}")
    (src / "median_time.cu").write_text(text.replace(CHOICE, DEVICE_ONLY))
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = src, root / "lib"
    try:
        _build.library.cache_clear()
        return _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build.library.cache_clear()


def rows(device):
    rng = np.random.default_rng(0)

    def mag(*shape):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device)

    return [
        ("pair C=1 H=183 B=32 F=65 K=93 (hop 32)", mag(1, 183, 65), mag(1, 32, 65), T93, 183),
        ("pair C=1 H=183 B=1 F=65 K=93 (hop 32)", mag(1, 183, 65), mag(1, 1, 65), T93, 183),
        ("pair C=1 H=183 B=32 F=65 K=93 bf16", mag(1, 183, 65).bfloat16(),
         mag(1, 32, 65).bfloat16(), T93, 183),
        ("single T=900 F=17 K=401 centered", mag(1, 900, 17), mag(1, 0, 17),
         tuple(range(-200, 201)), 0),
        ("single T=300 F=9 K=67 span 16354 (far taps)", mag(1, 300, 9), mag(1, 0, 9),
         (-16353,) + tuple(range(-65, 1)), 0),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rank_table times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    libs = {"shared": _build.library(), "device": device_table_library()}
    print(f"built both libraries in {time.perf_counter() - t0:.1f} s")
    library = _build.library
    result = {}
    try:
        for label, a, b, offs, start in rows("cuda"):
            def launch(lib):
                _build.library = lambda cut=0: lib
                return mc._time_launch(a, b, offs, start, 0.0, "rank")

            want = mc.tap_median_time_plain(a, b, offs, start)
            for name, lib in libs.items():
                if not torch.equal(launch(lib), want):
                    raise SystemExit(f"{label}: the {name}-table build disagrees with the twin")
            us = {"shared": [], "device": []}
            for order in (("shared", "device"), ("device", "shared")) * args.rounds:
                for name in order:
                    us[name].append(device_ms(lambda x, lib=libs[name]: (launch(lib), x)[1],
                                              a, iters=1, repeats=args.runs) * 1e3)
            med = {name: float(np.median(v)) for name, v in us.items()}
            result[label] = {"shared_us": us["shared"], "device_us": us["device"],
                             "median_shared_us": med["shared"],
                             "median_device_us": med["device"]}
            print(f"{label}: shared {med['shared']:.2f} us, device {med['device']:.2f} us "
                  f"(each the median of {len(us['shared'])} medians; shared "
                  f"{min(us['shared']):.2f}-{max(us['shared']):.2f}, device "
                  f"{min(us['device']):.2f}-{max(us['device']):.2f})")
    finally:
        _build.library = library
    print(json.dumps({"rank_table": result, "card": smi.stdout.strip()}))
    return result


if __name__ == "__main__":
    main()
