"""Which frames of the BTrack ODF a thread's floating-point state moves.

    python -m zen_tpu_torch.tools.odf_fp_probe [--threads 3]

A diagnostic for ROADMAP Queue 3 item 8 (``odf_batch`` on the CPU once
moved a block of 8 of 24 frames). Builds a small C helper with ``gcc
-fopenmp`` against torch's own OpenMP runtime (into ``build/``), which
sets a rounding mode (``fesetround``), and optionally FTZ/DAZ, on one
thread of the pool that torch's CPU FFT shares. For each mode it prints
the frames of the 24-frame noise ODF of ``tests/test_torch_apps.py``
that move against a clean run, by how much, and against the test's
tolerance, both while the mode is set on a worker thread and after a
mode set on the calling thread at the FFT's first use is restored (each
first use in a fresh process). CPU only; prints one JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..apps import btrack as tb

ROOT = Path(__file__).resolve().parents[2]
MODES = {"nearest": 0x000, "downward": 0x400, "upward": 0x800, "towardzero": 0xC00}
HELPER = r"""
#include <fenv.h>
#include <omp.h>
#include <xmmintrin.h>
/* the rounding mode (and FTZ/DAZ or not) on OpenMP thread `tid` of the pool */
void set_on_thread(int tid, int mode, int ftz) {
  #pragma omp parallel
  if (omp_get_thread_num() == tid) {
    fesetround(mode);
    _mm_setcsr(ftz ? (_mm_getcsr() | 0x8040) : (_mm_getcsr() & ~0x8040));
  }
}
"""


def helper() -> ctypes.CDLL:
    """The C helper, built at first use against torch's libgomp."""
    lib_dir = Path(torch.__file__).parent / "lib"
    out = ROOT / "build" / "zen_tpu_torch" / "odf_fp_probe.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".c")
        src.write_text(HELPER)
        subprocess.run(["gcc", "-O2", "-fopenmp", "-shared", "-fPIC", "-o", str(out), str(src),
                        f"-L{lib_dir}", "-l:libgomp.so.1", f"-Wl,-rpath,{lib_dir}"], check=True)
    return ctypes.CDLL(str(out))


def frames() -> torch.Tensor:
    """tests/test_torch_apps.py's noise case: 24 frames of 0.2 x white noise."""
    audio = np.random.default_rng(1).standard_normal(256 * 24).astype(np.float32) * 0.2
    return torch.from_numpy(tb.frames_from_hops(audio))


def moved(got: np.ndarray, base: np.ndarray) -> dict:
    tol = 1e-5 * float(np.abs(base).max())
    d = got - base
    return {"frames": np.nonzero(d)[0].tolist(),
            "over_tolerance": np.nonzero(np.abs(d) > tol)[0].tolist(),
            "max_abs": float(np.abs(d).max()), "tolerance": tol}


def first_use(mode: int, threads: int) -> None:
    """In this (fresh) process: the calling thread in ``mode`` at the FFT's
    first use, then restored; prints the restored run's ODF as JSON."""
    torch.set_num_threads(threads)
    lib = helper()
    lib.set_on_thread(0, mode, 0)
    tb.odf_batch(frames())
    lib.set_on_thread(0, 0, 0)
    print(json.dumps(tb.odf_batch(frames()).numpy().tolist()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--first-use", type=lambda v: int(v, 0), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.first_use is not None:
        first_use(args.first_use, args.threads)
        return {}
    torch.set_num_threads(args.threads)
    lib = helper()
    x = frames()
    base = tb.odf_batch(x).numpy()
    report = {"threads": args.threads, "worker": {}, "first_use": {}}
    for name, mode in MODES.items():
        for ftz in (0, 1):
            lib.set_on_thread(1, mode, ftz)
            got = tb.odf_batch(x).numpy()
            lib.set_on_thread(1, 0, 0)
            report["worker"][f"{name}{' ftz' if ftz else ''}"] = r = moved(got, base)
            print(f"thread 1 {name}{' +FTZ/DAZ' if ftz else ''}: frames {r['frames']}, over "
                  f"tolerance {r['over_tolerance']}, max |diff| {r['max_abs']:.4g}")
        out = subprocess.run([sys.executable, "-m", "zen_tpu_torch.tools.odf_fp_probe",
                              "--threads", str(args.threads), "--first-use", hex(mode)],
                             capture_output=True, text=True, check=True, cwd=ROOT)
        got = np.asarray(json.loads(out.stdout.strip().splitlines()[-1]), np.float32)
        report["first_use"][name] = r = moved(got, base)
        print(f"calling thread {name} at first use, restored: frames {r['frames']}, over "
              f"tolerance {r['over_tolerance']}, max |diff| {r['max_abs']:.4g}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
