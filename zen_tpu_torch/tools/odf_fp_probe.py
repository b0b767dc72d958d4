"""Which frames of the BTrack ODF a thread's floating-point state moves,
and whether the ODF stays bitwise the same under load.

    python -m zen_tpu_torch.tools.odf_fp_probe [--threads 3]
    python -m zen_tpu_torch.tools.odf_fp_probe --stress 6 [--threads 8]
        [--seconds 120] [--codec] [--fresh-plans] [--malloc-perturb 165]
        [--hook tests/odf_jax_lead.py:hold_alias]

A diagnostic for ROADMAP Queue 3 item 8 (``odf_batch`` on the CPU once
moved a block of 8 of 24 frames). Builds a small C helper with ``gcc
-fopenmp`` against torch's own OpenMP runtime (into ``build/``), which
sets a rounding mode (``fesetround``), and optionally FTZ/DAZ, on one
thread of the pool that torch's CPU FFT shares. For each mode it prints
the frames of the 24-frame noise ODF of ``tests/test_torch_apps.py``
that move against a clean run, by how much, and against the test's
tolerance, both while the mode is set on a worker thread and after a
mode set on the calling thread at the FFT's first use is restored (each
first use in a fresh process).

``--stress N`` runs N processes at once, each with torch at ``--threads``
intra-op threads (a pytest-xdist worker's count on a machine of that
many cores), calling ``odf_batch``'s two halves (``odf_spectrum``, then
``odf_from_spectrum``) on the same frames for ``--seconds`` and holding
each call's spectrum and ODF bit for bit against the process's reference
call (the first of three that agree). Around every call it reads MXCSR
(``stmxcsr``: rounding, FTZ/DAZ and the exception flags) on the calling
thread and on every thread of torch's OpenMP pool, and the x87 control
word. A mismatch records the spectrum rows that moved, each row's error
against a float64 FFT of the same rows beside the reference's, the frames
that moved, those FP states before and after the call, torch's thread
count and MKL's (torch's CPU FFT is MKL's here). ``--codec`` runs native
codec round trips (FLAC, WavPack and PCM16 WAV, written and read back
through ``runtime/native.py``, as ``tests/test_torch_audio.py`` does) in
the same process before each ODF call; ``--fresh-plans`` precedes each
call with an FFT of another batch size, so that MKL commits a new
descriptor between calls. ``--malloc-perturb B`` sets glibc's
``MALLOC_PERTURB_`` to B in the worker processes alone, so that memory
malloc hands out reads as B's complement and freed memory as B: a read
of freed or unwritten memory then shows as garbage, not as near-right
values. ``--hook FILE:FUNC`` gives each call fresh frames (a new numpy
array, as the test builds them) and calls FUNC(frames) from FILE first,
holding what it returns until the port's call has ended (the test's
order: ``tests/odf_jax_lead.py:hold_alias`` runs zen_tpu's ODF on the
frames and keeps JAX's zero-copy view of them alive). CPU only; prints
one JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..apps import btrack as tb

ROOT = Path(__file__).resolve().parents[2]
MODES = {"nearest": 0x000, "downward": 0x400, "upward": 0x800, "towardzero": 0xC00}
MXCSR_DEFAULT = 0x1F80  # round to nearest, every exception masked, no FTZ/DAZ, no flags
MXCSR_STICKY = 0x3F  # the exception flags, which arithmetic sets and nothing clears
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
/* MXCSR of the calling thread */
unsigned mxcsr_here(void) { return _mm_getcsr(); }
/* the x87 control word of the calling thread (what glibc's fegetround reads) */
unsigned x87_control_word(void) {
  unsigned short cw;
  __asm__ volatile("fnstcw %0" : "=m"(cw));
  return cw;
}
/* MXCSR of each thread of the pool into out[0 .. n): out[t] for OpenMP
   thread t (0 is the calling thread); returns the team's size */
int mxcsr_pool(unsigned *out, int n) {
  int team = 0;
  #pragma omp parallel
  {
    const int t = omp_get_thread_num();
    if (t < n) out[t] = _mm_getcsr();
    if (t == 0) team = omp_get_num_threads();
  }
  return team;
}
"""


def helper() -> ctypes.CDLL:
    """The C helper, built at first use against torch's libgomp (named by
    a hash of its source, so an edited helper rebuilds)."""
    lib_dir = Path(torch.__file__).parent / "lib"
    tag = hashlib.sha256(HELPER.encode()).hexdigest()[:12]
    out = ROOT / "build" / "zen_tpu_torch" / f"odf_fp_probe_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".c")
        src.write_text(HELPER)
        subprocess.run(["gcc", "-O2", "-fopenmp", "-shared", "-fPIC", "-o", str(out), str(src),
                        f"-L{lib_dir}", "-l:libgomp.so.1", f"-Wl,-rpath,{lib_dir}"], check=True)
    lib = ctypes.CDLL(str(out))
    lib.mxcsr_here.restype = lib.x87_control_word.restype = ctypes.c_uint
    lib.mxcsr_pool.argtypes = [ctypes.POINTER(ctypes.c_uint), ctypes.c_int]
    return lib


def fp_state(lib) -> dict:
    """MXCSR of the calling thread and of each thread of torch's OpenMP
    pool (hex), the pool's team size and the x87 control word."""
    n = torch.get_num_threads()
    pool = (ctypes.c_uint * n)()
    team = lib.mxcsr_pool(pool, n)
    return {"mxcsr": f"{lib.mxcsr_here():#06x}",
            "pool_mxcsr": [f"{v:#06x}" for v in pool[:team]],
            "x87_cw": f"{lib.x87_control_word():#06x}"}


def unusual(state: dict) -> set:
    """The MXCSR values of ``state`` other than the default (the
    exception flags, which arithmetic sets on any thread, masked off)."""
    return {v for v in [state["mxcsr"], *state["pool_mxcsr"]]
            if int(v, 16) & ~MXCSR_STICKY != MXCSR_DEFAULT}


def mkl_threads() -> int | None:
    """MKL's own thread count (mkl_get_max_threads), where torch's CPU
    library exports it, else None."""
    try:
        lib = ctypes.CDLL(str(Path(torch.__file__).parent / "lib" / "libtorch_cpu.so"))
        return int(lib.mkl_get_max_threads())
    except (OSError, AttributeError):
        return None


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


def _row_errors(spec: np.ndarray, exact: np.ndarray) -> list:
    """Each row's max |spec - exact| over the row's max |exact|."""
    return (np.abs(spec - exact).max(-1) / np.abs(exact).max(-1)).tolist()


def _codec_round_trip(workdir: Path, rng: np.random.Generator) -> None:
    """Native codec calls as tests/test_torch_audio.py makes them: a short
    stereo clip written as FLAC, WavPack and PCM16 WAV and read back."""
    from ..io import audio
    from ..runtime import native

    x = np.clip(0.5 * rng.standard_normal((4000, 2)), -1, 1).astype(np.float32)
    for name, write in (("c.flac", native.flac_write), ("c.wv", native.wv_write)):
        write(str(workdir / name), 8000, x)
        audio.read_audio_mono(str(workdir / name))
    audio.write_wav_pcm16(str(workdir / "c.wav"), 8000, x[:, 0])
    audio.read_audio_mono(str(workdir / "c.wav"))


def _load_hook(spec: str):
    """FUNC of ``FILE:FUNC`` (FILE relative to the repository root)."""
    import importlib.util

    path, _, name = spec.rpartition(":")
    module_spec = importlib.util.spec_from_file_location("odf_probe_hook", ROOT / path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return getattr(module, name)


def stress_worker(threads: int, seconds: float, codec: bool, fresh_plans: bool,
                  hook: str | None = None) -> dict:
    """One process of the stress mode (module note); prints one JSON line
    per mismatch and returns the summary."""
    torch.set_num_threads(threads)
    lib = helper()
    x = frames()
    hold = _load_hook(hook) if hook else None
    exact = np.fft.fft(tb.odf_fft_input(x).double().numpy(), axis=-1)
    calls = [tb.odf_spectrum(x) for _ in range(3)]
    if not all(torch.equal(c, calls[0]) for c in calls[1:]):
        print(json.dumps({"pid": os.getpid(), "reference": "the first three calls differ"}),
              flush=True)
    ref_spec = calls[0]
    ref = tb.odf_from_spectrum(ref_spec).numpy()
    ref_err = _row_errors(ref_spec.numpy(), exact)
    seen, mismatches, n = set(), [], 0
    rng = np.random.default_rng(os.getpid())
    with tempfile.TemporaryDirectory() as tmp:
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            n += 1
            if codec:
                _codec_round_trip(Path(tmp), rng)
            if fresh_plans:
                torch.fft.fft(torch.ones(25 + n % 64, 512), dim=-1)
            held = None
            if hold:
                fresh = tb.frames_from_hops(x[:, tb.HOP_SIZE:].numpy().reshape(-1))
                held = hold(fresh)
                x = torch.from_numpy(fresh)
            before = fp_state(lib)
            spec = tb.odf_spectrum(x)
            odf = tb.odf_from_spectrum(spec).numpy()
            after = fp_state(lib)
            del held
            seen |= unusual(before) | unusual(after)
            if torch.equal(spec, ref_spec) and np.array_equal(odf.view(np.uint32),
                                                              ref.view(np.uint32)):
                continue
            s = spec.numpy()
            rows = np.nonzero((s != ref_spec.numpy()).any(-1))[0].tolist()
            err = _row_errors(s, exact)
            hit = {"pid": os.getpid(), "call": n, "spectrum_rows": rows,
                   "row_error": {r: err[r] for r in rows},
                   "reference_row_error": {r: ref_err[r] for r in rows},
                   "frames": np.nonzero(odf != ref)[0].tolist(),
                   "max_abs": float(np.abs(odf - ref).max()),
                   "before": before, "after": after,
                   "torch_threads": torch.get_num_threads(), "mkl_threads": mkl_threads()}
            mismatches.append(hit)
            print(json.dumps(hit), flush=True)
    return {"pid": os.getpid(), "calls": n, "mismatches": len(mismatches),
            "malloc_perturb": os.environ.get("MALLOC_PERTURB_"), "hook": hook,
            "hook_stats": getattr(hold, "stats", None),
            "unusual_mxcsr": sorted(seen), "torch_threads": torch.get_num_threads(),
            "mkl_threads": mkl_threads(), "mkl": torch.backends.mkl.is_available(),
            "reference_max_row_error": max(ref_err)}


def stress(n: int, threads: int, seconds: float, codec: bool, fresh_plans: bool,
           malloc_perturb: int | None = None, hook: str | None = None) -> dict:
    """The stress mode: ``n`` worker processes at once (module note)."""
    argv = [sys.executable, "-m", "zen_tpu_torch.tools.odf_fp_probe", "--stress-worker",
            "--threads", str(threads), "--seconds", str(seconds)]
    argv += ["--codec"] * codec + ["--fresh-plans"] * fresh_plans
    argv += ["--hook", hook] if hook else []
    env = dict(os.environ)
    if malloc_perturb is not None:
        env["MALLOC_PERTURB_"] = str(malloc_perturb)
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for _ in range(n)]
    workers, hits = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=seconds + 600)
            if p.returncode:
                raise RuntimeError(f"stress worker exited {p.returncode}:\n{out[-2000:]}")
            lines = [json.loads(ln) for ln in out.strip().splitlines()]
            workers.append(lines[-1])
            hits += lines[:-1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = {"stress": n, "threads": threads, "seconds": seconds, "codec": codec,
              "fresh_plans": fresh_plans, "malloc_perturb": malloc_perturb, "hook": hook,
              "calls": sum(w["calls"] for w in workers),
              "mismatches": hits,
              "unusual_mxcsr": sorted({v for w in workers for v in w["unusual_mxcsr"]}),
              "workers": workers}
    print(f"stress: {n} processes x {threads} threads, {seconds:g} s, codec {codec}, fresh "
          f"plans {fresh_plans}, MALLOC_PERTURB_ {malloc_perturb}, hook {hook}: "
          f"{report['calls']} calls, {len(hits)} mismatches, MXCSR other "
          f"than {MXCSR_DEFAULT:#06x} (flags aside): {report['unusual_mxcsr'] or 'none'}")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--stress", type=int, default=0, help="processes of the stress mode")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--codec", action="store_true")
    ap.add_argument("--fresh-plans", action="store_true")
    ap.add_argument("--malloc-perturb", type=int, default=None)
    ap.add_argument("--hook", default=None)
    ap.add_argument("--stress-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--first-use", type=lambda v: int(v, 0), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.first_use is not None:
        first_use(args.first_use, args.threads)
        return {}
    if args.stress_worker:
        summary = stress_worker(args.threads, args.seconds, args.codec, args.fresh_plans,
                                args.hook)
        print(json.dumps(summary))
        return summary
    if args.stress:
        report = stress(args.stress, args.threads, args.seconds, args.codec, args.fresh_plans,
                        args.malloc_perturb, args.hook)
        print(json.dumps(report))
        return report
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
