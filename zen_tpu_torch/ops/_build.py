"""Build and load the port's CUDA kernels (``zen_tpu_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/zen_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source or flag
rebuilds and an unchanged tree reuses the library. ``nvcc``'s register
and shared-memory report (``-Xptxas -v``) is kept beside it as
``<name>.log``.

Every C entry returns ``cudaGetLastError()`` after its launch; the
wrappers in ``median_cuda.py`` raise on a nonzero code through
``check``. Nothing here is imported or built on a machine without CUDA
unless a CUDA tensor reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zen_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# a, b, out, c, ta, tb, f, start, t_out, offsets, k, fill, stream
_TIME = ([_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I,
          ctypes.c_float, _P], _I)
# the same, with `offsets` a device buffer (K above 64)
_TIME_WIDE = ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, ctypes.c_float, _P], _I)
# x, out, rows, f_in, f_out, k, mode, stream
_FREQ = ([_P, _P, _I, _I, _I, _I, _I, _P], _I)
_SIGNATURES = {
    "zen_tap_median_time": _TIME,
    "zen_tap_median_time_bf16": _TIME,
    "zen_tap_median_time_wide": _TIME_WIDE,
    "zen_tap_median_time_wide_bf16": _TIME_WIDE,
    "zen_sliding_median_boundary": _FREQ,
    "zen_sliding_median_boundary_bf16": _FREQ,
    "zen_cuda_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of zen_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libzen_median_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _run(procs: list, log: list) -> None:
    """Wait for every nvcc in ``procs``, keep its output, raise on failure."""
    failed = []
    for proc in procs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(proc.args) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{stderr[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    nvcc, log = _nvcc(), []
    try:
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for src, obj in zip(sources, objs)], log)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                *map(str, objs)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)],
             log)
        os.replace(tmp, out)
    finally:
        out.with_suffix(".log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().zen_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
