"""Build and load the port's CUDA kernels (``zen_tpu_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # a, b, out, c, ta, tb, f, start, t_out, offsets, k, fill, stream
    "zen_tap_median_time": (
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I,
         ctypes.c_float, _P],
        _I,
    ),
    # the same, with `offsets` a device buffer (K above 64)
    "zen_tap_median_time_wide": (
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, ctypes.c_float, _P],
        _I,
    ),
    # x, out, rows, f_in, f_out, k, mode, stream
    "zen_sliding_median_boundary": ([_P, _P, _I, _I, _I, _I, _I, _P], _I),
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
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().zen_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
