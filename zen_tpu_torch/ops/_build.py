"""Build and load the port's CUDA kernels (``zen_tpu_torch/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/zen_tpu_torch/`` at the repository root,
named by a hash of the sources, the headers they share (``*.cuh``), the
generated headers and the flags, so an edited source, header, schedule or
flag rebuilds and an unchanged tree reuses the library. The generated
headers are ``zen_select.cuh``, the median networks of the small-K routes
(``select_network.emit_header``), and ``zen_core.cuh``, the shared-core
networks of K1 and K2 (``select_network.emit_core_header``): their text is
written to ``build/zen_tpu_torch/gen_<hash of the text>/`` before a build, and that
directory goes on ``nvcc``'s include path. ``nvcc``'s register
and shared-memory report (``-Xptxas -v``) is kept beside it as
``<name>.log``. ``library(cut)`` builds the same sources with
``-DZEN_RANK_CUT=cut`` (1 or 2: the rank kernels end after staging or
after the sort, ``csrc/rank_select.cuh``), a library of its own that
only chip_smoke.py's split of a rank block's time loads; it leaves out
``CORE_SOURCES`` (K1's and K2's shared cores, which have no rank kernel
to cut) and their entries.

Every C entry returns ``cudaGetLastError()`` after its launch; the
wrappers in ``median_cuda.py``, ``probe_cuda.py`` and ``mask_cuda.py``
raise on a nonzero code through ``check``. Nothing here is imported or built on a machine without CUDA
unless a CUDA tensor reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from . import select_network

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zen_tpu_torch"
GENERATED_HEADER = "zen_select.cuh"
GENERATED_CORE_HEADER = "zen_core.cuh"
# the shared cores, K1's and K2's: the full library only
CORE_SOURCES = ("median_time_core*.cu", "median_freq_core*.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# a, b, out, c, ta, tb, f, start, t_out, plan (device), min_o, span, staged, run, k,
# fill: the arguments K1's rank and select routes share
_TIME_PLAN = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, ctypes.c_float]
# the rank route: the lane run, the tap set's change points and the columns a
# block before the stream
_TIME_RANK = (_TIME_PLAN + [_I, _I, _I, _P], _I)
# the select route: the block's threads, `unit` and `shared_bins` before the stream
_TIME_SELECT = (_TIME_PLAN + [_I, _I, _I, _P], _I)
# x, out, rows, f_in, f_out, k, mode, stream
_FREQ = ([_P, _P, _I, _I, _I, _I, _I, _P], _I)
# the same, with the tile, the run and the threads before the stream
_FREQ_RANK = ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)
# the same, with the key store in place of the tile
_FREQ_RANK_STORE = ([_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P], _I)
# the same, with the select route's tile, threads and shared_bins in place of the tile
_FREQ_SELECT = ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I)
# a, b, out, c, ta, tb, f, start, t_out, offsets (device), k, fill, slots a lane, stream
_TIME_WARP = ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, ctypes.c_float, _I, _P], _I)
# a, b, out, c, ta, tb, f, start, t_out, rows (host), staged, slots (host), run, k,
# fill, stream
_TIME_NETWORK = ([_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I,
                  ctypes.POINTER(_I), _I, _I, ctypes.c_float, _P], _I)
# a, b, out, c, ta, tb, f, start, t_out, firsts (host), tap runs, shape, k, fill, stream
_TIME_CORE = ([_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I, _I, _I,
               ctypes.c_float, _P], _I)
# x, out, c, t, f, start, t_out, run, stream
_ROWS_COPY = ([_P, _P, _I, _I, _I, _I, _I, _I, _P], _I)
# x, out, rows, f, k, mode, tile, stream
_SEGMENT_COPY = ([_P, _P, _I, _I, _I, _I, _I, _P], _I)
# the same, without the tile
_SEGMENT_COPY_VALUES = ([_P, _P, _I, _I, _I, _I, _P], _I)
# h, p, s, out, n, inner, stride, stems (count, codes), need_h, need_p, output_harmonic,
# output_percussive, eps, beta, beta - eps, pairs, SMs, stream
_MASK_APPLY = ([_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, _I, _I, _P], _I)
_SIGNATURES = {
    "zen_mask_apply": _MASK_APPLY,
    "zen_rows_copy": _ROWS_COPY,
    "zen_rows_copy_bf16": _ROWS_COPY,
    "zen_segment_copy": _SEGMENT_COPY,
    "zen_segment_copy_bf16": _SEGMENT_COPY,
    "zen_segment_copy_values": _SEGMENT_COPY_VALUES,
    "zen_segment_copy_values_bf16": _SEGMENT_COPY_VALUES,
    "zen_tap_median_time_network": _TIME_NETWORK,
    "zen_tap_median_time_network_bf16": _TIME_NETWORK,
    "zen_sliding_median_network": _FREQ,
    "zen_sliding_median_network_bf16": _FREQ,
    "zen_tap_median_time_rank": _TIME_RANK,
    "zen_tap_median_time_rank_bf16": _TIME_RANK,
    "zen_tap_median_time_warp": _TIME_WARP,
    "zen_tap_median_time_warp_bf16": _TIME_WARP,
    "zen_tap_median_time_select": _TIME_SELECT,
    "zen_tap_median_time_select_bf16": _TIME_SELECT,
    "zen_sliding_median_rank": _FREQ_RANK,
    "zen_sliding_median_rank_bf16": _FREQ_RANK,
    "zen_sliding_median_rank_store": _FREQ_RANK_STORE,
    "zen_sliding_median_rank_store_bf16": _FREQ_RANK_STORE,
    "zen_sliding_median_select": _FREQ_SELECT,
    "zen_sliding_median_select_bf16": _FREQ_SELECT,
    "zen_cuda_error_string": ([_I], ctypes.c_char_p),
}
# x, out, rows, f_in, f_out, k, mode, shape, stream
_FREQ_CORE = ([_P, _P, _I, _I, _I, _I, _I, _I, _P], _I)
_CORE_SIGNATURES = {
    "zen_tap_median_time_core": _TIME_CORE,
    "zen_tap_median_time_core_bf16": _TIME_CORE,
    "zen_sliding_median_core": _FREQ_CORE,
    "zen_sliding_median_core_bf16": _FREQ_CORE,
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


def _flags(cut: int) -> tuple:
    return NVCC_FLAGS + ((f"-DZEN_RANK_CUT={cut}",) if cut else ())


def _sources(cut: int) -> list:
    """The library's ``.cu`` sources: all of them, less CORE_SOURCES in a
    split build."""
    core = {src for pattern in CORE_SOURCES for src in CSRC.glob(pattern)}
    return [src for src in sorted(CSRC.glob("*.cu")) if not cut or src not in core]


def generated_headers() -> tuple:
    """((name, text), ...) of the generated headers."""
    return ((GENERATED_HEADER, select_network.emit_header()),
            (GENERATED_CORE_HEADER, select_network.emit_core_header()))


def library_path(cut: int = 0) -> Path:
    """Where the library for the current sources, headers (the generated
    ones included) and flags lives."""
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(_flags(cut)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for name, text in generated_headers():
        h.update(name.encode())
        h.update(text.encode())
    return BUILD_DIR / f"libzen_median_{h.hexdigest()[:16]}.so"


def generated_include_dir() -> Path:
    """Write the generated headers (where their text is not there yet) and
    return the directory that holds them, named by the texts' hash:
    builds that run at once write the same bytes, and an edited schedule
    gets a directory of its own."""
    h = hashlib.sha256()
    for name, text in generated_headers():
        h.update(name.encode())
        h.update(text.encode())
    out = BUILD_DIR / f"gen_{h.hexdigest()[:16]}"
    for name, text in generated_headers():
        header = out / name
        if not header.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = header.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, header)
    return out


@functools.lru_cache(maxsize=3)
def library(cut: int = 0) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure.
    ``cut`` 1 or 2 is the split build (module note), never a wrapper's."""
    if cut not in (0, 1, 2):
        raise ValueError(f"ZEN_RANK_CUT is 0, 1 or 2, got {cut}")
    out = library_path(cut)
    if not out.exists():
        # processes started together (a multi-process corpus) build once:
        # the first takes the lock and builds, the others wait and load.
        # The lock is the library's own, so that its split builds
        # (chip_smoke.py's phase 2) still compile at the same time.
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                _build(out, cut)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in {**_SIGNATURES, **({} if cut else _CORE_SIGNATURES)}.items():
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


def _build(out: Path, cut: int) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    flags, sources = _flags(cut), _sources(cut)
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    nvcc, log = _nvcc(), []
    include = f"-I{generated_include_dir()}"
    try:
        _run([subprocess.Popen([nvcc, *flags, include, "-c", "-o", str(obj), str(src)],
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
