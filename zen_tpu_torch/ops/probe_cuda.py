"""Copy-only mirrors of the median kernels and their plain twins.

Counterpart of the two Pallas copy kernels of ``benches/hbm_pattern.py``
(``_time_dma_kernel`` and ``_freqT_dma_kernel``): the serving-state bound
hunt times each median kernel beside a copy with the same access pattern
(``zen_tpu_torch/benches/hbm_pattern.py``). Both kernels live in
``csrc/probe_copy.cu``:

* ``rows_copy`` (#9): rows ``start .. start + t_out`` of each [T, F]
  block of x [C, T, F], with the launch geometry and index arithmetic of
  K1's network kernel (``csrc/time_runs.cuh``, shared with K1);
* ``segment_copy`` (#10): x [..., F] itself, read through the row-segment
  staging of the route K2 takes at width ``k`` (``freq_route``: the
  network route's own-type values or the rank route's keys in shared
  memory) and a ``reflect``, ``wrap`` or ``edge`` border
  (``csrc/row_segment.cuh``, shared with K2). It mirrors K2's shared
  staging only: a width whose keys pass shared memory (K2's key store,
  ``freq_rank_store``) is refused.

The conventions are ``median_cuda.py``'s: float32 or bfloat16, the
input's dtype out; a CPU tensor takes the ``_plain`` twin, a CUDA tensor
the kernel (contiguous operands, the launch's error code checked, no
fallback); ``launches`` on each wrapper counts its kernel launches.
"""
from __future__ import annotations

import math

import torch

from ..errors import ZenError
from . import _build
from .median_cuda import (
    FREQ_MODES,
    _check_cuda_operands,
    _check_dtype,
    _check_k,
    _entry,
    _launch,
    freq_rank_store,
    freq_rank_tile,
    freq_route,
    time_fill_run,
)

SEGMENT_MODES = ("reflect", "wrap", "edge")
# segment_copy's widths: the cap K2 had while its counting kernel staged a
# 256 + K - 1 float segment in 227 KB of shared memory; past 16,353 taps
# the mirror refuses anyway (K2's keys leave shared memory there)
SEGMENT_COPY_MAX_TAPS = 57_857


# ---------------- #9: rows_copy ----------------


def _check_rows(x: torch.Tensor, start: int, t_out: int) -> None:
    _check_dtype(x)
    if x.dim() != 3:
        raise ZenError(f"rows_copy takes x [C, T, F], got shape {tuple(x.shape)}")
    t = x.shape[1]
    if start < 0 or t_out < 0 or start + t_out > t:
        raise ZenError(f"rows_copy: rows {start} .. {start + t_out} outside [0, {t}]")


def rows_copy_plain(x: torch.Tensor, start: int, t_out: int) -> torch.Tensor:
    """Plain twin of ``rows_copy``."""
    _check_rows(x, start, t_out)
    return x[:, start : start + t_out].clone()


def rows_copy(x: torch.Tensor, start: int, t_out: int) -> torch.Tensor:
    """out[c, i, f] = x[c, start + i, f] for i < ``t_out``: a copy of
    rows start .. start + t_out of each stream's block of x [C, T, F]."""
    start, t_out = int(start), int(t_out)
    _check_rows(x, start, t_out)
    if not x.is_cuda:
        return rows_copy_plain(x, start, t_out)
    _check_cuda_operands(x)
    c, t, f = x.shape
    out = torch.empty((c, t_out, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _launch(x, _entry(_build.library(), "zen_rows_copy", x.dtype),
                  x.data_ptr(), out.data_ptr(), c, t, f, start, t_out,
                  time_fill_run(t_out, c, f))
    _build.check(err, "rows_copy")
    rows_copy.launches += 1
    return out


rows_copy.launches = 0


# ---------------- #10: segment_copy ----------------


def _check_segment(x: torch.Tensor, k: int, mode: str):
    """sliding_median_boundary's checks for a border that keeps the
    width; returns K2 rank's tile for ``k``, or None where K2 takes its
    network route."""
    if mode not in SEGMENT_MODES:
        raise ZenError(f"segment_copy takes a border of {SEGMENT_MODES}, got {mode!r}")
    _check_k(k, SEGMENT_COPY_MAX_TAPS, "segment_copy's own cap")
    _check_dtype(x)
    f = x.shape[-1] if x.dim() else 0
    if f < 1 or (mode == "reflect" and (k - 1) // 2 > f - 1):
        raise ZenError(f"median width {k} does not fit {f} samples ({mode})")
    if freq_route(k) == "network":
        return None
    if freq_rank_store(k) == "scratch":
        raise ZenError(f"segment_copy: the keys of width {k} do not fit a block's shared memory")
    return freq_rank_tile(k)


def segment_copy_plain(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """Plain twin of ``segment_copy``."""
    _check_segment(x, k, mode)
    return x.clone()


def segment_copy(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """out = x [..., F], read as K2 reads a row at width ``k``: each
    block stages its segment (border ``mode`` applied on the load) in
    shared memory, as the network route's own-type values or the rank
    route's 64-bit keys of tile + k - 1 samples, then writes its outputs'
    own samples back out."""
    k = int(k)
    tile = _check_segment(x, k, mode)
    if not x.is_cuda:
        return segment_copy_plain(x, k, mode)
    _check_cuda_operands(x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name, extra = ("zen_segment_copy_values", ()) if tile is None else ("zen_segment_copy", (tile,))
    err = _launch(x, _entry(_build.library(), name, x.dtype),
                  x.data_ptr(), out.data_ptr(), math.prod(x.shape[:-1]), x.shape[-1], k,
                  FREQ_MODES[mode], *extra)
    _build.check(err, "segment_copy")
    segment_copy.launches += 1
    return out


segment_copy.launches = 0
