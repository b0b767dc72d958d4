"""Hand-written CUDA median kernels and their plain PyTorch twins.

Counterpart of ``zen_tpu/ops/median_pallas.py``. Two kernels carry every
median of the streaming step (see the source notes in ``csrc/``):

* ``tap_median_time`` (K1, ``csrc/median_time.cu``): time-direction tap
  median over the virtual row concat of two inputs, replacing the Pallas
  ``_time_kernel_pair``, ``_time_kernel``, ``_time_kernel_pipelined`` and
  ``_time_kernel_piped``;
* ``sliding_median_boundary`` (K2, ``csrc/median_freq.cu``): frequency
  sliding median with the boundary rule applied in the kernel, replacing
  ``_freq_kernel_fused``, ``_freq_kernel``, ``_freq_kernel_pipelined``
  and the sublane route ``_freq_impl_sublane``.

Both take float32 or bfloat16 (the bf16 stream state) and return the
input's dtype. Each wrapper checks dtype, shape and K bounds, then takes
a CPU tensor to its ``_plain`` twin (built from
``ops/median.sliding_median``) and a CUDA tensor to its kernel, after
checking contiguity; it raises on anything the kernel does not take,
and never falls back. ``launches`` on each
wrapper counts its kernel launches, so a run can show that it went
through the kernel. Kernels launch on the current stream, never
synchronize and allocate nothing: the wrapper allocates the output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..errors import ZenError
from . import _build
from .median import sliding_median

# K1 keeps up to REGISTER_TAPS taps in registers; past that its wide
# kernel stages the offsets in the 48 KB of shared memory a block takes
# without an opt-in, which bounds K.
REGISTER_TAPS = 64
MAX_TIME_TAPS = 48 * 1024 // 4 - 1
# K2 stages a row segment of 256 + K - 1 floats in shared memory, which
# must fit the 227 KB (232,448 bytes) a block can opt into on Hopper.
MAX_FREQ_TAPS = 232_448 // 4 - 256 + 1
FREQ_MODES = {"reflect": 0, "wrap": 1, "edge": 2, "valid": 3}
_PLAIN_BOUNDARY = {"reflect": "reflect", "wrap": "wrap", "edge": "clamp"}


def _check_k(k: int, limit: int, bound: str) -> None:
    if k < 1 or k > limit or k % 2 == 0:
        raise ZenError(
            f"median kernel takes odd K in [1, {limit}] ({bound}), got {k}"
        )


DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(*xs: torch.Tensor) -> None:
    if xs[0].dtype not in DTYPES:
        raise ZenError(f"median kernels take float32 or bfloat16, got {xs[0].dtype}")
    if any(x.dtype != xs[0].dtype for x in xs):
        raise ZenError(f"median operands differ in dtype: {[x.dtype for x in xs]}")


def _check_cuda_operands(*xs: torch.Tensor) -> None:
    for x in xs:
        if not x.is_contiguous():
            raise ZenError("CUDA median kernels take contiguous tensors")
        if x.device != xs[0].device:
            raise ZenError("median operands lie on different devices")


def _entry(lib, name: str, dtype: torch.dtype):
    """The C entry for ``dtype``: ``name`` for float32, ``name_bf16``."""
    return getattr(lib, name if dtype == torch.float32 else f"{name}_bf16")


def _launch(x: torch.Tensor, entry, *args) -> int:
    """Call a C entry with ``x``'s device current (the library's own
    CUDA runtime launches into the current device's context) and that
    device's current stream appended; returns the entry's error code."""
    with torch.cuda.device(x.device):
        return entry(*args, torch.cuda.current_stream(x.device).cuda_stream)


# ---------------- K1: time-direction tap median ----------------


def tap_median_time_plain(
    a: torch.Tensor, b: torch.Tensor, offsets, start: int, fill: float = 0.0
) -> torch.Tensor:
    """Plain twin of ``tap_median_time``: materialize the concat and take
    the 'zero'-boundary sliding median of its rows from ``start`` on
    (``fill`` rounds to the inputs' dtype, as in the kernel)."""
    v = torch.cat([a, b], dim=-2)
    return sliding_median(v, offsets, -2, "zero", fill)[..., start:, :]


def tap_median_time(
    a: torch.Tensor, b: torch.Tensor, offsets, start: int, fill: float = 0.0
) -> torch.Tensor:
    """out[..., i, f] = median over o in ``offsets`` of V[..., start+i+o, f]
    for i in [0, Ta + Tb - start), where V = rows of ``a`` [..., Ta, F]
    then rows of ``b`` [..., Tb, F]; rows outside V read ``fill``.

    (a=hist, b=fresh, start=H) is the streaming step's pair form; an
    empty ``b`` gives the one-input form. ``a`` and ``b`` share one dtype,
    float32 or bfloat16, which the output takes; ``fill`` is rounded to
    it. Offsets: odd count up to MAX_TIME_TAPS, duplicates allowed.
    """
    offsets = tuple(int(o) for o in offsets)
    k = len(offsets)
    _check_k(k, MAX_TIME_TAPS, "offsets past 64 are staged in 48 KB of shared memory")
    _check_dtype(a, b)
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-1]:
        raise ZenError(f"tap_median_time: shapes {a.shape} and {b.shape}")
    ta, tb, f = a.shape[-2], b.shape[-2], a.shape[-1]
    if not 0 <= start <= ta + tb:
        raise ZenError(f"tap_median_time: start {start} outside [0, {ta + tb}]")
    if not a.is_cuda:
        return tap_median_time_plain(a, b, offsets, start, fill)
    _check_cuda_operands(a, b)
    lead = a.shape[:-2]
    t_out = ta + tb - start
    out = torch.empty(lead + (t_out, f), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    if k <= REGISTER_TAPS:
        entry = _entry(lib, "zen_tap_median_time", a.dtype)
        taps = (ctypes.c_int * k)(*offsets)
    else:
        entry = _entry(lib, "zen_tap_median_time_wide", a.dtype)
        taps = _device_offsets(offsets, a.device).data_ptr()
    err = _launch(
        a,
        entry,
        a.data_ptr(),
        b.data_ptr() if tb else a.data_ptr(),
        out.data_ptr(),
        math.prod(lead),
        ta,
        tb,
        f,
        start,
        t_out,
        taps,
        k,
        _in_dtype(fill, a.dtype),
    )
    _build.check(err, "tap_median_time")
    tap_median_time.launches += 1
    return out


tap_median_time.launches = 0


@functools.lru_cache(maxsize=8)
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as the plain twin's torch.where rounds
    its fill, handed to the kernel as a float (cached: one fill per
    config, so a launch does not build a tensor)."""
    return float(torch.tensor(v, dtype=dtype))


@functools.lru_cache(maxsize=32)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    """The wide K1 kernel's offsets as int32 on ``device``: uploaded once
    per (offsets, device) and kept, not copied on every call."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


# ---------------- K2: frequency sliding median ----------------


def sliding_median_boundary_plain(
    x: torch.Tensor, k: int, mode: str
) -> torch.Tensor:
    """Plain twin of ``sliding_median_boundary``."""
    if mode == "valid":
        return sliding_median(x, range(k), -1, "zero")[..., : x.shape[-1] - k + 1]
    m = (k - 1) // 2
    return sliding_median(x, range(-m, m + 1), -1, _PLAIN_BOUNDARY[mode])


def sliding_median_boundary(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """Sliding median of odd width ``k`` (up to MAX_FREQ_TAPS) along the
    last dim.

    mode 'reflect' | 'wrap' | 'edge' (jnp.pad semantics, on the unpadded
    row; reflect needs (k-1)/2 < F) keeps the width F; 'valid' reads an
    already padded row and returns F - k + 1 outputs. float32 or
    bfloat16, returned in the input's dtype.
    """
    if mode not in FREQ_MODES:
        raise ZenError(f"unknown boundary mode: {mode}")
    _check_k(k, MAX_FREQ_TAPS, "its 256 + K - 1 row segment fills 227 KB of shared memory")
    _check_dtype(x)
    f_in = x.shape[-1]
    f_out = f_in - k + 1 if mode == "valid" else f_in
    if f_out < 1 or (mode == "reflect" and (k - 1) // 2 > f_in - 1):
        raise ZenError(f"median width {k} does not fit {f_in} samples ({mode})")
    if not x.is_cuda:
        return sliding_median_boundary_plain(x, k, mode)
    _check_cuda_operands(x)
    out = torch.empty(x.shape[:-1] + (f_out,), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _launch(
        x,
        _entry(_build.library(), "zen_sliding_median_boundary", x.dtype),
        x.data_ptr(),
        out.data_ptr(),
        math.prod(x.shape[:-1]),
        f_in,
        f_out,
        k,
        FREQ_MODES[mode],
    )
    _build.check(err, "sliding_median_boundary")
    sliding_median_boundary.launches += 1
    return out


sliding_median_boundary.launches = 0
