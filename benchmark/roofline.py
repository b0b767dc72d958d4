"""The least time a median call could take on one H100, from its geometry.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``time_bound`` and
``freq_bound``, taking shapes where those take tensors: each input
element that some tap reaches is read once and each output written once
at the device memory's rate, or ceil(log2 K) compares an output at the
float32 rate outside the tensor cores, whichever is longer (what a
sliding median needs, its window kept sorted from one output to the
next). Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(in_elems: int, out_elems: int, itemsize: int, k: int) -> tuple:
    """(µs, 'bytes' | 'operations')."""
    t_bytes = (in_elems + out_elems) * itemsize / HBM_BYTES_PER_S * 1e6
    t_ops = out_elems * math.ceil(math.log2(k)) / F32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_bound(a_shape, b_shape, offsets, start: int, itemsize: int) -> tuple:
    """bound() of the time median over V = a ++ b along the rows (dim -2),
    outputs start .. rows of V: the distinct rows of V that some output
    row's taps reach, the union over o of [start + o, start + o + t_out)
    within V (rows between two tap runs are read by no tap)."""
    ta, tb = a_shape[-2], b_shape[-2]
    t_v = ta + tb
    t_out = t_v - start
    reach = end = 0
    for o in sorted(set(offsets)):
        lo, hi = max(0, start + o), min(t_v, start + o + t_out)
        reach += max(0, hi - max(lo, end))
        end = max(end, hi)
    lead_f = math.prod(a_shape) // max(ta, 1) if ta else math.prod(b_shape) // tb
    return bound(lead_f * reach, lead_f * t_out, itemsize, len(offsets))


def freq_bound(x_shape, k: int, mode: str, itemsize: int) -> tuple:
    """bound() of the frequency median along the last dim of x."""
    f_out = x_shape[-1] - k + 1 if mode == "valid" else x_shape[-1]
    outs = math.prod(x_shape) // x_shape[-1] * f_out
    return bound(math.prod(x_shape), outs, itemsize, k)
