"""Plain PyTorch median filter over static tap offsets.

Counterpart of ``zen_tpu/ops/median.py``: ``out[i] = median over taps
x[bnd(i + o)]`` for each offset ``o``, along one dimension, under one
boundary rule. This is the port's ``median_impl='torch'`` reference and
the body of every CUDA kernel's plain twin (ops/median_cuda.py). Taps
are gathered with an index tensor and ranked with ``torch.kthvalue``,
an exact selection: for odd K it returns the same element
``jnp.median`` does, so the two packages agree bitwise. The gather runs
over chunks of output positions of at most GATHER_TAPS taps, so a wide
K (2^20 taps and more) takes memory for a chunk, not for the whole row;
each output's selection is the same either way.
"""
from __future__ import annotations

import math

import torch

from ..errors import ZenError

BOUNDARIES = ("zero", "wrap", "clamp", "reflect")
GATHER_TAPS = 1 << 24  # most taps sliding_median gathers at once (64 MB of float32)


def tap_index(n: int, offsets, boundary: str, device, start: int = 0,
              stop: int | None = None) -> tuple:
    """(idx [stop - start, K], valid [stop - start, K] or None): source
    positions of every tap of output positions start .. stop - 1 (default
    all n) under ``boundary``; ``offsets`` a sequence or an int64 tensor.

    'zero' marks out-of-range taps invalid (they read ``fill``);
    'wrap' is periodic; 'clamp' repeats the edge sample; 'reflect' is
    even symmetry that excludes the edge sample, jnp.pad's 'reflect'
    (zen_tpu/ops/median.py:110-116), for reaches below n.
    """
    if boundary not in BOUNDARIES:
        raise ZenError(f"unknown boundary: {boundary}")
    off = torch.as_tensor(offsets, dtype=torch.int64, device=device)
    if boundary == "reflect" and off.numel() and int(off.abs().max()) > n - 1:
        raise ZenError("reflect boundary reaches past the row")
    stop = n if stop is None else stop
    idx = torch.arange(start, stop, device=device)[:, None] + off[None, :]
    if boundary == "wrap":
        return torch.remainder(idx, n), None
    if boundary == "clamp":
        return idx.clamp(0, n - 1), None
    if boundary == "reflect":
        idx = idx.abs()
        return torch.minimum(idx, 2 * (n - 1) - idx), None
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), valid


def sliding_median(
    x: torch.Tensor, offsets, dim: int, boundary: str, fill: float = 0.0,
    start: int = 0, stop: int | None = None,
) -> torch.Tensor:
    """Median over the static tap ``offsets`` along ``dim`` of ``x``, at
    output positions start .. stop - 1 of ``dim`` (default all).

    ``offsets`` must have odd length (duplicates allowed); out-of-range
    taps under the 'zero' boundary read ``fill``.
    """
    offsets = list(offsets)
    k = len(offsets)
    if k % 2 == 0:
        raise ZenError(f"median needs an odd tap count, got {k}")
    xm = x.movedim(dim, -1)
    n = xm.shape[-1]
    stop = n if stop is None else stop
    off = torch.as_tensor(offsets, dtype=torch.int64, device=x.device)
    step = max(1, GATHER_TAPS // max(1, k * math.prod(xm.shape[:-1])))
    outs = []
    for lo in range(start, stop, step):
        idx, valid = tap_index(n, off, boundary, x.device, lo, min(stop, lo + step))
        taps = xm[..., idx]  # [..., positions, K]
        if valid is not None:
            taps = torch.where(valid, taps, fill)
        outs.append(taps.kthvalue(k // 2 + 1, dim=-1).values)
    out = torch.cat(outs, dim=-1) if outs else xm[..., :0]
    return out.movedim(-1, dim)
