"""Plain PyTorch median filter over static tap offsets.

Counterpart of ``zen_tpu/ops/median.py``: ``out[i] = median over taps
x[bnd(i + o)]`` for each offset ``o``, along one dimension, under one
boundary rule. This is the port's ``median_impl='torch'`` reference and
the body of every CUDA kernel's plain twin (ops/median_cuda.py). Taps
are gathered with one index tensor and ranked with ``torch.kthvalue``,
an exact selection: for odd K it returns the same element
``jnp.median`` does, so the two packages agree bitwise.
"""
from __future__ import annotations

import torch

from ..errors import ZenError

BOUNDARIES = ("zero", "wrap", "clamp", "reflect")


def tap_index(n: int, offsets, boundary: str, device) -> tuple:
    """(idx [n, K], valid [n, K] or None): source positions of every
    tap of every output position under ``boundary``.

    'zero' marks out-of-range taps invalid (they read ``fill``);
    'wrap' is periodic; 'clamp' repeats the edge sample; 'reflect' is
    even symmetry that excludes the edge sample, jnp.pad's 'reflect'
    (zen_tpu/ops/median.py:110-116), for reaches below n.
    """
    if boundary not in BOUNDARIES:
        raise ZenError(f"unknown boundary: {boundary}")
    offsets = list(offsets)
    if boundary == "reflect" and max(map(abs, offsets), default=0) > n - 1:
        raise ZenError("reflect boundary reaches past the row")
    off = torch.as_tensor(offsets, dtype=torch.int64, device=device)
    idx = torch.arange(n, device=device)[:, None] + off[None, :]
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
    x: torch.Tensor, offsets, dim: int, boundary: str, fill: float = 0.0
) -> torch.Tensor:
    """Median over the static tap ``offsets`` along ``dim`` of ``x``.

    ``offsets`` must have odd length (duplicates allowed); out-of-range
    taps under the 'zero' boundary read ``fill``.
    """
    offsets = list(offsets)
    k = len(offsets)
    if k % 2 == 0:
        raise ZenError(f"median needs an odd tap count, got {k}")
    xm = x.movedim(dim, -1)
    idx, valid = tap_index(xm.shape[-1], offsets, boundary, x.device)
    taps = xm[..., idx]  # [..., n, K]
    if valid is not None:
        taps = torch.where(valid, taps, fill)
    out = taps.kthvalue(k // 2 + 1, dim=-1).values
    return out.movedim(-1, dim)
