"""Box (moving-average) filter over static tap offsets, on PyTorch.

Counterpart of ``zen_tpu/ops/box.py``, used only by the SSE variant
(hps.cu:582-652): the mean over the same decoded tap patterns as the
median, along one dimension, under one boundary rule ('zero' reads
``fill``, 'wrap', 'clamp' or 'replicate', 'reflect').

The additions are zen_tpu's, in zen_tpu's order: each contiguous run
of offsets is summed by a pow2 doubling tree over a once-padded slab
(S_2k[i] = S_k[i] + S_k[i+k], then one add per set bit of the run's
length, highest bit first), runs shorter than 4 tap by tap, then the
duplicated offsets, then one true division by K. So the port matches
zen_tpu to the bit on the CPU, and the card matches the CPU.

Not a cumsum difference, on purpose (zen_tpu/ops/box.py:96-106): the
SSE feature is 1/|S|^2 with a +inf prefill, and a running sum that
holds inf gives inf - inf = NaN in every later window. The tree only
adds in-window values: a window that holds inf sums to inf.

Taps and pads are slices and ``torch.cat`` of the input: no index
tensor is built, so nothing is copied from the host and the call never
waits on the card.
"""
from __future__ import annotations

import torch

from ..errors import ZenError
from .median import FREQUENCY, REPLICATE, WRAP


def _const(x: torch.Tensor, n: int, dim: int, fill: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return torch.full(shape, fill, dtype=x.dtype, device=x.device)


def _edge(x: torch.Tensor, n: int, dim: int, first: bool) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    i = 0 if first else x.shape[dim] - 1
    return x.narrow(dim, i, 1).expand(shape)


def _tap(x: torch.Tensor, off: int, dim: int, boundary: str, fill: float) -> torch.Tensor:
    """One shifted view: tap[i] = x[i + off] under the boundary rule
    (zen_tpu/ops/median.py:97-122)."""
    n = x.shape[dim]
    if off == 0:
        return x
    if boundary == WRAP:
        return torch.roll(x, -off, dims=dim)
    if boundary in (REPLICATE, "clamp"):
        if abs(off) >= n:
            return _edge(x, n, dim, off < 0)
        if off > 0:
            return torch.cat([x.narrow(dim, off, n - off), _edge(x, off, dim, False)], dim)
        return torch.cat([_edge(x, -off, dim, True), x.narrow(dim, 0, n + off)], dim)
    if boundary == "reflect":
        if abs(off) > n - 1:
            raise ZenError("reflect boundary reaches past the row")
        if off > 0:  # x[i + off] past the end reads x[2(n-1) - i - off]
            return torch.cat([x.narrow(dim, off, n - off),
                              x.narrow(dim, n - 1 - off, off).flip(dim)], dim)
        return torch.cat([x.narrow(dim, 1, -off).flip(dim), x.narrow(dim, 0, n + off)], dim)
    # constant fill: the feature of a zero prefill frame
    if abs(off) >= n:
        return _const(x, n, dim, fill)
    if off > 0:
        return torch.cat([x.narrow(dim, off, n - off), _const(x, off, dim, fill)], dim)
    return torch.cat([_const(x, -off, dim, fill), x.narrow(dim, 0, n + off)], dim)


def _divide(acc: torch.Tensor, k: int) -> torch.Tensor:
    """acc / float32(k) as a true division. A Python or CPU scalar
    divisor of a CUDA tensor is applied as a multiplication by its
    reciprocal, which can differ by an ulp; a divisor on the tensor's
    own device is divided by."""
    return acc / torch.full((), float(k), dtype=acc.dtype, device=acc.device)


def _taps_sum(x, offsets, dim, boundary, fill):
    acc = None
    for off in offsets:
        tap = _tap(x, off, dim, boundary, fill)
        acc = tap if acc is None else acc + tap
    return acc


def _taps_mean(x, offsets, dim, boundary, fill):
    """Direct per-tap sum over ``offsets`` in their order, then / K (the
    reference-order fallback, zen_tpu/ops/box.py:35-41)."""
    return _divide(_taps_sum(x, offsets, dim, boundary, fill), len(offsets))


def _pad(x, back: int, fwd: int, dim: int, boundary: str, fill: float) -> torch.Tensor:
    """One boundary pad with xp[i + back + off] == _tap(x, off)[i] for
    -back <= off <= fwd, both pads narrower than the row (jnp.pad's
    modes, zen_tpu/ops/box.py:44-55)."""
    n = x.shape[dim]
    if boundary == WRAP:
        lo, hi = x.narrow(dim, n - back, back), x.narrow(dim, 0, fwd)
    elif boundary in (REPLICATE, "clamp"):
        lo, hi = _edge(x, back, dim, True), _edge(x, fwd, dim, False)
    elif boundary == "reflect":
        lo = x.narrow(dim, 1, back).flip(dim)
        hi = x.narrow(dim, n - 1 - fwd, fwd).flip(dim)
    else:
        lo, hi = _const(x, back, dim, fill), _const(x, fwd, dim, fill)
    return torch.cat([lo, x, hi], dim)


def _window_sum(xp, base: int, length: int, out: int, dim: int) -> torch.Tensor:
    """r[i] = sum of xp[base + i .. base + i + length) along ``dim`` for
    i < out: pow2 doubling, then one add per set bit of ``length``,
    highest first (zen_tpu/ops/box.py:58-86)."""
    pows = {1: xp}
    k = 1
    while 2 * k <= length:
        s = pows[k]
        e = s.shape[dim] - k
        pows[2 * k] = s.narrow(dim, 0, e) + s.narrow(dim, k, e)
        k *= 2
    total, pos, bit, rem = None, base, k, length
    while bit >= 1:
        if rem >= bit:
            part = pows[bit].narrow(dim, pos, out)
            total = part if total is None else total + part
            pos += bit
            rem -= bit
        bit //= 2
    return total


def sliding_mean(
    x: torch.Tensor, offsets, dim: int, boundary: str, fill: float = 0.0
) -> torch.Tensor:
    """Mean over the static tap ``offsets`` along ``dim`` of ``x``
    (duplicates allowed), as zen_tpu/ops/box.py:89-143 computes it."""
    offsets = sorted(offsets)
    k = len(offsets)
    dim = dim % x.ndim
    n = x.shape[dim]
    back = max(0, -offsets[0])
    fwd = max(0, offsets[-1])
    if k < 4 or back >= n or fwd >= n:
        # tiny windows, or pads wider than the row (which would change
        # the wrap and reflect rules against the per-tap ones)
        return _taps_mean(x, offsets, dim, boundary, fill)
    runs, dups, prev = [], [], None  # runs: [start offset, length]
    for off in offsets:
        if off == prev:
            dups.append(off)
            continue
        if runs and off == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([off, 1])
        prev = off
    xp = _pad(x, back, fwd, dim, boundary, fill)
    acc = None
    for start, length in runs:
        if length >= 4:
            s = _window_sum(xp, back + start, length, n, dim)
        else:  # zen_tpu's short-run form: the run's mean times its length
            s = _taps_mean(x, range(start, start + length), dim, boundary, fill) * length
        acc = s if acc is None else acc + s
    for off in dups:
        acc = acc + _tap(x, off, dim, boundary, fill)
    return _divide(acc, k)


def box2d(x: torch.Tensor, filter_len: int, direction: str, border: str) -> torch.Tensor:
    """Full-matrix box filter on [..., T, F] along time or FREQUENCY:
    the centered window of the odd filter length (mfilt.h:89), periodic
    under border 'wrap' (the reference GPU) and edge-clamped under
    'replicate' (the reference CPU) (zen_tpu/ops/box.py:146-162)."""
    fl = filter_len + (1 - filter_len % 2)
    if border not in (WRAP, REPLICATE):
        raise ZenError(f"box filter has no '{border}' border mode")
    dim = -1 if direction == FREQUENCY else -2
    return sliding_mean(x, range(-(fl // 2), fl // 2 + 1), dim, border)
