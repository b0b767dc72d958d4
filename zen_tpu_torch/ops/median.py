"""Median filters over spectrogram matrices: static tap offsets along
one dimension, and the reference's whole-matrix filter.

Counterpart of ``zen_tpu/ops/median.py``: ``out[i] = median over taps
x[bnd(i + o)]`` for each offset ``o``, along one dimension, under one
boundary rule. ``sliding_median`` is the port's ``median_impl='torch'``
reference and the body of every CUDA kernel's plain twin
(ops/median_cuda.py). Taps are gathered with an index tensor and ranked
with ``torch.kthvalue``, an exact selection: for odd K it returns the
same element ``jnp.median`` does, so the two packages agree bitwise. The
gather runs over chunks of output positions of at most GATHER_TAPS taps,
so a wide K (2^20 taps and more) takes memory for a chunk, not for the
whole row; each output's selection is the same either way.

``median2d`` is the reference's MedianFilter{GPU,CPU}::filter
(mfilt.h:227-267, 336-341) on a [..., T, F] matrix, time rows and
frequency columns. Its geometry (fl = filter_len made odd, mfilt.h:89;
fm = fl // 2):

==================  ==========  ======================================
direction           border      out[i] = median over
==================  ==========  ======================================
time_causal         wrap        rows i-fm..i+fm, periodic in T
time_causal         valid       rows i-fl..i-1, only i >= fl
time_causal         replicate   rows i-fm..i+fm, edge-clamped
time_anticausal     wrap        rows i-fm..i+fm, periodic
time_anticausal     valid       rows i-fm..i+fm, only fm <= i <= T-fm-2
time_anticausal     replicate   rows i-fm..i+fm, edge-clamped
frequency           wrap        cols j-fm..j+fm, periodic in F
frequency           valid       cols j..j+fl-1, only j <= F-fl-1
frequency           replicate   cols j-fm..j+fm, edge-clamped
==================  ==========  ======================================

Outputs 'valid' leaves unwritten are zeros (the reference's dst buffers
are zero-initialized). ``median2d`` runs on the two median kernels
(K1 for the time directions, K2 for frequency) through their wrappers,
which take a CPU tensor to their plain twins; ``median2d_plain`` is the
CPU twin built on ``sliding_median`` alone.
"""
from __future__ import annotations

import math

import torch

from ..errors import ZenError

TIME_CAUSAL = "time_causal"
TIME_ANTICAUSAL = "time_anticausal"
FREQUENCY = "frequency"
DIRECTIONS = (TIME_CAUSAL, TIME_ANTICAUSAL, FREQUENCY)

WRAP = "wrap"  # GPU copy_bord=True (default in reference drivers)
VALID = "valid"  # GPU nocopybord
REPLICATE = "replicate"  # CPU/IPP backend
BORDERS = (WRAP, VALID, REPLICATE)

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


def odd_filter_len(filter_len: int) -> int:
    """Force filter length odd, as the reference does (mfilt.h:89)."""
    return filter_len + (1 - filter_len % 2)


def validate_filter(filter_len: int, direction: str, t: int, f: int) -> None:
    """Degenerate-input check (mfilt.h:80-87): filter > dim raises."""
    dim = f if direction == FREQUENCY else t
    if filter_len > dim:
        raise ZenError("median filter bigger than matrix dimension")


def centered_offsets(filter_len: int) -> list:
    fl = odd_filter_len(filter_len)
    fm = fl // 2
    return list(range(-fm, fm + 1))


def tap_stack(x: torch.Tensor, offsets, dim: int, boundary: str,
              fill: float = 0.0) -> torch.Tensor:
    """The K shifted views of ``x`` along ``dim``, stacked on a new
    leading dim: [K, *x.shape], tap k reading x[bnd(i + offsets[k])]
    ('replicate' is 'clamp'; out-of-range taps under 'zero' read
    ``fill``)."""
    boundary = "clamp" if boundary == REPLICATE else boundary
    d = dim % x.ndim
    xm = x.movedim(d, -1)
    idx, valid = tap_index(xm.shape[-1], offsets, boundary, x.device)
    taps = xm[..., idx]  # [..., n, K]
    if valid is not None:
        taps = torch.where(valid, taps, fill)
    return taps.movedim(-1, 0).movedim(-1, d + 1)


def _check_filter2d(direction: str, border: str) -> None:
    # zen_tpu sends any border other than wrap and replicate down its
    # valid branch; the port refuses what it does not know
    if direction not in DIRECTIONS:
        raise ZenError(f"unknown median direction: {direction!r}")
    if border not in BORDERS:
        raise ZenError(f"unknown median border: {border!r}")


def _valid_geometry(direction: str, fl: int, n: int) -> tuple:
    """(offsets, first, count) of 'valid': the outputs the reference
    writes along the filtered dim of ``n`` are first .. first + count - 1
    (count may be < 1: none), each the median of its offsets' taps."""
    fm = fl // 2
    if direction == TIME_CAUSAL:
        return range(-fl, 0), fl, n - fl  # strictly past, excludes current
    if direction == TIME_ANTICAUSAL:
        return centered_offsets(fl), fm, n - fl
    return range(0, fl), 0, n - fl  # frequency: a forward window


def median2d_plain(x: torch.Tensor, filter_len: int, direction: str,
                   border: str) -> torch.Tensor:
    """Plain twin of ``median2d`` on a CPU tensor [..., T, F], from
    ``sliding_median`` alone (under 'valid' only the outputs written are
    computed). Raises on a CUDA tensor, as median_impl='torch' does."""
    _check_filter2d(direction, border)
    if x.is_cuda:
        raise ZenError("median2d_plain runs the plain reference on CPU tensors; "
                       "median2d takes CUDA tensors to the kernels")
    fl = odd_filter_len(filter_len)
    dim = -1 if direction == FREQUENCY else -2
    if border != VALID:
        boundary = "wrap" if border == WRAP else "clamp"
        return sliding_median(x, centered_offsets(fl), dim, boundary)
    offsets, first, count = _valid_geometry(direction, fl, x.shape[dim])
    out = torch.zeros_like(x)
    if count > 0:
        out.narrow(dim, first, count).copy_(
            sliding_median(x, offsets, dim, "zero", start=first, stop=first + count))
    return out


def median2d(x: torch.Tensor, filter_len: int, direction: str,
             border: str) -> torch.Tensor:
    """The reference's whole-matrix median filter on [..., T, F], float32
    or bfloat16 (the module docstring has its geometry), through the two
    median kernels' wrappers: a CUDA tensor launches K1 or K2 (and never
    a plain path), a CPU tensor runs their plain twins.

    frequency wrap / replicate: K2 with its 'wrap' / 'edge' border,
    applied as it loads the row. frequency valid: K2's 'valid' outputs
    but the last (NPP leaves the last full window unwritten too), padded
    with zero columns. time wrap / replicate: the rows -fm .. T+fm-1
    gathered under the border (periodic or clamped, so a filter longer
    than T goes round as often as it reaches), then K1 over them, every
    tap inside the gathered rows. time valid: K1 on x with fill 0, and
    the rows the reference leaves unwritten zeroed. Nothing is launched
    where 'valid' writes no output. An unknown direction or border
    raises (zen_tpu takes any border but wrap and replicate as valid).
    """
    from . import median_cuda as mc

    return median2d_over(x, filter_len, direction, border, mc.tap_median_time,
                         mc.sliding_median_boundary)


def median2d_over(x: torch.Tensor, filter_len: int, direction: str, border: str,
                  time_median, freq_median) -> torch.Tensor:
    """``median2d``'s mapping over ``time_median`` (called as
    ``tap_median_time``) and ``freq_median`` (as
    ``sliding_median_boundary``): ``median2d`` passes the kernels'
    wrappers; chip_smoke.py passes their plain twins, which also run on
    the card, to hold the kernels bitwise on median2d's own operands."""
    _check_filter2d(direction, border)
    x = x.contiguous()
    fl = odd_filter_len(filter_len)
    fm = fl // 2
    dim = -1 if direction == FREQUENCY else -2
    n = x.shape[dim]
    if direction == FREQUENCY:
        if border != VALID:
            return freq_median(x, fl, "wrap" if border == WRAP else "edge")
        if n - fl < 1:
            return torch.zeros_like(x)
        return torch.nn.functional.pad(freq_median(x, fl, VALID)[..., : n - fl], (0, fl))
    if border != VALID:
        rows = torch.arange(-fm, n + fm, device=x.device)
        rows = torch.remainder(rows, n) if border == WRAP else rows.clamp(0, n - 1)
        v = x.index_select(-2, rows)
        return time_median(v, v[..., :0, :], tuple(range(-2 * fm, 1)), 2 * fm)
    offsets, first, count = _valid_geometry(direction, fl, n)
    if count < 1:
        return torch.zeros_like(x)
    out = time_median(x, x[..., :0, :], tuple(offsets), 0)
    out[..., :first, :] = 0
    out[..., first + count :, :] = 0
    return out
