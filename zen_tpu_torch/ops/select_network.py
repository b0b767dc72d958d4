"""Median selection as a comparator network, scheduled here and emitted
as CUDA.

Counterpart of ``_pruned_schedule`` and ``_median_network`` of
``zen_tpu/ops/median_pallas.py``: for an odd tap count K, a fixed list of
compare-exchanges (min to the lower wire, max to the upper) after which
wire (K - 1) / 2 holds ``sorted(taps)[(K - 1) / 2]``. The TPU version
prunes a bitonic sort over the next power of two and folds its +inf pad
wires; this one starts from Batcher's odd-even merge sort, a
standard-form network (every comparator sends its min to the lower
wire), where a +inf on the top wires never moves: dropping every
comparator that touches a wire >= K leaves a sorting network on K wires
with no pad wires at all. One backward pass then keeps only the
comparators, and of each only the outputs (min, max or both), that the
median wire depends on.

The small-K routes of both median kernels run the schedule on a register
array (``csrc/median_time.cu``, ``csrc/median_freq.cu``): ``emit_header``
writes ``zen_select::median<K>`` for every K the routes take, straight-
line ``fminf``/``fmaxf``, with one list of K per kernel (K1 takes the
network up to TIME_MAX_TAPS, K2 up to FREQ_MAX_TAPS), and
``ops/_build.py`` puts that header on the include path and into the
library's hash. ``select_median_plain`` runs
the same schedule in PyTorch, for the tests alone.

Exactness: min and max return one of their operands, so the network
selects one of its inputs, bitwise the element rank-by-counting picks;
only between -0.0 and +0.0 in one window could the sign bit differ (the
kernels take magnitudes, so neither that nor NaN arises). A bf16 tap
converts to float exactly and the selected float back to the same bits.
"""
from __future__ import annotations

import functools

import torch

# K1 takes its network for every odd K up to TIME_MAX_TAPS and its rank
# route above; K2 takes its network up to FREQ_MAX_TAPS, below its rank
# route's crossover (ops/median_cuda.py, FREQ_RANK_MIN_TAPS).
TIME_MAX_TAPS = 63
FREQ_MAX_TAPS = 31
MAX_TAPS = max(TIME_MAX_TAPS, FREQ_MAX_TAPS)  # the widest network emitted


def _odd_even_merge_sort(n: int) -> list:
    """Batcher's odd-even merge sort on n (a power of two) wires, as
    comparators (i, j), i < j, min to wire i, in execution order."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _check_k(k: int) -> None:
    if k < 1 or k % 2 == 0:
        raise ValueError(f"a median network takes an odd K >= 1, got {k}")


@functools.lru_cache(maxsize=None)
def median_schedule(k: int) -> tuple:
    """The comparators (i, j), i < j < k, in order, after which wire
    (k - 1) // 2 of k taps holds their median."""
    _check_k(k)
    n = 1 << max(0, k - 1).bit_length()
    pairs = [(i, j) for i, j in _odd_even_merge_sort(n) if j < k]
    needed = {(k - 1) // 2}
    kept = []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.update((i, j))
    return tuple(reversed(kept))


@functools.lru_cache(maxsize=None)
def median_ops(k: int) -> tuple:
    """The schedule as the min/max operations the median depends on:
    (op, i, j) with op 'min' (wire i takes min), 'max' (wire j takes max)
    or 'both', in order. A comparator whose other output no later
    comparator reads is half a comparator."""
    live = {(k - 1) // 2}
    ops = []
    for i, j in reversed(median_schedule(k)):
        op = "both" if i in live and j in live else "min" if i in live else "max"
        ops.append((op, i, j))
        live.update((i, j))
    return tuple(reversed(ops))


def minmax_count(k: int) -> int:
    """fminf/fmaxf calls of ``median<k>``."""
    return sum(2 if op == "both" else 1 for op, _, _ in median_ops(k))


def select_median_plain(taps: torch.Tensor) -> torch.Tensor:
    """The median over dim 0 of ``taps`` [K, ...] by the schedule, with
    torch.minimum / torch.maximum: the network's own plain version."""
    wires = list(taps.unbind(0))
    for i, j in median_schedule(len(wires)):
        wires[i], wires[j] = torch.minimum(wires[i], wires[j]), torch.maximum(wires[i], wires[j])
    return wires[(len(wires) - 1) // 2]


def _emit_median(k: int) -> str:
    """``zen_select::median<k>``: every intermediate a named register,
    written once."""
    names = [f"v[{q}]" for q in range(k)]
    lines = ["template <>",
             f"__device__ __forceinline__ float median<{k}>(const float (&v)[{k}]) {{"]
    for n, (op, i, j) in enumerate(median_ops(k)):
        a, b = names[i], names[j]
        if op in ("min", "both"):
            lines.append(f"  const float l{n} = fminf({a}, {b});")
            names[i] = f"l{n}"
        if op in ("max", "both"):
            lines.append(f"  const float h{n} = fmaxf({a}, {b});")
            names[j] = f"h{n}"
    lines += [f"  return {names[(k - 1) // 2]};", "}"]
    return "\n".join(lines)


def _odd_ks(limit: int) -> tuple:
    return tuple(range(1, limit + 1, 2))


def emit_header() -> str:
    """The text of ``zen_select.cuh``: ``zen_select::median<K>`` for every
    odd K up to MAX_TAPS; each kernel's cap, ZEN_SELECT_TIME_MAX_TAPS and
    ZEN_SELECT_FREQ_MAX_TAPS; and ZEN_SELECT_FOR_EACH_TIME_K(X) /
    ZEN_SELECT_FOR_EACH_FREQ_K(X), which expand X(K) for each K of that
    kernel, for its launcher's switch over K."""
    parts = [
        "// Generated by zen_tpu_torch/ops/select_network.py (emit_header); not edited by hand.",
        "// zen_select::median<K>(v): sorted(v)[(K - 1) / 2] of K floats by a pruned",
        "// odd-even merge sorting network, straight-line min/max on registers. The",
        "// result is one of the inputs, bitwise the element rank-by-counting picks",
        "// (-0.0 against +0.0 aside; NaN does not arise: the kernels take magnitudes).",
        "#pragma once",
        "",
        f"#define ZEN_SELECT_TIME_MAX_TAPS {TIME_MAX_TAPS}",
        f"#define ZEN_SELECT_FREQ_MAX_TAPS {FREQ_MAX_TAPS}",
        "#define ZEN_SELECT_FOR_EACH_TIME_K(X) "
        + " ".join(f"X({k})" for k in _odd_ks(TIME_MAX_TAPS)),
        "#define ZEN_SELECT_FOR_EACH_FREQ_K(X) "
        + " ".join(f"X({k})" for k in _odd_ks(FREQ_MAX_TAPS)),
        "",
        "namespace zen_select {",
        "",
        "template <int K>",
        "__device__ __forceinline__ float median(const float (&v)[K]);",
        "",
    ]
    parts += [_emit_median(k) + "\n" for k in _odd_ks(MAX_TAPS)]
    parts += ["}  // namespace zen_select", ""]
    return "\n".join(parts)
