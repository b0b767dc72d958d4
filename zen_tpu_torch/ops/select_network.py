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

# K1 takes its network for every odd K up to TIME_MAX_TAPS and its wide
# routes above; K2 takes its network up to FREQ_MAX_TAPS, below its rank
# route's crossover (ops/median_cuda.py, FREQ_RANK_MIN_TAPS).
TIME_MAX_TAPS = 63
FREQ_MAX_TAPS = 63
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


# ---------------- the shared core: K1's network for runs of outputs ----------------
#
# A thread of K1's register route takes one column and a run of R
# consecutive output rows. Where the tap set is a few runs of
# consecutive offsets, neighbouring outputs share most of their taps: a
# run of L offsets gives the R outputs L - R + 1 taps in common (its
# core part) and each output R - 1 of its own. With C core taps and m =
# K - C own taps an output, the median (rank h = (K - 1) / 2) of an
# output's taps is the rank-(h - lo) element of the core's sorted ranks
# lo = max(0, h - m) .. hi = min(C - 1, h) joined with its m own taps:
# every core element below rank lo lies at or below the median and every
# one above rank hi at or above it, and as many go from each side. So the
# core is sorted once for the R outputs, by Batcher's network pruned to
# the ranks lo .. hi, and each output sorts its own taps (the same,
# pruned to the ranks it reads) and picks its rank by the merge-select
# of two sorted lists: the k-th smallest of A and B is the least, over
# the splits i + j = k + 1, of max(A[i - 1], B[j - 1]). It is all min and
# max on registers, so each median is one of the inputs, bitwise the
# element the per-output network and the plain twin pick.

CORE_RUNS = (2, 3, 4, 6, 8)  # the outputs a thread may take (R)
CORE_MAX_TAP_RUNS = 2  # tap runs of a shape the kernel is built for
CORE_MAX_STAGED = 80  # taps' rows a thread holds in registers
CORE_KEEP = 2  # R values built per shape: those with the fewest min/max an output
CORE_GAIN = 0.6  # and only where that is at most this share of median<K>'s
CORE_PARTS = 4  # sources the shapes are compiled in, at once (csrc/median_time_core_p*.cu)
FREQ_CORE_PARTS = 4  # the same for K2's shapes (csrc/median_freq_core_p*.cu)


def tap_runs(offsets) -> tuple:
    """The tap multiset as runs of consecutive offsets: ((first, length),
    ...), ascending by first offset; a repeated offset starts a run of its
    own (the replicate border's six 0s: one run ending at 0 and five of
    length 1)."""
    runs = []
    for o in sorted(offsets):
        for q, (first, n) in enumerate(runs):
            if first + n == o:
                runs[q] = (first, n + 1)
                break
        else:
            runs.append((o, 1))
    return tuple(runs)


@functools.lru_cache(maxsize=None)
def _sorting_pairs(n: int) -> tuple:
    """Batcher's odd-even merge sort on n wires (comparators on wires >= n
    dropped, as in median_schedule)."""
    return tuple((i, j) for i, j in _odd_even_merge_sort(1 << max(0, n - 1).bit_length())
                 if j < n)


@functools.lru_cache(maxsize=None)
def core_program(lengths: tuple, r: int):
    """The shared-core schedule for tap runs of ``lengths`` and runs of
    ``r`` outputs, or None where the outputs share no tap: (staged,
    ops, outs, core) with ``staged`` the (tap run, position) of each
    register a thread loads (run j's rows first_j + p for p in [0, L_j +
    r - 1), relative to the run of outputs' first row), ``ops`` the
    min/max (dst, 'min' | 'max', a, b) over values numbered from
    len(staged) (0 .. len(staged) - 1 are the loads), in order, every one
    some output needs, ``outs`` the value that is each output's median
    and ``core`` the number of shared taps."""
    k, h = sum(lengths), (sum(lengths) - 1) // 2
    staged, core, own = [], [], [[] for _ in range(r)]
    for j, n in enumerate(lengths):
        for p in range(n + r - 1):
            s = len(staged)
            staged.append((j, p))
            if r - 1 <= p < n:
                core.append(s)
            for i in range(r):
                if i <= p < i + n and not r - 1 <= p < n:
                    own[i].append(s)
    if not core:
        return None
    ops = []

    def emit(op, a, b):
        ops.append((len(staged) + len(ops), op, a, b))
        return ops[-1][0]

    def sort(wires):
        wires = list(wires)
        for i, j in _sorting_pairs(len(wires)):
            wires[i], wires[j] = emit("min", wires[i], wires[j]), emit("max", wires[i], wires[j])
        return wires

    m = k - len(core)
    ranks = sort(core)
    lo, hi = max(0, h - m), min(len(core) - 1, h)
    window, rank = ranks[lo : hi + 1], h - lo
    outs = []
    for i in range(r):
        mine = sort(own[i])
        terms = []
        for a in range(max(0, rank + 1 - m), min(len(window), rank + 1) + 1):
            b = rank + 1 - a
            terms.append(window[a - 1] if b == 0 else mine[b - 1] if a == 0
                         else emit("max", window[a - 1], mine[b - 1]))
        best = terms[0]
        for t in terms[1:]:
            best = emit("min", best, t)
        outs.append(best)
    needed, kept = set(outs), []
    for op in reversed(ops):
        if op[0] in needed:
            kept.append(op)
            needed.update(op[2:])
    # number the kept values densely, in order
    name = {s: s for s in range(len(staged))}
    for q, (dst, op, a, b) in enumerate(reversed(kept)):
        name[dst] = len(staged) + q
    program = tuple((name[d], op, name[a], name[b]) for d, op, a, b in reversed(kept))
    return tuple(staged), program, tuple(name[o] for o in outs), len(core)


def core_minmax_per_output(lengths: tuple, r: int) -> float:
    """fminf/fmaxf an output of the shared core (``core_program``)."""
    return len(core_program(lengths, r)[1]) / r


@functools.lru_cache(maxsize=None)
def core_shapes() -> tuple:
    """Every (lengths, R) the kernel is built for, in the order of its
    shape ids: one tap run of each odd length 3..TIME_MAX_TAPS (centered
    and valid tap sets, median2d's time filter) and the causal wrap's two
    runs (fm, fm + 1) for K = 2 fm + 1 up to TIME_MAX_TAPS (hop 256's
    (-21..-17) and (-5..0)); for each, the CORE_KEEP values of R in
    CORE_RUNS with the fewest min/max an output, where that is at most
    CORE_GAIN of median<K>'s and the staged rows fit CORE_MAX_STAGED."""
    shapes = []
    for lengths in ([(n,) for n in range(3, TIME_MAX_TAPS + 1, 2)]
                    + [(fm, fm + 1) for fm in range(2, (TIME_MAX_TAPS - 1) // 2 + 1)]):
        k = sum(lengths)
        fits = [r for r in CORE_RUNS
                if core_program(lengths, r) is not None
                and len(core_program(lengths, r)[0]) <= CORE_MAX_STAGED
                and core_minmax_per_output(lengths, r) <= CORE_GAIN * minmax_count(k)]
        fits.sort(key=lambda r: core_minmax_per_output(lengths, r))
        shapes += [(lengths, r) for r in sorted(fits[:CORE_KEEP])]
    return tuple(shapes)


def core_shape_id(lengths: tuple, r: int) -> int | None:
    """The kernel's id of (lengths, r), or None where it is not built."""
    try:
        return core_shapes().index((tuple(lengths), r))
    except ValueError:
        return None


def core_medians_plain(staged: torch.Tensor, lengths: tuple, r: int) -> torch.Tensor:
    """The shared core's schedule in PyTorch: ``staged`` [len(staged),
    ...], the registers a thread loads (``core_program``), to the medians
    [r, ...] of its r outputs, with torch.minimum / torch.maximum."""
    loads, program, outs, _ = core_program(tuple(lengths), r)
    values = list(staged.unbind(0))
    assert len(values) == len(loads)
    for _, op, a, b in program:
        values.append((torch.minimum if op == "min" else torch.maximum)(values[a], values[b]))
    return torch.stack([values[o] for o in outs])


def _emit_core_shape(shape_id: int, lengths: tuple, r: int) -> str:
    """``zen_core::Shape<shape_id>``: its constants, ``stage`` (each
    register's load, by tap run and position) and ``medians`` (the
    program, straight-line, every intermediate a named register)."""
    loads, program, outs, core = core_program(lengths, r)
    s = len(loads)

    def name(v):
        return f"v[{v}]" if v < s else f"t{v}"

    lines = [f"// tap runs {lengths}, {r} outputs: {core} shared taps, {len(program)} min/max",
             "template <>", f"struct Shape<{shape_id}> {{",
             f"  static constexpr int kK = {sum(lengths)}, kR = {r}, kStaged = {s}, "
             f"kTapRuns = {len(lengths)};",
             "  template <typename Load>",
             f"  __device__ __forceinline__ static void stage(float (&v)[{s}], Load load) {{"]
    lines += [f"    v[{q}] = load({j}, {p});" for q, (j, p) in enumerate(loads)]
    lines += ["  }",
              f"  __device__ __forceinline__ static void medians(const float (&v)[{s}], "
              f"float (&m)[{r}]) {{"]
    lines += [f"    const float t{d} = {'fminf' if op == 'min' else 'fmaxf'}({name(a)}, {name(b)});"
              for d, op, a, b in program]
    lines += [f"    m[{i}] = {name(o)};" for i, o in enumerate(outs)]
    lines += ["  }", "};"]
    return "\n".join(lines)


def core_part(shape_id: int) -> int:
    """Which of the CORE_PARTS sources compiles shape ``shape_id``."""
    return shape_id % CORE_PARTS


@functools.lru_cache(maxsize=None)
def freq_core_shape_ids() -> tuple:
    """The ids of the shapes K2's shared core is built for: one tap run of
    K up to FREQ_MAX_TAPS (K2's window is one run of K samples)."""
    return tuple(q for q, (lengths, _) in enumerate(core_shapes())
                 if len(lengths) == 1 and lengths[0] <= FREQ_MAX_TAPS)


def freq_core_part(shape_id: int) -> int:
    """Which of the FREQ_CORE_PARTS sources compiles K2's shape
    ``shape_id``: its place among ``freq_core_shape_ids``, round robin."""
    return freq_core_shape_ids().index(shape_id) % FREQ_CORE_PARTS


def emit_core_header() -> str:
    """The text of ``zen_core.cuh``: ``zen_core::Shape<id>`` for every
    (lengths, R) of ``core_shapes``, in id order; ZEN_CORE_PARTS,
    ZEN_CORE_FOR_EACH_SHAPE_OF_PART_<q>(X), which expands X(id) for each
    shape part q of K1's core compiles (``core_part``), for that part's
    switch, and ZEN_CORE_FOR_EACH_FREQ_SHAPE(X), which expands X(id) for
    each shape K2's core takes (``freq_core_shape_ids``), with
    ZEN_CORE_FREQ_PARTS and ZEN_CORE_FOR_EACH_FREQ_SHAPE_OF_PART_<q>(X),
    the shapes part q of K2's core compiles (``freq_core_part``)."""
    shapes = core_shapes()
    freq_ids = freq_core_shape_ids()
    parts = [
        "// Generated by zen_tpu_torch/ops/select_network.py (emit_core_header); not edited by hand.",
        "// zen_core::Shape<ID>: the shared-core network for one tap-run shape and a run of",
        "// kR outputs (core_program): stage(v, load) loads the kStaged registers a thread",
        "// holds, load(j, p) the row (K1) or sample (K2) first_j + p of tap run j; medians(v,",
        "// m) writes the kR outputs' medians, straight-line min/max, each one of the inputs.",
        "#pragma once",
        "",
        f"#define ZEN_CORE_MAX_TAP_RUNS {CORE_MAX_TAP_RUNS}",
        f"#define ZEN_CORE_PARTS {CORE_PARTS}",
        *(f"#define ZEN_CORE_FOR_EACH_SHAPE_OF_PART_{part}(X) "
          + " ".join(f"X({q})" for q in range(len(shapes)) if core_part(q) == part)
          for part in range(CORE_PARTS)),
        "#define ZEN_CORE_FOR_EACH_FREQ_SHAPE(X) " + " ".join(f"X({q})" for q in freq_ids),
        f"#define ZEN_CORE_FREQ_PARTS {FREQ_CORE_PARTS}",
        *(f"#define ZEN_CORE_FOR_EACH_FREQ_SHAPE_OF_PART_{part}(X) "
          + " ".join(f"X({q})" for q in freq_ids if freq_core_part(q) == part)
          for part in range(FREQ_CORE_PARTS)),
        "",
        "namespace zen_core {",
        "",
        "template <int ID>",
        "struct Shape;",
        "",
    ]
    parts += [_emit_core_shape(q, lengths, r) + "\n" for q, (lengths, r) in enumerate(shapes)]
    parts += ["}  // namespace zen_core", ""]
    return "\n".join(parts)
