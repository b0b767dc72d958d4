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
through the kernel, ``routes`` splits that count by route (K1's
``register``, ``rank``, ``select`` and ``warp``; K2's ``network``,
``rank`` and ``select``), ``steps``
counts the rank route's launches that took its steps kernel (a thread a
run of outputs; the others walk from rank 0 or, in K2, take the key
store), ``cores`` the launches that took a network's shared core (K1's
register route, K2's network route), and K2's ``stores`` splits its rank
route's launches by where the keys live.
Kernels launch on the current stream, never synchronize and allocate
nothing: the wrapper allocates the output and K2's key scratch.

Small K is a comparator network on registers (``ops/select_network.py``,
emitted as ``zen_select.cuh`` and ``zen_core.cuh`` at build time): K1's
``register`` route up to REGISTER_TAPS (63) taps and K2's ``network``
route up to FREQ_NETWORK_MAX_TAPS (63). K1's register route takes one of
two kernels a call (``time_network_form``): the per-output network, or,
where the tap set is one or two runs of consecutive offsets and the call
has more than one output row, the shared core (``csrc/
median_time_core.cu``: a thread sorts the taps its run of R outputs
share once, then merges each output's own taps in), counted apart in
``tap_median_time.cores``. K2's network route likewise
(``freq_network_form``): the per-output network, or, from
FREQ_CORE_MIN_TAPS taps on calls of FREQ_CORE_MIN_BLOCKS row chunks and
from FREQ_CORE_WIDE_TAPS on at any row count, its shared core (``csrc/
median_freq_core.cu``: a thread takes R consecutive outputs, whose
windows share K - R + 1 samples), counted apart in
``sliding_median_boundary.cores``. Large K takes one of the wide routes,
weighed on the call's geometry (``time_rank_pick``, ``freq_rank_pick``):
K1's ``warp`` (65 to 256 taps; a warp an output, its taps in the
lanes' registers, sorted by shuffles: the few-output calls, hop 32's K =
93), ``rank``, "rank once, select many" (``csrc/rank_select.cuh``: a block sorts its
staged samples once, and each output walks the ranks from rank 0 or, a
thread taking a run of outputs, steps from the previous output's rank),
where a block's outputs share the sort; ``select`` (``csrc/radix_select.cuh``: a radix
select an output, nothing sorted), where the outputs are too few to share
one, and for K1 wherever one row's keys pass shared memory. K1's routes
take every tap set past REGISTER_TAPS at any span (``time_route``), K2's
from FREQ_RANK_MIN_TAPS on (``freq_route``), up to MAX_TIME_TAPS and
MAX_FREQ_TAPS. The host side of the routes is here, in Python the CPU
tests reach: the rows a run of K1's network kernel stages and where each
tap lies in them (``time_network_plan``, ``time_network_run``;
``time_fill_run``, the run of the thread mapping alone), K1's rank plan
(the multiplicity table ``time_rank_table``, the staged rows
``time_rank_rows``, the run ``time_rank_run``, its keys' bytes
``time_rank_keys``, the call's plan ``time_rank_plan``, the change
points of the steps ``time_rank_changes`` and the geometry
``time_rank_geometry``: rows, lane run and adjacent columns a block),
the select route's geometry (``time_select_plan``, ``freq_select_plan``),
the cost rule among them (``time_rank_pick``, ``freq_rank_pick``,
pricing each rank geometry by ``sort_us`` and the warp route by
``warp_us``, its slots a lane ``time_warp_slots``), K2's rank geometry
(``freq_rank_plan``: tile and run, ``freq_rank_threads``; ``freq_rank_tile``, the
walk's own tile, which the copy mirror stages), where its sort's keys
live (``shared`` in its shared memory where they fit, else ``scratch``:
``freq_rank_store``) and the scratch's geometry (``rank_store_args``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from ..errors import ZenError
from . import _build
from .median import sliding_median
from .select_network import FREQ_MAX_TAPS as FREQ_NETWORK_MAX_TAPS
from .select_network import TIME_MAX_TAPS as REGISTER_TAPS
from .select_network import core_medians_plain, core_program, core_shape_id, core_shapes, tap_runs

# Shared memory a block can opt into on Hopper (227 KB).
SMEM_OPTIN = 232_448
KEY_BYTES = 8  # a (value, position) key of the rank routes
MERGE_RUN = 8  # keys a thread merges a pass in the steps' merge passes (kMergeRun)
# The rank steps' sort (csrc/rank_select.cuh, warp_merge_sort): each warp
# sorts a slice of up to WARP_SORT_KEYS keys in registers and shuffles
# (WARP_LANE_KEYS a lane), merge passes joining the slices past it; its K2
# kernel takes at most WARP_STEPS_THREADS threads.
WARP_LANE_KEYS = 8
WARP_SORT_KEYS = 32 * WARP_LANE_KEYS
WARP_STEPS_THREADS = 256
# K2's key store past shared memory (csrc/rank_select.cuh): a block whose
# keys do not fit SMEM_OPTIN sorts them in its slice of a device-memory
# scratch, RANK_STORE_CHUNK keys (128 KB) at a time in shared memory, so
# one block runs an SM; a persistent grid of at most one block an SM walks
# the units, so the scratch is one slice a block. A slice holds at most
# RANK_STORE_MAX_KEYS keys (16 MiB; the scratch at most 2.2 GB on an
# H100's 132 SMs). K2 stages RANK_STORE_THREADS + K - 1 samples for a
# unit of outputs, so the store takes K2 up to MAX_FREQ_TAPS. K1 has no
# store: past shared memory it takes the select route, which needs no
# scratch; MAX_TIME_TAPS keeps the bound the store gave it. Both limits
# hold on the card and on the CPU alike; both are past 2^20, and a key's
# 32-bit position holds any staged sample.
RANK_STORE_MAX_KEYS = 1 << 21
RANK_STORE_CHUNK = 16_384
RANK_STORE_THREADS = 1024  # threads of a store block, and K2's outputs a unit
MAX_TIME_TAPS = RANK_STORE_MAX_KEYS - 1
MAX_FREQ_TAPS = RANK_STORE_MAX_KEYS - RANK_STORE_THREADS + 1
# The select route (csrc/radix_select.cuh): a block keeps its samples'
# 4-byte order bits and its threads' own bins (SELECT_BINS words a
# thread) in shared memory beside zen_pick::Shared (16 bins and two
# words) where both fit, else the bits alone (the bins in registers), else
# the bins alone (the bits read through L2 on each of SELECT_PASSES
# passes: zen_pick::layout); it takes SELECT_MIN_THREADS to
# SELECT_MAX_THREADS threads (about SELECT_SAMPLES_A_THREAD staged samples
# a thread), and K2's block at most SELECT_MAX_TILE outputs (K1's at most
# TIME_RANK_RUN).
SELECT_PASSES = 8
SELECT_BINS = 16
SELECT_SHARED_BYTES = SMEM_OPTIN - 72
SELECT_MIN_THREADS = 64
SELECT_MAX_THREADS = 1024
SELECT_SAMPLES_A_THREAD = 16
SELECT_MAX_TILE = 256
# Where a select block's bins go: on an H100 (chip_smoke.py phase 3's
# select lines) shared memory was as fast or faster at 1024 threads on
# every row (30.94 against 35.18 µs at 192 kHz hop 1), registers at 64
# (1454.27 against 2215.36 at hop 1024's shape)
SELECT_SHARED_BINS_THREADS = 1024
# The cost rule between the sort and the select routes (time_rank_pick,
# freq_rank_pick): each route's µs for a call from its geometry alone,
# LAUNCH_US plus waves of blocks over the SMs (H100_SMS on the CPU, the
# device's count on the card) times a block's time. A select block:
# SELECT_STAGE_US a staged sample a thread, then for each of its outputs
# SELECT_PASSES passes of SELECT_PASS_US (plus SELECT_PASS_THREAD_US a
# thread: the bins' sums and the barrier) and SELECT_SAMPLE_US a staged
# sample a thread. A sort block: SORT_SWAP_US a compare-swap a thread (n/2
# log2 n (log2 n + 1)/2 over its n keys) where each output walks from rank
# 0; where the steps sort, SORT_WARP_US a key a lane holds a stage of a
# warp's slice and SORT_MERGE_US a key a merge pass a thread past a slice;
# SORT_WALK_US a rank of the walk (S/2 of S staged), SORT_STEP_US a
# step of each next output of a run and, with steps, SORT_STAGE_US a
# staged sample a thread, in shared memory; STORE_SWAP_US and
# STORE_WALK_US on K2's store. Blocks share an SM up to SM_BLOCKS and its
# threads and shared memory, and past SM_FULL_RATE_THREADS threads at once
# they share its issue. The select constants are fitted to chip_smoke.py
# phase 3's select lines on an H100 (PERF.md: the one-wave rows' times,
# where a block runs alone on its SM), the sort's to
# benches/rank_geometry.py's sweeps of every rank geometry of the paths'
# rows (least squares on the log times; SORT_WARP_US, SORT_STAGE_US and
# SM_FULL_RATE_THREADS refit to its 1,828 geometries on an H100 80GB HBM3
# at 700 W, so that the rule picks the fastest measured on the 4-minute
# track's pass 1, the clip's, pitch-track's K2, median2d's fl 93 and fl
# 187 and the streams' latency rows).
H100_SMS = 132
SM_SHARED_BYTES = 233_472  # an SM's shared memory; a block reserves 1 KB more
LAUNCH_US = 5.0
SELECT_STAGE_US = 0.1
SELECT_PASS_US = 0.7
SELECT_PASS_THREAD_US = 8e-4
SELECT_SAMPLE_US = 0.12
SORT_SWAP_US = 0.05
SORT_WALK_US = 0.036
SORT_STEP_US = 0.2
SORT_MERGE_US = 0.13
SORT_STAGE_US = 0.2
SORT_WARP_US = 0.004
SM_FULL_RATE_THREADS = 896
SM_BLOCKS = 32
STORE_SWAP_US = 0.19
STORE_WALK_US = 0.02
# K1's warp route (a warp an output, csrc/median_time.cu) takes up to 32 x
# WARP_SLOTS[-1] taps, from REGISTER_TAPS + 2 on, at WARP_SLOTS taps a
# lane: WARP_BASE_US for a warp's loads and its sort's chain of shuffles,
# then WARP_OUTPUT_US (one a slot count) an output an SM, the instructions
# its schedulers issue; fitted to benches/warp_rows.py's times on an H100
# 80GB HBM3 at 700 W (K = 93 from 65 outputs to 133,120: 6.46 to 106.06
# us; K = 187 and 255 at 2080 outputs, eight taps a lane: 10.37 and 10.35
# us, beside the rank route's 10.30 and 13.50)
WARP_SLOTS = (4, 8)
WARP_BASE_US = 1.5
WARP_OUTPUT_US = (0.10, 0.28)
# K1's network kernel (K <= REGISTER_TAPS): a thread takes one column and
# a run of TIME_NETWORK_RUN consecutive output rows, fewer while the
# launch would have under TIME_NETWORK_MIN_BLOCKS blocks (four for each
# of an H100's 132 SMs: a single stream's step is a few dozen blocks at
# runs of 8, and its time is then the run's length, not the card's rate)
# or while the rows the run's taps reach pass TIME_NETWORK_MAX_STAGED
# (they are indexed by a byte and staged in shared memory). A block takes
# TIME_NETWORK_THREADS columns. The kernel takes runs up to
# TIME_NETWORK_MAX_RUN where they fit.
TIME_NETWORK_RUN = 8
TIME_NETWORK_MAX_RUN = 16
TIME_NETWORK_MAX_STAGED = 256
TIME_NETWORK_THREADS = 128
TIME_NETWORK_MIN_BLOCKS = 4 * 132
# K1's shared core (time_network_form) takes the largest R whose grid has
# this many blocks, two an H100 SM: fitted on the card, where K = 63 on
# 64 hop-64 streams ran 14.45 us at R = 8 (512 blocks), 15.98 at R = 6
TIME_CORE_MIN_BLOCKS = 2 * H100_SMS
assert REGISTER_TAPS <= TIME_NETWORK_MAX_STAGED  # a run of one row always fits
assert TIME_NETWORK_MAX_STAGED * TIME_NETWORK_THREADS * 4 <= SMEM_OPTIN
# K1's rank route: most output rows per block where each walks from rank
# 0, one per lane of its first warp; its table pads each side with
# TIME_RANK_RUN - 1 zeros. With steps a block takes TIME_RANK_COLUMNS
# adjacent columns, and in each column up to TIME_RANK_WALKERS threads a
# lane run of consecutive output rows (RANK_LANE_RUNS).
TIME_RANK_RUN = 32
TIME_RANK_THREADS = 128  # threads of a rank block (kRankThreads)
TIME_RANK_WALKERS = (16, 32, 64, 128)
TIME_RANK_COLUMNS = (1, 2, 4, 8)  # adjacent columns a block with steps
RANK_LANE_RUNS = (1,) + tuple(range(3, 32, 2))  # odd: a run's inverse reads miss no bank
# K2 selects with its network below this many taps and sorts its segment
# once per block from here on: the crossover of chip_smoke.py's phase-3
# sweep on an H100 80GB HBM3 at 700 W (the network, in the form its rule
# picks, was faster at every K it takes, on each of the sweep's row
# shapes, so the rank route starts right above it).
FREQ_RANK_MIN_TAPS = FREQ_NETWORK_MAX_TAPS + 2
FREQ_RANK_TILES = (32, 64, 128, 256)  # outputs (and threads) a block where each walks from 0
FREQ_NETWORK_CHUNK = 1024  # most outputs of a block of K2's network route
# K2's shared core (freq_network_form) takes a call of this many row
# chunks (the network's blocks; its persistent grid takes them whatever
# R), two an H100 SM (TIME_CORE_MIN_BLOCKS's reasoning): a single stream's
# few rows (beat-track's 64) keep the per-output network
FREQ_CORE_MIN_BLOCKS = 2 * H100_SMS
# and from this K on: on an H100 (chip_smoke.py phase 3, [2048, 513]) the
# core lost to the network at K = 5 (8.14 against 7.82 us), tied at 7
# (8.21 against 8.24) and won from 9 on (8.59 against 9.52 up to 12.66
# against 26.34 at 31)
FREQ_CORE_MIN_TAPS = 7
# From this K on the core takes a call of any row count, at its smaller R:
# median<K> costs 364 min/max an output at K = 33 and 570 at 47, the core
# 70-155, so a few rows' blocks finish sooner on it too. On an H100 80GB
# HBM3 at 700 W (chip_smoke.py phase 3's sweep, K = 33..63 on [32, 2049], [1, 2049] and
# [2048, 513]) R = 6 ran fastest on 46 of the 48 rows (the hop-1024 step's
# K = 47: 6.46 us against 6.67 at R = 8 and 9.22 for the network; 17.22
# against 20.86 and 46.40 on 2048 rows), and cutting a few rows into more
# chunks, so that the grid filled the SMs, did not pay (7.09 us at R = 6 on
# 32 rows cut into 9 chunks a row)
FREQ_CORE_WIDE_TAPS = 33
FREQ_CORE_WARP = 32  # runs of R outputs a warp of K2's core takes a pass
FREQ_MODES = {"reflect": 0, "wrap": 1, "edge": 2, "valid": 3}
_PLAIN_BOUNDARY = {"reflect": "reflect", "wrap": "wrap", "edge": "clamp"}


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _key_count(staged: int) -> int:
    """rank_select.cuh's key_count: the keys a rank block sorts for
    ``staged`` samples, a power of two of at least one warp's 32."""
    return max(32, _pow2_at_least(staged))


def _merge_room(key_bytes: int) -> int:
    """rank_select.cuh's merge_room in bytes: a key's room of padding
    after every MERGE_RUN keys."""
    return key_bytes + key_bytes // MERGE_RUN


def _sort_rooms(n: int, threads: int) -> int:
    """The steps sort's buffers for ``n`` keys and ``threads`` threads
    (sort_spare): one, and a second past one warp's slice where a thread
    merges more than one run."""
    return 2 if n > WARP_SORT_KEYS and threads * MERGE_RUN < n else 1


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


# the pipelined cascade (drivers/pipeline.py) launches from two threads
_COUNT_LOCK = threading.Lock()


def _count(wrapper, route: str, store: str | None = None, steps: bool = False,
           core: bool = False) -> None:
    """One launch on ``wrapper``'s counters (``store``: where a rank
    route's keys live, counted in ``wrapper.stores``; ``steps``: the rank
    route took its steps kernel, counted in ``wrapper.steps``; ``core``:
    K1's register route or K2's network route took its shared core,
    counted in ``wrapper.cores``), under a lock: ``+= 1`` on an attribute is a
    read-modify-write that two threads can interleave."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.routes[route] += 1
        if store:
            wrapper.stores[store] += 1
        if steps:
            wrapper.steps += 1
        if core:
            wrapper.cores += 1


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rank_store_args(units: int, staged: int, device: torch.device) -> tuple:
    """(scratch, blocks, slice) of a rank kernel on the key store for
    ``units`` units of at most ``staged`` keys each: ``blocks``, one an SM
    at most and no more than the units, each with a slice of ``slice``
    keys (``_key_count(staged)``) of the int64 ``scratch`` it allocates on
    ``device``."""
    keys = _key_count(staged)
    blocks = max(1, min(units, _sm_count(device)))
    return torch.empty(blocks * keys, dtype=torch.int64, device=device), blocks, keys


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
    the 'zero'-boundary sliding median of its rows from ``start`` on, and
    only those (``fill`` rounds to the inputs' dtype, as in the kernel)."""
    v = torch.cat([a, b], dim=-2)
    return sliding_median(v, offsets, -2, "zero", fill, start=start)


@functools.lru_cache(maxsize=64)
def _int_offsets(offsets: tuple) -> tuple:
    """``offsets`` as Python ints, once per tuple: at 25,601 taps the
    conversion alone takes milliseconds of a step's host time."""
    return tuple(int(o) for o in offsets)


@functools.lru_cache(maxsize=64)
def time_rank_offsets(offsets: tuple, start: int, t_v: int) -> tuple:
    """``offsets`` as K1's rank route plans them for output rows start ..
    t_v - 1 of V's t_v rows: a tap before row 0 for every output row moves
    to -t_v, one past the last row for every output row to t_v - start.
    Both read ``fill`` wherever they land, so the medians are the same,
    and the span the plan covers stays within 2 t_v + 1 rows whatever the
    offsets' own span."""
    lo, hi = -t_v, t_v - start
    return tuple(min(max(o, lo), hi) for o in offsets)


@functools.lru_cache(maxsize=32)
def time_rank_table(offsets: tuple) -> tuple:
    """(min offset, span, table) of K1's rank route for ``offsets``: span =
    max - min + 1, and the table, span + 62 ints: the count of each offset
    min .. max between TIME_RANK_RUN - 1 zeros on either side (a lane
    reads table[row - lane + 31] without a bounds check)."""
    lo = min(offsets)
    span = max(offsets) - lo + 1
    pad = TIME_RANK_RUN - 1
    counts = np.bincount(np.asarray(offsets, np.int64) - lo, minlength=span)
    return lo, span, (0,) * pad + tuple(counts.tolist()) + (0,) * pad


@functools.lru_cache(maxsize=64)
def time_rank_rows(offsets: tuple, run: int) -> tuple:
    """The rows K1's rank route stages for ``run`` consecutive output
    rows (run <= TIME_RANK_RUN): those their taps reach, relative to the
    first row's min(offsets) tap. A run of 32 rows under the two tap runs
    of a causal wrap (K = 93) stages 155 rows, not the 215 between its
    extremes; one row stages exactly its distinct taps."""
    taps = _distinct_taps(offsets)
    return tuple(np.unique((taps[:, None] + np.arange(run)).ravel()).tolist())


@functools.lru_cache(maxsize=64)
def _distinct_taps(offsets: tuple) -> np.ndarray:
    """The distinct offsets relative to min(offsets), ascending."""
    taps = np.unique(np.asarray(offsets, np.int64))
    return taps - taps[0]


@functools.lru_cache(maxsize=64)
def time_rank_staged(offsets: tuple, run: int) -> int:
    """How many rows K1's rank and select routes stage for ``run`` output
    rows (``len(time_rank_rows(offsets, run))``, without building them):
    each distinct tap's ``run`` rows, less the overlap with the next
    tap's."""
    return run + int(np.minimum(np.diff(_distinct_taps(offsets)), run).sum())


def time_rank_keys(offsets: tuple, run: int) -> int:
    """Bytes of the keys a block of K1's rank route sorts over ``run``
    output rows, as launch_rank (csrc/median_time.cu) reckons them: the
    rows it stages (``time_rank_staged``), to ``_key_count``. launch_rank
    puts the table beside them where both fit the device's opt-in
    limit."""
    return KEY_BYTES * _key_count(time_rank_staged(offsets, run))


@functools.lru_cache(maxsize=32)
def time_rank_run(offsets: tuple) -> int:
    """Output rows a block of K1's rank route takes: TIME_RANK_RUN, halved
    while the keys of the rows the run stages do not fit SMEM_OPTIN. One
    row stages its distinct taps; where even those do not fit (past
    16,384 keys), the sort cannot take the call (``time_rank_plan``) and
    the select route does."""
    run = TIME_RANK_RUN
    while run > 1 and time_rank_keys(offsets, run) > SMEM_OPTIN:
        run //= 2
    return run


@functools.lru_cache(maxsize=64)
def time_network_plan(offsets: tuple, run: int) -> tuple:
    """(rows, slots) of K1's network kernel for ``run`` consecutive
    output rows: the rows their taps reach, ascending, relative to the
    run's first output row (a run of 8 under the hop-256 taps -21..-17,
    -5..0 reaches 25 rows, 3.1 loads an output in place of 11), and for
    tap q of the run's row i, at slots[i * K + q], its index in rows."""
    rows = tuple(sorted({o + i for o in set(offsets) for i in range(run)}))
    index = {r: s for s, r in enumerate(rows)}
    return rows, tuple(index[o + i] for i in range(run) for o in offsets)


def time_fill_run(t_out: int, streams: int, f: int) -> int:
    """Output rows a thread takes in K1's thread mapping
    (csrc/time_runs.cuh) on ``streams`` streams of ``t_out`` output rows
    by ``f`` columns: TIME_NETWORK_RUN (or all ``t_out``), halved while
    the grid has fewer than TIME_NETWORK_MIN_BLOCKS blocks. The copy
    mirror #9 (probe_cuda.rows_copy) runs at this; K1's network kernel at
    ``time_network_run``."""
    tiles = streams * -(-f // TIME_NETWORK_THREADS)
    run = max(1, min(TIME_NETWORK_RUN, t_out))
    while run > 1 and tiles * -(-t_out // run) < TIME_NETWORK_MIN_BLOCKS:
        run //= 2
    return run


def time_majority_tap(offsets: tuple) -> int | None:
    """The offset that holds more than half of ``offsets``' taps, or None.
    Such a tap is the median of every window: the replicate border's
    fm + 1 copies of offset 0 among 2 fm + 1 taps (hop 256: six of
    eleven). The register route takes it alone, as K = 1."""
    top, count = max(((o, offsets.count(o)) for o in set(offsets)), key=lambda oc: oc[1])
    return top if 2 * count > len(offsets) else None


@functools.lru_cache(maxsize=64)
def time_core_plan(offsets: tuple, r: int) -> tuple | None:
    """(shape id, firsts) of K1's shared core for runs of ``r`` output
    rows under ``offsets``: the kernel's id of the tap set's run lengths
    and ``r`` (``select_network.core_shapes``) and each tap run's first
    offset; None where that shape is not built."""
    runs = tap_runs(offsets)
    shape = core_shape_id(tuple(n for _, n in runs), r)
    return None if shape is None else (shape, tuple(first for first, _ in runs))


def time_core_runs(offsets: tuple) -> tuple:
    """The R values K1's shared core is built for under ``offsets``'
    tap-run shape (none for a shape it is not built for)."""
    lengths = tuple(n for _, n in tap_runs(offsets))
    return tuple(r for shape, r in core_shapes() if shape == lengths)


def _time_blocks(t_out: int, streams: int, f: int, run: int) -> int:
    """Blocks of K1's thread mapping (csrc/time_runs.cuh) at runs of ``run``
    output rows."""
    return streams * -(-f // TIME_NETWORK_THREADS) * -(-t_out // run)


@functools.lru_cache(maxsize=64)
def time_network_form(offsets: tuple, t_out: int, streams: int, f: int) -> tuple:
    """How K1's register route takes a call of ``streams`` x ``t_out`` x
    ``f`` outputs under ``offsets``: ('core', R), the shared core, wherever
    it is built for the tap set's run shape (``time_core_runs``) at an R
    up to ``t_out``, at the largest R whose grid still has
    TIME_CORE_MIN_BLOCKS blocks, or the smallest R where none has; else
    ('network', run), the per-output network at ``time_network_run`` (a
    single output row shares nothing). A tap that holds more than half of
    the taps (``time_majority_tap``) is planned as K = 1 first. Fitted on
    an H100 (benches/core_rows.py --forms): the shared core beat the
    per-output network at every row it takes, the fleets' and offline
    passes' grids at their largest filling R (the track's pass 2: 106.66
    us at R = 4, 126.46 at R = 3, 194.69 for the network), a single
    stream's few blocks at the smallest (one hop-64 stream at K = 47: 8.02
    us at R = 4, 8.66 at R = 6, 8.35 for the network)."""
    majority = time_majority_tap(offsets)
    if majority is not None:
        offsets = (majority,)
    runs = [r for r in time_core_runs(offsets) if r <= t_out]
    if runs:
        filling = [r for r in runs if _time_blocks(t_out, streams, f, r) >= TIME_CORE_MIN_BLOCKS]
        return "core", max(filling) if filling else min(runs)
    return "network", time_network_run(t_out, streams, f, offsets)


def time_network_run(t_out: int, streams: int, f: int, offsets: tuple) -> int:
    """Output rows a thread of K1's network kernel takes under
    ``offsets``: ``time_fill_run``, halved while the rows the run stages
    (``time_network_plan``) pass TIME_NETWORK_MAX_STAGED (a run of 8
    stages 61 rows under 44.1 kHz hop 64's 47 causal-wrap taps, 71 under
    63 centered ones; taps scattered farther apart than the run stage
    run x K)."""
    run = time_fill_run(t_out, streams, f)
    while len(time_network_plan(offsets, run)[0]) > TIME_NETWORK_MAX_STAGED:
        run //= 2
    return run


@functools.lru_cache(maxsize=64)
def _network_args(offsets: tuple, run: int) -> tuple:
    """time_network_plan as the C entry's arguments (rows, staged, slots,
    run): host int arrays, built once per (offsets, run)."""
    rows, slots = time_network_plan(offsets, run)
    return ((ctypes.c_int * len(rows))(*rows), len(rows),
            (ctypes.c_int * len(slots))(*slots), run)


@functools.lru_cache(maxsize=64)
def _core_args(offsets: tuple, r: int) -> tuple:
    """time_core_plan as the C entry's arguments (firsts, tap runs,
    shape), built once per (offsets, r); raises where the shape is not
    built."""
    plan = time_core_plan(offsets, r)
    if plan is None:
        raise ZenError(f"tap_median_time: no shared core for tap runs "
                       f"{[n for _, n in tap_runs(offsets)]} at R={r}")
    shape, firsts = plan
    return (ctypes.c_int * len(firsts))(*firsts), len(firsts), shape


def tap_median_time_core_plain(a: torch.Tensor, b: torch.Tensor, offsets, start: int,
                               fill: float = 0.0, r: int = 4) -> torch.Tensor:
    """The shared core's kernel in PyTorch, for the tests: each run of
    ``r`` output rows (the last one ragged) loads the rows its taps reach
    as the kernel does (V = a ++ b, ``fill`` outside, in the inputs'
    dtype) and runs ``core_medians_plain`` on them as float. Bitwise
    ``tap_median_time_plain`` wherever ``time_core_plan`` has a shape."""
    offsets = _int_offsets(tuple(offsets))
    runs = tap_runs(offsets)
    lengths = tuple(n for _, n in runs)
    loads = core_program(lengths, r)[0]
    v = torch.cat([a, b], dim=-2)
    t_v, t_out = v.shape[-2], v.shape[-2] - start
    rel = torch.tensor([runs[j][0] + p for j, p in loads])
    fill_t = torch.tensor(fill, dtype=a.dtype)
    out = torch.empty(v.shape[:-2] + (t_out, v.shape[-1]), dtype=a.dtype)
    for i0 in range(0, t_out, r):
        rows = rel + start + i0
        inside = ((rows >= 0) & (rows < t_v))[:, None]
        staged = torch.where(inside, v[..., rows.clamp(0, t_v - 1), :], fill_t).float()
        medians = core_medians_plain(staged.movedim(-2, 0), lengths, r).to(a.dtype)
        n = min(r, t_out - i0)
        out[..., i0 : i0 + n, :] = medians[:n].movedim(0, -2)
    return out


def time_rank_plan(offsets: tuple, start: int, t_v: int, run: int | None = None) -> tuple:
    """(offsets, run, fits) of K1's rank route for a call on V's ``t_v``
    rows from output row ``start``: the offsets as it plans them
    (``time_rank_offsets``), the run (``run`` or ``time_rank_run``, at
    most the call's output rows) and whether a block's keys fit
    SMEM_OPTIN (where they do not, only the select route takes the
    call)."""
    offsets = time_rank_offsets(offsets, start, t_v)
    run = max(1, min(t_v - start, run or time_rank_run(offsets)))
    return offsets, run, time_rank_keys(offsets, run) <= SMEM_OPTIN


@functools.lru_cache(maxsize=32)
def time_rank_changes(offsets: tuple) -> tuple:
    """The change points of K1's table (``time_rank_table``) for the
    rank route's steps, flattened (q, table[q - 1] - table[q]) pairs for
    each q where the two differ: moving from output row i to i + 1 moves
    the count of relative row q + i - 31 by that much and no other. Two a
    run of taps (hop 32's two runs: four); a repeated tap adds its own."""
    table = time_rank_table(offsets)[2]
    return tuple(v for q in range(1, len(table)) if table[q] != table[q - 1]
                 for v in (q, table[q - 1] - table[q]))


def time_rank_bytes(offsets: tuple, run: int, lane_run: int, cols: int = 1) -> int:
    """Shared memory a block of K1's rank route needs for ``run`` output
    rows, as launch_rank reckons it: the keys (``time_rank_keys``) or,
    with steps (``lane_run`` > 1) over ``cols`` columns, for each column
    the sort's buffers (``_merge_room``, ``_sort_rooms``) and the rank
    of each relative row (span + run - 1 ints), then the unit's run x
    cols medians; the table goes beside them where it also fits."""
    keys = time_rank_keys(offsets, run)
    if lane_run == 1:
        return keys
    rooms = _sort_rooms(keys // KEY_BYTES, TIME_RANK_THREADS // cols)
    column = rooms * _merge_room(keys) + 4 * (time_rank_table(offsets)[1] + run - 1)
    return cols * column + 4 * run * cols


@functools.lru_cache(maxsize=64)
def time_rank_geometry(offsets: tuple, start: int, t_v: int, streams: int, f: int,
                       sms: int = H100_SMS) -> tuple:
    """(run, lane_run, cols) of K1's rank route for a call
    (``time_select_plan``'s arguments): of the walk from rank 0 for every
    output row (``time_rank_plan``'s run, lane run 1, one column a block)
    and the steps (TIME_RANK_COLUMNS adjacent columns a block, each with
    TIME_RANK_THREADS / cols threads, of which up to TIME_RANK_WALKERS
    take a lane run of RANK_LANE_RUNS rows, at most the call's output
    rows, where ``time_rank_bytes`` fits SMEM_OPTIN), the one ``sort_us``
    prices lowest."""
    planned, run, fits = time_rank_plan(offsets, start, t_v)
    return min(_time_rank_geometries(planned, t_v - start, run, streams, f, sms))[1:]


def _time_rank_geometries(planned: tuple, t_out: int, run1: int, streams: int, f: int,
                          sms: int) -> list:
    """[(µs, run, lane_run, cols)] of K1's rank geometries for a call
    (``time_rank_geometry``)."""
    k = len(planned)
    changes = len(time_rank_changes(planned)) // 2
    shapes = {(run1, 1, 1)} | {
        (min(t_out, walkers * lane_run), lane_run, cols)
        for cols in TIME_RANK_COLUMNS for walkers in TIME_RANK_WALKERS
        for lane_run in RANK_LANE_RUNS[1:] if walkers * cols <= TIME_RANK_THREADS}
    out = []
    for run, lane_run, cols in sorted(shapes):
        smem = time_rank_bytes(planned, run, lane_run, cols)
        if lane_run > 1 and (lane_run >= run or cols > f or smem > SMEM_OPTIN):
            continue
        staged = time_rank_staged(planned, run)
        out.append((sort_us(streams * -(-t_out // run) * -(-f // cols), staged,
                            TIME_RANK_THREADS // cols, smem, sms, run=lane_run,
                            step=staged / k + 1 + changes, width=cols), run, lane_run, cols))
    return out


def select_shared_bins(threads: int) -> bool:
    """Whether a select block of ``threads`` keeps its threads' bins in
    shared memory (where they fit: ``select_layout``) rather than in
    registers: at SELECT_SHARED_BINS_THREADS threads, where the cheaper
    count (three instructions a sample, not sixteen) outweighs summing 16
    words a thread each pass."""
    return threads >= SELECT_SHARED_BINS_THREADS


def select_layout(staged: int, threads: int, shared_bins: bool = True) -> tuple:
    """(bits in shared memory, bins in shared memory, bytes) of a select
    block, as zen_pick::layout fits them within SELECT_SHARED_BYTES."""
    bits, bins = 4 * staged, 4 * SELECT_BINS * threads
    if shared_bins and bits + bins <= SELECT_SHARED_BYTES:
        return True, True, bits + bins
    if bits <= SELECT_SHARED_BYTES:
        return True, False, bits
    return False, True, bins


def select_threads(staged: int) -> int:
    """Threads of a select block over ``staged`` samples: about
    SELECT_SAMPLES_A_THREAD a thread, a power of two from
    SELECT_MIN_THREADS to SELECT_MAX_THREADS."""
    want = _pow2_at_least(-(-staged // SELECT_SAMPLES_A_THREAD))
    return min(SELECT_MAX_THREADS, max(SELECT_MIN_THREADS, want))


@functools.lru_cache(maxsize=64)
def time_select_plan(offsets: tuple, start: int, t_v: int, streams: int, f: int,
                     sms: int = H100_SMS) -> tuple:
    """(offsets, run, staged, threads) of K1's select route for a call of
    ``streams`` x ``f`` columns on V's ``t_v`` rows from output row
    ``start``: the offsets as the rank route plans them, the run
    TIME_RANK_RUN (at most the call's output rows) halved while the call
    has fewer blocks than ``sms`` or the run's staged rows' order bits pass
    SELECT_SHARED_BYTES (a run of one that still passes it reads them
    through L2), the rows it stages and the block's threads."""
    offsets = time_rank_offsets(offsets, start, t_v)
    t_out = t_v - start
    run = max(1, min(t_out, TIME_RANK_RUN))
    while run > 1 and (streams * -(-t_out // run) * f < sms
                       or 4 * time_rank_staged(offsets, run) > SELECT_SHARED_BYTES):
        run //= 2
    staged = time_rank_staged(offsets, run)
    return offsets, run, staged, select_threads(staged)


@functools.lru_cache(maxsize=64)
def time_select_unit(offsets: tuple, run: int) -> bool:
    """Whether K1's select blocks may count every staged row once (the
    kernel's `unit`): a run of one output row over distinct planned
    offsets, whose staged rows are its taps, each once."""
    return run == 1 and max(time_rank_table(offsets)[2]) == 1


def _waves(units: int, sms: int, per_sm: int) -> int:
    return -(-units // (sms * max(1, per_sm)))


def select_us(units: int, outputs: int, staged: int, threads: int, sms: int) -> float:
    """The cost rule's µs for a select launch of ``units`` blocks, each
    staging ``staged`` samples and selecting ``outputs`` (H100_SMS's
    constants); blocks share an SM as far as its threads, registers (64
    a thread under the kernel's launch bound) and shared memory allow."""
    smem = select_layout(staged, threads, select_shared_bins(threads))[2]
    per_sm = min(2048 // threads, SM_SHARED_BYTES // (smem + 1024))
    steps = -(-staged // threads)
    block = SELECT_STAGE_US * steps + outputs * SELECT_PASSES * (
        SELECT_PASS_US + SELECT_PASS_THREAD_US * threads + SELECT_SAMPLE_US * steps)
    return LAUNCH_US + _waves(units, sms, per_sm) * block


def _warp_sort_us(n: int, buffers: int, warps: int) -> float:
    """The cost rule's µs for warp_merge_sort's slices of ``buffers``
    buffers of ``n`` keys by a block's ``warps`` warps: each slice's
    bitonic stages over its lanes' WARP_LANE_KEYS keys (a slice of
    WARP_SORT_KEYS, padding included), SORT_WARP_US a key a lane a stage,
    the slices spread over the warps."""
    lg = WARP_SORT_KEYS.bit_length() - 1
    slices = buffers * max(1, n // WARP_SORT_KEYS)
    return -(-slices // warps) * SORT_WARP_US * WARP_LANE_KEYS * (lg * (lg + 1) // 2)


def sort_us(units: int, staged: int, threads: int, smem: int, sms: int,
            store: bool = False, run: int = 1, step: float = 0.0, width: int = 1) -> float:
    """The cost rule's µs for a rank-route launch of ``units`` blocks of
    ``threads``, each sorting the keys of ``staged`` samples (``smem``
    bytes of shared memory) once and walking ~staged/2 ranks from rank 0,
    then, where a thread takes a ``run`` of outputs, ``step`` steps for
    each next one (``width`` such sorts a block, side by side: K1's
    adjacent columns, ``threads`` each); ``store``: K2's key store, one block of
    RANK_STORE_THREADS an SM. Blocks share an SM as far as its threads,
    SM_BLOCKS and shared memory allow, and past SM_FULL_RATE_THREADS threads
    running at once they share its issue."""
    n = _key_count(staged)
    lg = n.bit_length() - 1
    swaps = n // 2 * lg * (lg + 1) // 2
    if store:
        block = STORE_SWAP_US * swaps / RANK_STORE_THREADS + STORE_WALK_US * staged / 2
        return LAUNCH_US + _waves(units, sms, 1) * block
    threads *= width
    per_sm = min(2048 // threads, SM_BLOCKS, SM_SHARED_BYTES // (smem + 1024))
    if run == 1:
        sort_block = SORT_SWAP_US * swaps * width / threads
    else:
        # warp_merge_sort: the slices, then a merge pass for each doubling past one
        passes = max(0, lg - WARP_SORT_KEYS.bit_length() + 1)
        sort_block = (_warp_sort_us(n, width, threads // 32)
                      + SORT_MERGE_US * n * passes * width / threads)
    block = sort_block + SORT_WALK_US * staged / 2 + SORT_STEP_US * (run - 1) * step
    if run > 1:
        block += SORT_STAGE_US * staged / threads
    together = min(per_sm, -(-units // sms))
    return LAUNCH_US + _waves(units, sms, per_sm) * block * max(
        1.0, together * threads / SM_FULL_RATE_THREADS)


def time_warp_slots(k: int) -> int | None:
    """Taps a lane of K1's warp route holds for ``k`` taps: the fewest of
    WARP_SLOTS whose 32 lanes hold them, or None past 32 x
    WARP_SLOTS[-1] (the route does not take ``k``)."""
    return next((slots for slots in WARP_SLOTS if 32 * slots >= k), None)


def warp_us(outputs: int, k: int, sms: int) -> float | None:
    """The cost rule's µs for a launch of K1's warp route on ``outputs``
    outputs of ``k`` taps (H100_SMS's constants: WARP_BASE_US, then
    WARP_OUTPUT_US an output an SM at the slots a lane ``time_warp_slots``
    gives); None where the route does not take ``k``."""
    slots = time_warp_slots(k)
    if slots is None:
        return None
    return (LAUNCH_US + WARP_BASE_US
            + WARP_OUTPUT_US[WARP_SLOTS.index(slots)] * -(-outputs // sms))


@functools.lru_cache(maxsize=64)
def time_route_costs(offsets: tuple, start: int, t_v: int, streams: int, f: int,
                     sms: int = H100_SMS) -> tuple:
    """(rank µs or None, select µs, warp µs or None): the cost rule's
    prices (``sort_us``, ``select_us``, ``warp_us``) of K1's three wide
    routes for a call (``time_select_plan``'s arguments); None where a
    rank block's keys do not fit, or where the warp route does not take
    the tap count."""
    planned, run, fits = time_rank_plan(offsets, start, t_v)
    t_out = t_v - start
    sort = min(_time_rank_geometries(planned, t_out, run, streams, f, sms))[0] if fits else None
    _, srun, staged, threads = time_select_plan(offsets, start, t_v, streams, f, sms)
    return (sort, select_us(streams * -(-t_out // srun) * f, srun, staged, threads, sms),
            warp_us(streams * t_out * f, len(offsets), sms))


def time_rank_pick(offsets: tuple, start: int, t_v: int, streams: int, f: int,
                   sms: int = H100_SMS) -> str:
    """K1's route past REGISTER_TAPS for a call (``time_select_plan``'s
    arguments): of 'rank' (where a block's keys fit, ``time_rank_plan``),
    'warp' (where it takes the tap count, ``time_warp_slots``) and
    'select', the one the cost rule prices lowest (``time_route_costs``;
    on a tie the earlier in that order)."""
    sort, pick, warp = time_route_costs(offsets, start, t_v, streams, f, sms)
    prices = {route: us for route, us in (("rank", sort), ("warp", warp), ("select", pick))
              if us is not None}
    return min(prices, key=prices.get)


def time_route(offsets: tuple) -> str:
    """K1's kernel family for ``offsets``: the 'register' network up to
    REGISTER_TAPS taps, 'rank' (the wide routes: rank, warp or select,
    ``time_call_route``) above."""
    return "register" if len(offsets) <= REGISTER_TAPS else "rank"


def time_call_route(offsets: tuple, start: int, t_v: int, streams: int, f: int,
                    sms: int = H100_SMS) -> str:
    """The route ``tap_median_time`` launches for a call: 'register' up to
    REGISTER_TAPS taps, else ``time_rank_pick``'s 'rank', 'warp' or
    'select'."""
    if time_route(offsets) == "register":
        return "register"
    return time_rank_pick(offsets, start, t_v, streams, f, sms)


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
    k = len(offsets)
    _check_k(k, MAX_TIME_TAPS, "zen_tpu's tap limit")
    _check_dtype(a, b)
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-1]:
        raise ZenError(f"tap_median_time: shapes {a.shape} and {b.shape}")
    ta, tb, f = a.shape[-2], b.shape[-2], a.shape[-1]
    if not 0 <= start <= ta + tb:
        raise ZenError(f"tap_median_time: start {start} outside [0, {ta + tb}]")
    if not a.is_cuda:
        return tap_median_time_plain(a, b, _int_offsets(tuple(offsets)), start, fill)
    _check_cuda_operands(a, b)
    route, args = _time_call(offsets, start, ta, tb, math.prod(a.shape[:-2]), f, a.device)
    out = _time_run(a, b, start, fill, route, args)
    if out.numel():
        # the rank route's trailing arguments lead with the lane run
        _count(tap_median_time, route, steps=route == "rank" and args[2][0] > 1,
               core=args[0] == "zen_tap_median_time_core")
    return out


# The wrapper's plan of a call, by the identity of its offsets object (the
# drivers pass their config's tuple every step): a wide tap set's plan
# then costs a dict lookup, not hashes of its 25,601 offsets (~90 µs a
# hash on the host). Each entry holds the object, so its id stays its own.
_TIME_CALLS: dict = {}
_TIME_CALLS_MAX = 64


def _time_call(offsets, start: int, ta: int, tb: int, streams: int, f: int,
               device: torch.device) -> tuple:
    """(route, launch arguments) of ``tap_median_time`` for a call:
    ``time_call_route`` and ``_time_args``, memoized by ``id(offsets)``."""
    key = (id(offsets), start, ta, tb, streams, f, device)
    hit = _TIME_CALLS.get(key)
    if hit is not None and hit[0] is offsets:
        return hit[1]
    ints = _int_offsets(offsets if isinstance(offsets, tuple) else tuple(offsets))
    route = time_call_route(ints, start, ta + tb, streams, f, _sm_count(device))
    plan = (route, _time_args(ints, start, ta, tb, streams, f, route, device))
    if len(_TIME_CALLS) >= _TIME_CALLS_MAX:
        _TIME_CALLS.clear()
    _TIME_CALLS[key] = (offsets, plan)
    return plan


tap_median_time.launches = 0
tap_median_time.routes = dict.fromkeys(("register", "rank", "select", "warp"), 0)
tap_median_time.steps = 0
tap_median_time.cores = 0


def _time_launch(a, b, offsets: tuple, start: int, fill: float, route: str, cut: int = 0,
                 run: int | None = None, shared_bins: bool | None = None,
                 lane_run: int | None = None, cols: int | None = None,
                 core: int | None = None):
    """K1's ``route`` kernel on checked CUDA operands; counts nothing
    (chip_smoke also calls it to time the network kernel at each ``run``
    and the shared core at each R (``core``), the rank, warp and select
    routes side by side, the rank route at each geometry, and the rank route of
    a ``cut`` build, ``_build.library``). The register route takes
    ``time_network_form``'s kernel unless ``run`` (the per-output network
    at that run) or ``core`` (the shared core at that R, which raises
    where it is not built) is given. ``run`` defaults to the wrapper's
    (``time_rank_geometry``, ``time_select_plan``), the rank route's
    ``lane_run`` and ``cols`` to 1 where ``run`` is given, and
    ``shared_bins`` the select route's ``select_shared_bins``. The rank
    route raises where a block's keys do not fit shared memory."""
    offsets = _int_offsets(tuple(offsets))
    args = _time_args(offsets, start, a.shape[-2], b.shape[-2], math.prod(a.shape[:-2]),
                      a.shape[-1], route, a.device, run, shared_bins, lane_run, cols, core)
    return _time_run(a, b, start, fill, route, args, cut)


def _time_args(offsets: tuple, start: int, ta: int, tb: int, streams: int, f: int,
               route: str, device: torch.device, run: int | None = None,
               shared_bins: bool | None = None, lane_run: int | None = None,
               cols: int | None = None, core: int | None = None) -> tuple:
    """(C entry name, the taps' arguments, the trailing arguments, K) of
    K1's ``route`` for a call (``_time_launch``'s ``run``, ``lane_run``,
    ``cols``, ``shared_bins`` and ``core``); a plan buffer stays a
    tensor, so that a memoized call keeps it alive."""
    t_out = ta + tb - start
    k = len(offsets)
    if route == "register":
        majority = time_majority_tap(offsets)
        if majority is not None:
            offsets, k = (majority,), 1
        if core is None and run is None:
            form, size = time_network_form(offsets, t_out, streams, f)
            core, run = (size, None) if form == "core" else (None, size)
        if core is not None:
            return "zen_tap_median_time_core", _core_args(offsets, core), (), k
        return "zen_tap_median_time_network", _network_args(offsets, run), (), k
    if route == "rank":
        planned, run1, fits = time_rank_plan(offsets, start, ta + tb)
        if not fits:
            raise ZenError(f"tap_median_time: K={len(offsets)}'s rank keys pass a block's "
                           "shared memory (the select route takes this call)")
        if run is None:
            run, lane_run, cols = time_rank_geometry(offsets, start, ta + tb, streams, f,
                                                     _sm_count(device))
        lane_run, cols = lane_run or 1, cols or 1
        run = max(1, min(t_out, run))
        if time_rank_bytes(planned, run, lane_run, cols) > SMEM_OPTIN:
            raise ZenError(f"tap_median_time: a rank block of {run} rows passes shared memory")
        plan, lo, span, staged = _rank_args(planned, run, device)
        return ("zen_tap_median_time_rank", (plan, lo, span, staged, run),
                (lane_run, len(time_rank_changes(planned)) // 2, cols), k)
    if route == "warp":
        slots = time_warp_slots(k)
        if slots is None:
            raise ZenError(f"tap_median_time: the warp route takes at most "
                           f"{32 * WARP_SLOTS[-1]} taps, got {k}")
        return ("zen_tap_median_time_warp",
                (_warp_args(time_rank_offsets(offsets, start, ta + tb), device),), (slots,), k)
    if route == "select":
        planned, srun, staged, threads = time_select_plan(
            offsets, start, ta + tb, streams, f, _sm_count(device))
        if run:
            srun, threads = run, select_threads(time_rank_staged(planned, run))
        plan, lo, span, staged = _rank_args(planned, srun, device)
        if shared_bins is None:
            shared_bins = select_shared_bins(threads)
        return ("zen_tap_median_time_select", (plan, lo, span, staged, srun),
                (threads, int(time_select_unit(planned, srun)), int(shared_bins)), k)
    raise ZenError(f"tap_median_time has no route {route!r}")


def _time_run(a, b, start: int, fill: float, route: str, args: tuple, cut: int = 0):
    """Launch K1 with ``_time_args``' ``args`` into a new output."""
    ta, tb, f = a.shape[-2], b.shape[-2], a.shape[-1]
    lead = a.shape[:-2]
    t_out = ta + tb - start
    out = torch.empty(lead + (t_out, f), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    name, taps, tail, k = args
    err = _launch(
        a,
        _entry(_build.library(cut), name, a.dtype),
        a.data_ptr(),
        b.data_ptr() if tb else a.data_ptr(),
        out.data_ptr(),
        math.prod(lead),
        ta,
        tb,
        f,
        start,
        t_out,
        *(t.data_ptr() if isinstance(t, torch.Tensor) else t for t in taps),
        k,
        _in_dtype(fill, a.dtype),
        *tail,
    )
    _build.check(err, f"tap_median_time ({route})")
    return out


@functools.lru_cache(maxsize=8)
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as the plain twin's torch.where rounds
    its fill, handed to the kernel as a float (cached: one fill per
    config, so a launch does not build a tensor)."""
    return float(torch.tensor(v, dtype=dtype))


@functools.lru_cache(maxsize=32)
def _warp_args(planned: tuple, device: torch.device) -> torch.Tensor:
    """The warp route's offsets (``time_rank_offsets``: far taps moved next
    to V, so that a row index stays within 32 bits) as an int32 buffer on
    ``device``, uploaded once per planned tuple."""
    return torch.tensor(planned, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=32)
def _rank_args(offsets: tuple, run: int, device: torch.device) -> tuple:
    """(plan, min offset, span, staged rows) of K1's rank or select route
    for planned offsets (``time_rank_offsets``) and a run, once per call
    shape: ``plan`` is the table (``time_rank_table``), the staged rows
    (``time_rank_rows``) and the change points (``time_rank_changes``) as
    one int32 buffer on ``device``. A wide tap set
    costs a hash of its offsets a lookup, not a rebuilt plan."""
    lo, span, table = time_rank_table(offsets)
    rows = time_rank_rows(offsets, run)
    # the table, the staged rows and the change points as one int32
    # buffer, uploaded once
    plan = torch.tensor(table + rows + time_rank_changes(offsets), dtype=torch.int32,
                        device=device)
    return plan, lo, span, len(rows)


# ---------------- K2: frequency sliding median ----------------


def sliding_median_boundary_plain(
    x: torch.Tensor, k: int, mode: str
) -> torch.Tensor:
    """Plain twin of ``sliding_median_boundary``: in 'valid' mode only the
    F - k + 1 outputs returned are computed."""
    if mode == "valid":
        return sliding_median(x, range(k), -1, "zero", stop=x.shape[-1] - k + 1)
    m = (k - 1) // 2
    return sliding_median(x, range(-m, m + 1), -1, _PLAIN_BOUNDARY[mode])


def freq_core_runs(k: int) -> tuple:
    """The R values K2's shared core is built for at width ``k``: those of
    the one-run shape (k,) (``select_network.core_shapes``; none past
    FREQ_NETWORK_MAX_TAPS (63), nor at K = 1 or 3)."""
    if k > FREQ_NETWORK_MAX_TAPS:
        return ()
    return tuple(r for lengths, r in core_shapes() if lengths == (k,))


def _freq_core_shape(k: int, r: int) -> int:
    """The kernel's id of (k,) at ``r``; raises where it is not built."""
    if r not in freq_core_runs(k):
        raise ZenError(f"sliding_median_boundary: no shared core for K={k} at R={r}")
    return core_shape_id((k,), r)


def freq_core_issue(k: int, f_out: int, r: int) -> int:
    """min/max a block of K2's shared core issues at runs of ``r``, in
    warp instructions: its chunk (``freq_network_chunk``) in runs of r
    outputs, FREQ_CORE_WARP runs a warp a pass, each pass the whole
    program (``core_program``); R = 1 is the per-output network."""
    runs = -(-freq_network_chunk(f_out) // r)
    return -(-runs // FREQ_CORE_WARP) * len(core_program((k,), r)[1])


@functools.lru_cache(maxsize=64)
def freq_network_form(k: int, rows: int, f_in: int, mode: str) -> tuple:
    """How K2's network route takes a call of ``rows`` rows of ``f_in``
    samples at width ``k``: ('core', R), the shared core, where (k,) is
    built (``freq_core_runs``) and either K is FREQ_CORE_WIDE_TAPS or more,
    at the smaller built R (fewer min/max a thread), or K is
    FREQ_CORE_MIN_TAPS or more and the call has FREQ_CORE_MIN_BLOCKS row
    chunks (the network's blocks; the core's persistent grid takes them
    whatever R), at the built R whose block issues the fewest min/max
    (``freq_core_issue``: a run a thread, so R sets how full a row's last
    warp pass is; the larger R on a tie); else ('network', 1), the
    per-output network, a thread an output at a time."""
    f_out = _freq_out(k, f_in, mode)
    runs = freq_core_runs(k)
    if runs and k >= FREQ_CORE_WIDE_TAPS:
        return "core", min(runs)
    blocks = rows * -(-f_out // freq_network_chunk(f_out))
    if runs and k >= FREQ_CORE_MIN_TAPS and blocks >= FREQ_CORE_MIN_BLOCKS:
        return "core", min(runs, key=lambda r: (freq_core_issue(k, f_out, r), -r))
    return "network", 1


def sliding_median_boundary_core_plain(x: torch.Tensor, k: int, mode: str,
                                       r: int) -> torch.Tensor:
    """The shared core's kernel in PyTorch, for the tests: each run of
    ``r`` outputs (the last one ragged) loads the k + r - 1 samples its
    windows reach, the border applied as the kernel's staging applies it,
    and runs ``core_medians_plain`` on them as float. Bitwise
    ``sliding_median_boundary_plain`` wherever (k,) is built at ``r``."""
    f_in = x.shape[-1]
    f_out = _freq_out(k, f_in, mode)
    loads = core_program((k,), r)[0]
    n_runs = -(-f_out // r)
    base = 0 if mode == "valid" else -((k - 1) // 2)
    p = base + r * torch.arange(n_runs)[:, None] + torch.tensor([q for _, q in loads])
    if mode == "reflect":
        p = torch.minimum(p.abs(), 2 * (f_in - 1) - p.abs())
    elif mode == "wrap":
        p = torch.remainder(p, f_in)
    # edge clamps; the clamp also keeps a ragged run's positions past the
    # row inside it (the kernel reads stale samples there; neither is kept)
    staged = x[..., p.clamp(0, f_in - 1)].float()
    medians = core_medians_plain(staged.movedim(-1, 0), (k,), r)
    out = medians.movedim(0, -1).reshape(*x.shape[:-1], n_runs * r)[..., :f_out]
    return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def freq_rank_tile(k: int):
    """The walk's tile for width ``k`` (the rank route's first design): of
    FREQ_RANK_TILES, the one whose cost per output is least, the walk
    (~S/2 ranks, S = tile + k - 1 staged samples) plus the bitonic sort
    over the next power of two n (n/2 compare-swaps in each of
    log2(n)(log2(n)+1)/2 stages, shared by the tile's outputs, each
    weighed as two walk steps), among the tiles whose n keys fit
    SMEM_OPTIN; None when none fits, which sends K to the key store
    (``freq_rank_store``). The copy mirror segment_copy stages at this
    tile; a call's own geometry is ``freq_rank_plan``'s."""
    best = None
    for tile in FREQ_RANK_TILES:
        seg = tile + k - 1
        n = _pow2_at_least(seg)
        if KEY_BYTES * n > SMEM_OPTIN:
            continue
        lg = n.bit_length() - 1
        cost = seg / 2 + 2 * (n // 2) * (lg * (lg + 1) // 2) / tile
        if best is None or cost < best[0]:
            best = (cost, tile)
    return None if best is None else best[1]


def freq_rank_bytes(k: int, tile: int, run: int) -> int:
    """Shared memory a block of K2's rank route takes for ``tile`` outputs
    of width ``k``, as launch_rank reckons it: the keys or, with steps
    (``run`` > 1), the sort's buffers (``_merge_room``, ``_sort_rooms``),
    the rank of each staged position, the tile's medians, the count below
    the middle rank before each position and the scan's 32 warp sums, 4
    bytes each."""
    seg = tile + k - 1
    n = _key_count(seg)
    if run == 1:
        return KEY_BYTES * n
    return (_sort_rooms(n, freq_rank_threads(k, tile, run)) * _merge_room(KEY_BYTES * n)
            + 4 * (seg + tile + seg + 1 + 32))


def freq_steps_threads(n: int) -> int:
    """The fewest threads of a K2 block with steps over ``n`` keys: one
    for each MERGE_RUN keys (a merge pass's run, and so a warp for each of
    warp_merge_sort's slices), from 32 to 256."""
    return min(256, max(32, n // MERGE_RUN))


def freq_rank_threads(k: int, tile: int, run: int) -> int:
    """Threads of a block of K2's rank route at width ``k``, ``tile``
    outputs and ``run`` outputs a walking thread: one an output where
    each walks from rank 0 (``run`` 1), else whole warps for the tile /
    run walkers, and at least ``freq_steps_threads`` of its key count."""
    if run == 1:
        return tile
    return max(32 * -(-(tile // run) // 32), freq_steps_threads(_key_count(tile + k - 1)))


@functools.lru_cache(maxsize=64)
def freq_rank_plan(k: int, rows: int, f_in: int, mode: str, sms: int = H100_SMS):
    """(tile, run) of K2's rank route in shared memory for
    ``rows`` rows of ``f_in`` samples: of the walk from rank 0 for every
    output (run 1, a thread an output, ``freq_rank_tile``'s tile) and the
    steps (for each key count n and run of RANK_LANE_RUNS outputs a
    walking thread, the walkers ``_freq_rank_geometries`` allows), among
    those whose ``freq_rank_bytes`` fit SMEM_OPTIN and whose tiles number
    at most 65,535 a row, the one ``sort_us`` prices lowest; None where
    none fits (the key store's K)."""
    best = _freq_rank_plans(k, rows, f_in, mode, sms)
    return min(best)[1:] if best else None


def _freq_rank_geometries(k: int) -> list:
    """[(tile, run)] of K2's rank route at width ``k`` whose
    ``freq_rank_bytes`` fit SMEM_OPTIN (``freq_rank_plan``): for each key
    count n and run, as many walking threads as n - k + 1 staged outputs
    allow up to WARP_STEPS_THREADS, and that many rounded down to whole
    warps."""
    walk = freq_rank_tile(k)
    out = [(walk, 1)] if walk else []
    n = _pow2_at_least(k + 31)
    while n - k + 1 >= 32:
        for run in RANK_LANE_RUNS[1:]:
            walkers = min(WARP_STEPS_THREADS, (n - k + 1) // run)
            for count in sorted({walkers, walkers // 32 * 32 or walkers}):
                tile = count * run
                if (tile and _key_count(tile + k - 1) == n
                        and freq_rank_bytes(k, tile, run) <= SMEM_OPTIN):
                    out.append((tile, run))
        n *= 2
        if KEY_BYTES * n > SMEM_OPTIN:
            break
    return out


def _freq_rank_plans(k: int, rows: int, f_in: int, mode: str, sms: int) -> list:
    """[(µs, tile, run)] of K2's rank geometries for a call
    (``freq_rank_plan``)."""
    f_out = _freq_out(k, f_in, mode)
    out = []
    for tile, run in _freq_rank_geometries(k):
        if -(-f_out // tile) > 65_535:
            continue
        seg = min(tile, f_out) + k - 1
        out.append((sort_us(rows * -(-f_out // tile), seg, freq_rank_threads(k, tile, run),
                            freq_rank_bytes(k, tile, run), sms, run=run,
                            step=seg / k + 1), tile, run))
    return out


def freq_network_chunk(f_out: int) -> int:
    """Outputs a block of K2's network route takes of a row of ``f_out``
    (``network_chunk`` of csrc/row_segment.cuh): the row split evenly
    into the fewest chunks of at most FREQ_NETWORK_CHUNK."""
    chunks = -(-f_out // FREQ_NETWORK_CHUNK)
    return -(-f_out // chunks)


def freq_route(k: int) -> str:
    """K2's kernel family for width ``k``: 'network' up to
    FREQ_NETWORK_MAX_TAPS, 'rank' (the rank or select route,
    ``freq_call_route``) from FREQ_RANK_MIN_TAPS on, at every K."""
    return "rank" if k >= FREQ_RANK_MIN_TAPS else "network"


def freq_rank_store(k: int) -> str:
    """Where a block of K2's rank route keeps its keys at width ``k``:
    'shared' where a tile's fit SMEM_OPTIN (``freq_rank_tile``), else
    'scratch' (the key store; K past 16,353)."""
    return "shared" if freq_rank_tile(k) else "scratch"


def _freq_out(k: int, f_in: int, mode: str) -> int:
    return f_in - k + 1 if mode == "valid" else f_in


@functools.lru_cache(maxsize=64)
def freq_select_plan(k: int, rows: int, f_in: int, mode: str, sms: int = H100_SMS) -> tuple:
    """(tile, staged, threads) of K2's select route for ``rows`` rows of
    ``f_in`` samples: outputs a block, SELECT_MAX_TILE (at most the row's
    outputs) halved while the call has fewer blocks than ``sms`` or the
    tile's staged order bits pass SELECT_SHARED_BYTES, then doubled while
    a row has more than 65,535 tiles (the grid's second dimension); the
    samples a block stages (tile + k - 1 positions, or the row's f_in
    samples where those are fewer: ``select_median_kernel``'s `whole`) and
    its threads."""
    f_out = _freq_out(k, f_in, mode)

    def staged(tile):
        return min(tile + k - 1, f_in)

    tile = min(SELECT_MAX_TILE, f_out)
    while tile > 1 and (rows * -(-f_out // tile) < sms
                        or 4 * staged(tile) > SELECT_SHARED_BYTES):
        tile //= 2
    while -(-f_out // tile) > 65_535 and tile < SELECT_MAX_TILE:
        tile = min(SELECT_MAX_TILE, 2 * tile)
    return tile, staged(tile), select_threads(staged(tile))


@functools.lru_cache(maxsize=64)
def freq_route_costs(k: int, rows: int, f_in: int, mode: str, sms: int = H100_SMS) -> tuple:
    """(rank µs, select µs): the cost rule's prices (``sort_us``,
    ``select_us``) of K2's two wide routes for ``rows`` rows of ``f_in``
    samples, the rank route's on the key store past shared memory."""
    f_out = _freq_out(k, f_in, mode)
    tile, staged, threads = freq_select_plan(k, rows, f_in, mode, sms)
    pick = select_us(rows * -(-f_out // tile), min(tile, f_out), staged, threads, sms)
    plans = _freq_rank_plans(k, rows, f_in, mode, sms)
    if plans:
        sort = min(plans)[0]
    else:
        sort = sort_us(rows * -(-f_out // RANK_STORE_THREADS),
                       min(RANK_STORE_THREADS, f_out) + k - 1, RANK_STORE_THREADS,
                       KEY_BYTES * RANK_STORE_CHUNK, sms, store=True)
    return sort, pick


def freq_rank_pick(k: int, rows: int, f_in: int, mode: str, sms: int = H100_SMS) -> str:
    """K2's route from FREQ_RANK_MIN_TAPS for ``rows`` rows of ``f_in``
    samples: whichever of 'rank' (a tile's sort in shared memory, or the
    key store past it: ``freq_rank_store``) and 'select' the cost rule
    prices lower (``freq_route_costs``)."""
    sort, pick = freq_route_costs(k, rows, f_in, mode, sms)
    return "select" if pick < sort else "rank"


def freq_call_route(k: int, rows: int, f_in: int, mode: str, sms: int = H100_SMS) -> str:
    """The route ``sliding_median_boundary`` launches for a call:
    'network' below FREQ_RANK_MIN_TAPS, else ``freq_rank_pick``'s 'rank'
    or 'select'."""
    if freq_route(k) == "network":
        return "network"
    return freq_rank_pick(k, rows, f_in, mode, sms)


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
    _check_k(k, MAX_FREQ_TAPS, "a unit's segment fills a slice of K2's key store")
    _check_dtype(x)
    f_in = x.shape[-1]
    f_out = f_in - k + 1 if mode == "valid" else f_in
    if f_out < 1 or (mode == "reflect" and (k - 1) // 2 > f_in - 1):
        raise ZenError(f"median width {k} does not fit {f_in} samples ({mode})")
    if not x.is_cuda:
        return sliding_median_boundary_plain(x, k, mode)
    _check_cuda_operands(x)
    rows, sms = math.prod(x.shape[:-1]), _sm_count(x.device)
    route = freq_call_route(k, rows, f_in, mode, sms)
    core = freq_network_form(k, rows, f_in, mode)[1] if route == "network" else None
    out = _freq_launch(x, k, mode, route, core=core)
    if out.numel():
        plan = freq_rank_plan(k, rows, f_in, mode, sms) if route == "rank" else None
        _count(sliding_median_boundary, route, freq_rank_store(k) if route == "rank" else None,
               steps=bool(plan) and plan[1] > 1, core=bool(core and core > 1))
    return out


sliding_median_boundary.launches = 0
sliding_median_boundary.routes = dict.fromkeys(("network", "rank", "select"), 0)
sliding_median_boundary.stores = dict.fromkeys(("shared", "scratch"), 0)
sliding_median_boundary.steps = 0
sliding_median_boundary.cores = 0


def _freq_launch(
    x: torch.Tensor, k: int, mode: str, route: str, tile: int | None = None, cut: int = 0,
    chunk: int | None = None, shared_bins: bool | None = None, run: int | None = None,
    core: int | None = None,
) -> torch.Tensor:
    """K2's ``route`` kernel on a checked CUDA operand; counts nothing
    (chip_smoke's sweeps also call it, for every route that takes ``k``,
    each rank ``tile`` and ``run`` (outputs a block and a walking thread;
    default ``freq_rank_plan``'s, run 1 where only ``tile`` is given; the
    block's threads are ``freq_rank_threads``'), the select
    route's outputs a block (``tile``; default ``freq_select_plan``'s) and
    bins (``shared_bins``; default ``select_shared_bins``), and the rank
    route of a ``cut`` build, ``_build.library``). ``chunk`` runs the rank route on the key store
    with that many keys sorted in shared memory at once, whatever K (the
    card tests drive its passes over device memory at small K so); by
    default the store takes the K ``freq_rank_store`` sends it,
    RANK_STORE_CHUNK at once. The network route takes ``freq_network_form``'s
    kernel unless ``core`` is given: 1 the per-output network (a run of one
    output), R > 1 the shared core at runs of R (which raises where it is
    not built)."""
    f_in = x.shape[-1]
    f_out = f_in - k + 1 if mode == "valid" else f_in
    out = torch.empty(x.shape[:-1] + (f_out,), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows = math.prod(x.shape[:-1])
    if route == "rank" and not (chunk or tile):
        plan = freq_rank_plan(k, rows, f_in, mode, _sm_count(x.device))
        tile, run = plan if plan else (None, None)
    if route == "rank" and (chunk or not tile):
        units = rows * -(-f_out // RANK_STORE_THREADS)
        scratch, blocks, keys = rank_store_args(units, min(RANK_STORE_THREADS, f_out) + k - 1,
                                                x.device)
        name = "zen_sliding_median_rank_store"
        extra = (scratch.data_ptr(), blocks, keys, chunk or RANK_STORE_CHUNK)
    elif route == "rank":
        run = run or 1
        name, extra = "zen_sliding_median_rank", (tile, run, freq_rank_threads(k, tile, run))
    elif route == "select":
        pick, staged, threads = freq_select_plan(k, rows, f_in, mode, _sm_count(x.device))
        if tile:
            pick, staged = tile, min(tile + k - 1, f_in)
            threads = select_threads(staged)
        if shared_bins is None:
            shared_bins = select_shared_bins(threads)
        name, extra = "zen_sliding_median_select", (pick, threads, int(shared_bins))
    elif route == "network":
        if core is None:
            core = freq_network_form(k, rows, f_in, mode)[1]
        name, extra = (("zen_sliding_median_core", (_freq_core_shape(k, core),)) if core > 1
                       else ("zen_sliding_median_network", ()))
    else:
        raise ZenError(f"sliding_median_boundary has no route {route!r}")
    err = _launch(
        x,
        _entry(_build.library(cut), name, x.dtype),
        x.data_ptr(),
        out.data_ptr(),
        rows,
        f_in,
        f_out,
        k,
        FREQ_MODES[mode],
        *extra,
    )
    _build.check(err, f"sliding_median_boundary ({route})")
    return out
