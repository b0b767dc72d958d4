"""The large-K median routes ("rank once, select many") on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), so
their block algorithm is emulated here in torch, step for step, from the
same host-side choices the wrappers hand the kernels (K2's tile, K1's
multiplicity table): the row segment or column tile staged with its
boundary or fill, sorted by (value, position) as the kernels' 64-bit
keys order them, and the rank walk that counts window positions (K1: with
their multiplicities) until the count passes (K-1)/2. Where a block's
keys live in the key store past shared memory, the emulation runs the
store's own sort, pass by pass (``sort_store`` of csrc/rank_select.cuh:
chunks sorted in the direction the bitonic network gives them, then each
larger stage's passes over the slice and its strides below a chunk),
at the real chunk and at tiny ones, so that many merge stages run. The
select route (csrc/radix_select.cuh) is emulated step for step too, from
the wrappers' own geometry (``time_select_plan``, ``freq_select_plan``):
each pass's digits of the staged samples' order bits, the counts weighted
by each output's multiplicities (K1's table, K2's window positions or,
where K passes F, the border's repeat count of each sample), the bin that
holds the remaining rank and the prefix it extends. Every emulation is
held BITWISE against the plain twins and zen_tpu's median, which pick
sorted[(K-1)/2]; inputs include tie-heavy ones quantized to 8 levels,
bf16, and (for the select route, against the sort's order) -0.0, +0.0,
+inf and NaN. The tests of the host side (tile, table, routes, the cost
rule, stores, staging limits, the library hash) need no card either.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import _build  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402

POS_BITS = 24  # staged positions below 2**24 in an emulated key
PAD_KEY = (1 << 62) - 1  # above every emulated key, as kPadKey is above every staged one


def _order_bits(v: torch.Tensor) -> torch.Tensor:
    """rank_select.cuh's order_bits as int64: unsigned order == float order."""
    u = v.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, 0xFFFFFFFF - u, u | 2**31)


def _value_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """rank_select.cuh's value_of_bits: float32 values of int64 order bits."""
    u = torch.where(bits >= 2**31, bits & 0x7FFFFFFF, 0xFFFFFFFF - bits)
    return torch.from_numpy(u.numpy().astype(np.uint32).view(np.float32))


def _bitonic_stage(keys: torch.Tensor, size: int, stride: int, base: int) -> torch.Tensor:
    """One compare-swap pass of the kernels' bitonic network over keys
    [..., n] lying at index ``base`` of the whole sort: pairs (i, i +
    stride) with bit ``stride`` of i clear, the smaller key to i where bit
    ``size`` of base + i is clear (merge_down, lane_swap, sort_store)."""
    i = torch.arange(keys.shape[-1])
    lo = i[(i & stride) == 0]
    hi = lo + stride
    x, y = keys[..., lo], keys[..., hi]
    swap = (x > y) == (((base + lo) & size) == 0)
    out = keys.clone()
    out[..., lo] = torch.where(swap, y, x)
    out[..., hi] = torch.where(swap, x, y)
    return out


def _merge_down(keys, size, top, base):
    """rank_select.cuh's merge_down: strides top .. 1 of stage ``size``."""
    stride = top
    while stride >= 1:
        keys = _bitonic_stage(keys, size, stride, base)
        stride //= 2
    return keys


def _bitonic_sort(keys, base=0):
    """rank_select.cuh's bitonic_sort of keys [..., n] at index ``base``."""
    size = 2
    while size <= keys.shape[-1]:
        keys = _merge_down(keys, size, size // 2, base)
        size *= 2
    return keys


def sort_store(keys: torch.Tensor, chunk: int) -> torch.Tensor:
    """rank_select.cuh's sort_store of keys [..., n] (n a power of two)
    through ``chunk`` keys of shared memory, pass by pass: each chunk
    sorted at its index, then each larger stage's strides from a chunk up
    over the whole slice and those below chunk by chunk."""
    n = keys.shape[-1]
    length = min(n, chunk)
    keys = torch.cat([_bitonic_sort(keys[..., c0 : c0 + length], c0)
                      for c0 in range(0, n, length)], dim=-1)
    size = 2 * length
    while size <= n:
        stride = size // 2
        while stride >= length:
            keys = _bitonic_stage(keys, size, stride, 0)
            stride //= 2
        keys = torch.cat([_merge_down(keys[..., c0 : c0 + length], size, length // 2, c0)
                          for c0 in range(0, n, length)], dim=-1)
        size *= 2
    return keys


BATCHER_8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
             (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6))


def merge_sort(keys: list, count: int) -> list:
    """rank_select.cuh's merge_sort of n keys (a power of two >= 32) by
    ``count`` threads, pass by pass: runs of MERGE_RUN keys n / MERGE_RUN
    apart sorted by Batcher's network (sort_run), then each pass's
    MERGE_RUN outputs a thread from the binary search of their merge path
    on (merge_at, a run's end read as the pad key, the first run first on
    ties); where a thread takes more than one run (merge_spare) it loops
    over them. Returns the sorted keys in plain order, as the last pass
    writes them (the passes' merge_index padding is only a layout)."""
    n, r = len(keys), mc.MERGE_RUN
    runs = n // r
    assert mc._merge_rooms(n, count) == (2 if count * r < n else 1)
    src = [None] * n
    for v0 in range(runs):
        v = [keys[v0 + u * runs] for u in range(r)]
        for p, q in BATCHER_8:
            if v[q] < v[p]:
                v[p], v[q] = v[q], v[p]
        src[v0 * r : v0 * r + r] = v
    length = r
    while length < n:
        dst = [None] * n
        for e0 in range(0, n, r):
            base = e0 & ~(2 * length - 1)
            d = e0 - base
            a_run, b_run = src[base : base + length], src[base + length : base + 2 * length]
            lo, hi = max(0, d - length), min(d, length)
            while lo < hi:
                mid = (lo + hi) // 2
                if a_run[mid] <= b_run[d - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, d - lo
            a = a_run[i] if i < length else PAD_KEY
            b = b_run[j] if j < length else PAD_KEY
            for u in range(r):
                take_a = a <= b
                dst[e0 + u] = a if take_a else b
                i, j = (i + 1, j) if take_a else (i, j + 1)
                nxt = i if take_a else j
                loaded = (a_run if take_a else b_run)[nxt] if nxt < length else PAD_KEY
                a, b = (loaded, b) if take_a else (a, loaded)
        src, length = dst, 2 * length
    return src


def _sorted_positions(values: torch.Tensor, chunk: int | None = None) -> tuple:
    """Staged values [..., S] sorted by (value, position), as the kernels'
    sort of their keys leaves them: (values, positions). ``chunk``: the
    key store's sort, of the keys padded to key_count(S) as the kernels
    pad them; None: the shared store's (an ascending sort, emulated by
    torch.sort)."""
    s = values.shape[-1]
    pos = torch.arange(s).expand(values.shape)
    keys = (_order_bits(values) << POS_BITS) | pos
    if chunk is None:
        keys, _ = torch.sort(keys, dim=-1)
    else:
        pad = torch.full(values.shape[:-1] + (mc._key_count(s) - s,), PAD_KEY)
        keys = sort_store(torch.cat([keys, pad], dim=-1), chunk)[..., :s]
        assert torch.equal(keys, torch.sort(keys, dim=-1).values)
    p = keys & ((1 << POS_BITS) - 1)
    return torch.gather(values, -1, p), p


def _walk(sorted_values, counts, m):
    """The rank walk: the value at the first rank where the running count
    of the output's window taps, counts [..., outputs, S], passes m."""
    rank = (counts.cumsum(-1) > m).to(torch.int8).argmax(-1)
    return torch.gather(sorted_values, -1, rank[..., None])[..., 0]


WALK_CHUNK = 8  # rank_select.cuh's kWalkChunk
PAD_POSITION = 0xFFFFFFFF  # a padding key's position: past every window


def _walk_from_zero(positions: list, weight, m: int) -> tuple:
    """rank_select.cuh's walk_from_zero over one block's sorted positions
    (padded to the key count): WALK_CHUNK ranks a step while their counts
    do not pass m, then rank by rank. (rank, count below it)."""
    rank = seen = 0
    while True:
        step = sum(weight(p) for p in positions[rank : rank + WALK_CHUNK])
        if seen + step > m:
            break
        seen, rank = seen + step, rank + WALK_CHUNK
    while seen + weight(positions[rank]) <= m:
        seen, rank = seen + weight(positions[rank]), rank + 1
    return rank, seen


def _seek(positions: list, weight, m: int, at: int, below: int) -> tuple:
    """rank_select.cuh's seek: from rank ``at`` with ``below`` counted
    before it, down WALK_CHUNK ranks a step while the count below the
    chunk still passes m, then rank by rank while it does; then up a chunk
    a step while the chunk leaves the answer beyond it (and ends by the
    key count), then rank by rank. (rank, count below it)."""
    n = len(positions)
    while below > m and at >= WALK_CHUNK:
        chunk = sum(weight(p) for p in positions[at - WALK_CHUNK : at])
        if below - chunk <= m:
            break
        below, at = below - chunk, at - WALK_CHUNK
    while below > m:
        at -= 1
        below -= weight(positions[at])
    while at + WALK_CHUNK <= n:
        chunk = sum(weight(p) for p in positions[at : at + WALK_CHUNK])
        if below + chunk > m:
            break
        below, at = below + chunk, at + WALK_CHUNK
    while below + weight(positions[at]) <= m:
        below, at = below + weight(positions[at]), at + 1
    return at, below


def _prefix_below(ranks: list, pivot: int) -> list:
    """rank_select.cuh's prefix_below: for each p, how many of ranks[:p]
    lie below ``pivot`` (a rank of None, a row no tap reaches, never)."""
    out = [0]
    for r in ranks:
        out.append(out[-1] + (r is not None and r < pivot))
    return out


def _step(positions: list, weight, m: int, at: int, below: int) -> tuple:
    """rank_select.cuh's step: down while the count below passes m, then
    up to the rank at which it does. (rank, count below it)."""
    while below > m:
        at -= 1
        below -= weight(positions[at])
    while below + weight(positions[at]) <= m:
        below, at = below + weight(positions[at]), at + 1
    return at, below


def _sorted_block(keys_pos: torch.Tensor, n: int) -> tuple:
    """(positions by rank, padded to n keys with PAD_POSITION; inv: the
    rank of each staged position) of one block's sorted positions."""
    positions = keys_pos.tolist()
    inv = [0] * len(positions)
    for rank, p in enumerate(positions):  # the scatter
        inv[p] = rank
    return positions + [PAD_POSITION] * (n - len(positions)), inv


def _boundary_index(p, f, mode):
    """median_freq.cu's boundary_index (jnp.pad semantics)."""
    if mode == "reflect":
        p = p.abs()
        return torch.minimum(p, 2 * (f - 1) - p)
    if mode == "wrap":
        return torch.remainder(p, f)
    if mode == "edge":
        return p.clamp(0, f - 1)
    return p


def emulate_freq_rank(x: torch.Tensor, k: int, mode: str, chunk: int | None = None,
                      tile: int | None = None, run: int | None = None) -> torch.Tensor:
    """K2's rank kernel: a block per (row, tile), each staging the
    tile + K - 1 samples its outputs reach, the last tile ragged; the
    wrapper's ``freq_rank_plan`` for the call on an H100's SMs, or
    ``tile`` and ``run`` as ``_freq_launch`` forces them. Run 1: every
    output walks from rank 0 (``_walk``); a longer run: the steps
    (``emulate_freq_steps``). On the key store (where ``freq_rank_store``
    sends K, or at ``chunk`` keys of shared memory, as
    ``_freq_launch(chunk=)``) a unit is RANK_STORE_THREADS outputs and its
    keys take the store's sort."""
    if chunk is None and mc.freq_rank_store(k) == "scratch":
        chunk = mc.RANK_STORE_CHUNK
    f_in = x.shape[-1]
    rows = x.reshape(-1, f_in).float()
    if chunk is not None:
        tile, run = mc.RANK_STORE_THREADS, 1
    elif tile is None:
        tile, run = mc.freq_rank_plan(k, rows.shape[0], f_in, mode)
    run = run or 1
    f_out = f_in - k + 1 if mode == "valid" else f_in
    m = (k - 1) // 2
    out = torch.empty(rows.shape[0], f_out)
    for j0 in range(0, f_out, tile):
        live = min(tile, f_out - j0)
        base = j0 if mode == "valid" else j0 - m
        seg = rows[:, _boundary_index(torch.arange(live + k - 1) + base, f_in, mode)]
        values, pos = _sorted_positions(seg, chunk)  # [R, S]
        if run > 1:
            out[:, j0 : j0 + live] = emulate_freq_steps(values, pos, k, live, run)
            continue
        j = torch.arange(live)[:, None]
        in_window = ((pos[:, None, :] - j) >= 0) & ((pos[:, None, :] - j) < k)
        out[:, j0 : j0 + live] = _walk(values[:, None, :].expand(-1, live, -1),
                                       in_window.to(torch.int32), m)
    return out.reshape(x.shape[:-1] + (f_out,)).to(x.dtype)


def emulate_freq_steps(values: torch.Tensor, pos: torch.Tensor, k: int, live: int, run: int
                       ) -> torch.Tensor:
    """rank_steps_median_kernel's walk over each block's sorted segment,
    values and positions [R, S]: the inverse ranks from one scatter, the
    count of positions ranked below the middle rank S // 2 before each
    position (one scan), then thread t's outputs t * run .. t * run + run
    - 1 (the live ones): the first sought from the middle rank, its count
    below off the scan, each next stepped from the previous rank after
    moving the count below it by the position that left (j - 1) and the
    one that entered (j + k - 1). Medians [R, live]."""
    m = (k - 1) // 2
    n = mc._key_count(pos.shape[-1])
    pivot = pos.shape[-1] // 2
    out = torch.empty(values.shape[0], live)
    for r in range(values.shape[0]):
        positions, inv = _sorted_block(pos[r], n)
        prefix = _prefix_below(inv, pivot)
        for first in range(0, live, run):
            j = first

            def in_window(p):
                return int(0 <= p - j < k)

            at, below = _seek(positions, in_window, m, pivot, prefix[j + k] - prefix[j])
            out[r, j] = values[r, at]
            for j in range(first + 1, min(first + run, live)):
                below += int(inv[j + k - 1] < at) - int(inv[j - 1] < at)
                at, below = _step(positions, in_window, m, at, below)
                out[r, j] = values[r, at]
    return out


def emulate_time_rank(a, b, offsets, start, fill=0.0, run=None, lane_run=None
                      ) -> torch.Tensor:
    """K1's rank kernel: the wrapper's plan for the call
    (``time_rank_plan``: taps that read only fill moved next to V, keys
    that fit a block; ``time_rank_geometry`` on an H100's SMs: the run of
    output rows a block and the lane run a thread, or ``run`` and
    ``lane_run`` as ``_time_launch`` forces them), a block per (stream,
    run, column) staging the rows the run's taps reach
    (``time_rank_rows``) of V = a ++ b (fill outside, in the inputs'
    dtype), keyed by (value, relative row), sorted in shared memory, the
    multiplicity table read at row - lane + 31 (0 outside it). Lane run
    1: every output row walks from rank 0; longer: the steps
    (``emulate_time_steps``)."""
    v = torch.cat([a, b], dim=-2).float()
    c, t_v, f = v.shape[0], v.shape[1], v.shape[2]
    offsets_in = tuple(offsets)
    offsets, run1, fits = mc.time_rank_plan(offsets_in, start, t_v)
    assert fits
    if run is None:
        run, lane_run, _ = mc.time_rank_geometry(offsets_in, start, t_v, c, f)
    lane_run = lane_run or 1
    lo, span, table = mc.time_rank_table(offsets)
    table = torch.tensor(table + (0,) * (run + span))  # 0 past the table's end
    t_out = t_v - start
    run = max(1, min(run, t_out))
    rel = torch.tensor(mc.time_rank_rows(offsets, run))
    fill = torch.tensor(fill, dtype=a.dtype).float()
    m = (len(offsets) - 1) // 2
    out = torch.empty(c, t_out, f)
    for i0 in range(0, t_out, run):
        rows = rel + start + i0 + lo
        inside = (rows >= 0) & (rows < t_v)
        staged = torch.where(inside[None, :, None], v[:, rows.clamp(0, t_v - 1)], fill)
        values, idx = _sorted_positions(staged.transpose(1, 2))  # [C, F, S]
        pos = rel[idx]  # a key's position is its relative row
        live = min(run, t_out - i0)
        if lane_run > 1:
            med = emulate_time_steps(values.reshape(c * f, -1), pos.reshape(c * f, -1),
                                     offsets, live, lane_run).reshape(c, f, live)
            out[:, i0 : i0 + live] = med.transpose(1, 2)
            continue
        lane = torch.arange(run)[:, None]
        q = pos[:, :, None, :] - lane + mc.TIME_RANK_RUN - 1
        counts = torch.where(q >= 0, table[q.clamp(min=0)], 0)  # [C, F, run, S]
        med = _walk(values[:, :, None, :].expand(-1, -1, run, -1), counts, m)
        out[:, i0 : i0 + live] = med[:, :, :live].transpose(1, 2)
    return out.to(a.dtype)


def emulate_time_steps(values: torch.Tensor, pos: torch.Tensor, offsets: tuple, live: int,
                       lane_run: int) -> torch.Tensor:
    """tap_median_time_steps_kernel's walk over each block's sorted keys,
    values and relative rows [U, S]: the rank of each relative row from
    one scatter, then thread t's output rows t * lane_run .. (the live
    ones): the first walked from rank 0, each next i stepped from the
    previous rank after moving the count below it at the tap set's change
    points (``time_rank_changes``: row q + (i - 1) - 31 by table[q - 1] -
    table[q]). Medians [U, live]."""
    _, span, table = mc.time_rank_table(offsets)
    changes = mc.time_rank_changes(offsets)
    pairs = list(zip(changes[::2], changes[1::2]))
    m = (len(offsets) - 1) // 2
    n = mc._key_count(pos.shape[-1])
    out = torch.empty(values.shape[0], live)
    for u in range(values.shape[0]):
        rel = pos[u].tolist()
        inv = [None] * (max(rel) + 1)  # span + run - 1 in the kernel
        for rank, d in enumerate(rel):  # the scatter over relative rows
            inv[d] = rank
        positions = rel + [PAD_POSITION] * (n - len(rel))
        for first in range(0, live, lane_run):
            i = first

            def count(d):
                q = d + mc.TIME_RANK_RUN - 1 - i
                return table[q] if 0 <= q < len(table) else 0

            at, below = _walk_from_zero(positions, count, m)
            out[u, i] = values[u, at]
            for i in range(first + 1, min(first + lane_run, live)):
                for q, delta in pairs:
                    d = q + i - mc.TIME_RANK_RUN
                    assert inv[d] is not None  # a change point's row is staged
                    if inv[d] < at:
                        below += delta
                at, below = _step(positions, count, m, at, below)
                out[u, i] = values[u, at]
    return out


DIGIT_BITS, BINS = 4, 16  # radix_select.cuh's kDigitBits, kBins


def emulate_select(bits: torch.Tensor, weights: torch.Tensor, m: int) -> torch.Tensor:
    """zen_pick::select for each output: bits [..., S] (int64 order bits
    of a block's staged samples), weights [..., outputs, S] (each sample's
    multiplicity in each output's window). The digits the block's least
    and largest staged sample share are taken as they are; then pass by
    pass, most significant digit first: the samples whose higher digits
    match the output's prefix, their next digit's counts weighted, the
    first bin whose running count passes the remaining rank, which extends
    the prefix and drops the counts below it. Returns the order bits
    [..., outputs]."""
    assert mc.SELECT_PASSES * DIGIT_BITS == 32
    lo, hi = bits.min(-1).values, bits.max(-1).values
    same = 32 - torch.floor(torch.log2((lo ^ hi).double().clamp(min=1))).long() - 1
    same = torch.where(lo == hi, 32, same)  # leading bits every sample shares
    first = (same // DIGIT_BITS)[..., None]  # [..., 1]: the first pass a block counts
    keep = (0xFFFFFFFF << (32 - DIGIT_BITS * first)) & 0xFFFFFFFF
    prefix = torch.where(first > 0, lo[..., None] & keep, 0).expand(weights.shape[:-1]).clone()
    rank = torch.full(weights.shape[:-1], m, dtype=torch.int64)
    b = bits[..., None, :]
    for p in range(mc.SELECT_PASSES):
        shift = 32 - DIGIT_BITS * (p + 1)
        above = 0 if p == 0 else (0xFFFFFFFF << (shift + DIGIT_BITS)) & 0xFFFFFFFF
        match = ((b ^ prefix[..., None]) & above) == 0
        digit = (b >> shift) & (BINS - 1)
        counts = torch.stack([((digit == q) & match).long().mul(weights).sum(-1)
                              for q in range(BINS)], dim=-1)
        upto = counts.cumsum(-1)
        q = (upto > rank[..., None]).to(torch.int8).argmax(-1)
        assert bool((upto[..., -1] > rank).all())  # the rank lies in some bin
        counted = p >= first  # [..., 1]
        if not counted.all():  # a skipped digit: every sample's, the rank unmoved
            assert bool(((q == ((lo[..., None] >> shift) & (BINS - 1))) | counted).all())
        below = torch.gather(upto - counts, -1, q[..., None])[..., 0]
        rank = torch.where(counted, rank - below, rank)
        prefix = torch.where(counted, prefix | (q << shift), prefix)
    return prefix


def emulate_time_select(a, b, offsets, start, fill=0.0, run=None) -> torch.Tensor:
    """K1's select kernel: the wrapper's geometry for the call
    (``time_select_plan`` on an H100's SMs: the planned offsets, the run,
    or ``run`` as ``_time_launch(run=)`` forces it), a block per (stream,
    run, column) staging the rows the run's taps reach (fill outside V,
    in the inputs' dtype) as order bits, each output row lane selected with
    relative row d counted table[d - lane + 31] times."""
    v = torch.cat([a, b], dim=-2).float()
    c, t_v, f = v.shape
    planned, srun, staged, _ = mc.time_select_plan(tuple(offsets), start, t_v, c, f)
    run = run or srun
    lo, _, table = mc.time_rank_table(planned)
    table = torch.tensor(table)
    rel = torch.tensor(mc.time_rank_rows(planned, run))
    assert run != srun or len(rel) == staged
    fill = torch.tensor(fill, dtype=a.dtype).float()
    t_out = t_v - start
    out = torch.empty(c, t_out, f)
    weights = table[rel[None, :] - torch.arange(run)[:, None] + mc.TIME_RANK_RUN - 1]
    for i0 in range(0, t_out, run):
        rows = rel + start + i0 + lo
        inside = (rows >= 0) & (rows < t_v)
        vals = torch.where(inside[None, :, None], v[:, rows.clamp(0, t_v - 1)], fill)
        bits = _order_bits(vals.transpose(1, 2))  # [C, F, S]
        med = _value_of_bits(emulate_select(bits, weights.expand(c, f, -1, -1),
                                            (len(offsets) - 1) // 2))  # [C, F, run]
        live = min(run, t_out - i0)
        out[:, i0 : i0 + live] = med[:, :, :live].transpose(1, 2)
    return out.to(a.dtype)


def _row_count(s, lo, hi, f: int, mode: str) -> torch.Tensor:
    """median_freq.cu's row_count: how many positions of [lo, hi] the
    border maps to sample s of a row of f."""
    def inside(p):
        return ((lo <= p) & (p <= hi)).long()

    if mode == "wrap":
        return (torch.div(hi - s, f, rounding_mode="floor")
                - torch.div(lo - 1 - s, f, rounding_mode="floor"))
    if mode == "edge":
        if f == 1:
            return (hi - lo + 1).expand(-1, s.shape[-1])
        first = (torch.minimum(hi, torch.zeros_like(hi)) - lo + 1).clamp(min=0)
        last = (hi - torch.maximum(lo, torch.full_like(lo, f - 1)) + 1).clamp(min=0)
        return torch.where(s == 0, first, torch.where(s == f - 1, last, inside(s)))
    assert mode == "reflect"
    return inside(s) + (s > 0) * inside(-s) + (s < f - 1) * inside(2 * (f - 1) - s)


def emulate_freq_select(x: torch.Tensor, k: int, mode: str, tile: int | None = None
                        ) -> torch.Tensor:
    """K2's select kernel: the wrapper's tile (``freq_select_plan`` on an
    H100's SMs, or ``tile``), a block per (row, tile) staging the
    positions its windows reach (boundary applied), each counted once in
    the windows it lies in, or, where those positions outnumber the row's
    samples (`whole`), the row's samples counted by ``_row_count``."""
    f_in = x.shape[-1]
    rows = x.reshape(-1, f_in).float()
    f_out = f_in - k + 1 if mode == "valid" else f_in
    tile = tile or mc.freq_select_plan(k, rows.shape[0], f_in, mode)[0]
    m = (k - 1) // 2
    out = torch.empty(rows.shape[0], f_out)
    for j0 in range(0, f_out, tile):
        live = min(tile, f_out - j0)
        j = j0 + torch.arange(live)[:, None]
        if live + k - 1 > f_in:
            samples = rows
            e = torch.arange(f_in)[None, :]
            weights = _row_count(e, j - m, j + m, f_in, mode)
        else:
            base = j0 if mode == "valid" else j0 - m
            samples = rows[:, _boundary_index(torch.arange(live + k - 1) + base, f_in, mode)]
            e = torch.arange(live + k - 1)[None, :]
            weights = ((e - (j - j0) >= 0) & (e - (j - j0) < k)).long()
        assert bool((weights.sum(-1) == k).all())
        med = emulate_select(_order_bits(samples), weights.expand(rows.shape[0], -1, -1), m)
        out[:, j0 : j0 + live] = _value_of_bits(med)
    return out.reshape(x.shape[:-1] + (f_out,)).to(x.dtype)


def _levels(rng, shape, ties: bool) -> np.ndarray:
    """Positive magnitudes; tie-heavy ones take 8 levels only."""
    x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
    return np.floor(x * 8).astype(np.float32) / 8 + np.float32(0.125) if ties else x


def _tensor(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


# ---------------- K2: the segment, sorted once per block ----------------


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [13, 47, 187, 257, 401])
def test_freq_rank_emulation_matches_twin(k, mode, ties):
    """Every boundary mode, ragged last tiles (517 outputs per row)."""
    rng = np.random.default_rng(k)
    f_in = 517 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (3, f_in), ties), torch.float32)
    got = emulate_freq_rank(x, k, mode)
    assert got.shape == (3, 517)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge"])
@pytest.mark.parametrize("k", [65, 187])
def test_freq_rank_emulation_matches_jax(k, mode):
    """The emulation against zen_tpu's median on the same rows."""
    rng = np.random.default_rng(3 * k)
    x = _levels(rng, (2, 600), ties=True)
    m = (k - 1) // 2
    boundary = {"edge": "clamp"}.get(mode, mode)
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = emulate_freq_rank(_tensor(x, torch.float32), k, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [13, 187])
@pytest.mark.parametrize("mode", ["reflect", "valid"])
def test_freq_rank_emulation_bf16(k, mode):
    rng = np.random.default_rng(5)
    f_in = 300 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties=False), torch.bfloat16)
    got = emulate_freq_rank(x, k, mode)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


# ---------------- K1: a column tile, sorted once per warp ----------------

K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32, wrap


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [  # wrap: two runs, the causal pair form, t_out 40 (a ragged run)
     ((2, 183, 9), (2, 40, 9), K93, 183, 0.0),
     # centered K = 401 (48 kHz hop 8): fill beyond both ends
     ((1, 100, 5), (1, 0, 5), tuple(range(-200, 201)), 0, 0.0),
     # valid: the previous K frames
     ((2, 67, 7), (2, 5, 7), tuple(range(-67, 0)), 67, float("inf")),
     # replicate: offset 0 repeated past the run (multiplicity 60)
     ((1, 70, 6), (1, 3, 6), tuple(range(-69, 0)) + (0,) * 60, 3, 0.0),
     # duplicates inside the span, one input, fill inf
     ((1, 90, 4), (1, 0, 4), (0,) * 33 + tuple(range(-33, 1)), 0, float("inf")),
     # the hop-32 step at B = 1 and B = 5: runs shorter than 32 rows
     ((2, 183, 9), (2, 1, 9), K93, 183, 0.0),
     ((1, 183, 6), (1, 5, 6), K93, 183, 0.0),
     # spans past 16,352 rows, both ends: the far taps read only fill
     ((1, 300, 3), (1, 0, 3), (-16353,) + tuple(range(-65, 1)), 0, 0.0),
     ((1, 40, 3), (1, 9, 3), (-70000,) + tuple(range(-32, 33)) + (70000,), 20, float("inf")),
     # 601 taps 40 rows apart: a run of 32 stages 19,232 rows, whose keys
     # pass 227 KB, so the blocks take runs of 16
     ((1, 40, 2), (1, 0, 2), tuple(range(-24000, 1, 40)), 0, 0.0)],
)
def test_time_rank_emulation_matches_twin(a_shape, b_shape, offsets, start, fill, ties):
    rng = np.random.default_rng(len(offsets))
    a = _tensor(_levels(rng, a_shape, ties), torch.float32)
    b = _tensor(_levels(rng, b_shape, ties), torch.float32)
    assert mc.time_route(offsets) == "rank"
    got = emulate_time_rank(a, b, offsets, start, fill)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def test_time_rank_emulation_matches_jax():
    rng = np.random.default_rng(21)
    a, b = _levels(rng, (2, 183, 5), True), _levels(rng, (2, 33, 5), True)
    want = np.asarray(jax_sliding_median(
        jnp.concatenate([a, b], axis=-2), K93, -2, "zero")[..., 183:, :])
    got = emulate_time_rank(_tensor(a, torch.float32), _tensor(b, torch.float32), K93, 183)
    np.testing.assert_array_equal(got.numpy(), want)


def test_time_rank_emulation_bf16():
    rng = np.random.default_rng(22)
    a = _tensor(_levels(rng, (1, 183, 6), False), torch.bfloat16)
    b = _tensor(_levels(rng, (1, 32, 6), False), torch.bfloat16)
    got = emulate_time_rank(a, b, K93, 183, 0.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.tap_median_time_plain(a, b, K93, 183, 0.3))


# ---------------- the steps: each output from its neighbour's median ----------------

# K2's (tile, run) as the wrapper plans the 4-minute track's pass 1 and
# median2d fl 187 (2585 rows of 8193 at K = 187), forced on small rows,
# and tiny geometries that put many run edges and tile edges in a call
FREQ_STEPS = [mc.freq_rank_plan(187, 2585, 8193, "reflect"), (96, 3), (160, 5), (64, 1)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [47, 187])
@pytest.mark.parametrize("tile,run", FREQ_STEPS)
def test_freq_steps_emulation_matches_twin(tile, run, k, mode, ties):
    """K2's walk with steps, every border, ragged last tiles and runs
    (517 outputs a row: the last thread's run ends short)."""
    rng = np.random.default_rng(k + tile + run)
    f_in = 517 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties), torch.float32)
    got = emulate_freq_rank(x, k, mode, tile=tile, run=run)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("k,mode,tile,run", [(187, "reflect", 96, 3), (65, "wrap", 160, 5),
                                             (47, "edge", 288, 9)])
def test_freq_steps_emulation_matches_jax(k, mode, tile, run):
    rng = np.random.default_rng(5 * k)
    x = _levels(rng, (2, 600), ties=True)
    m = (k - 1) // 2
    boundary = {"edge": "clamp"}.get(mode, mode)
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = emulate_freq_rank(_tensor(x, torch.float32), k, mode, tile=tile, run=run).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["reflect", "valid"])
@pytest.mark.parametrize("tile,run", [(96, 3), (288, 9)])
def test_freq_steps_emulation_bf16(tile, run, mode):
    rng = np.random.default_rng(tile)
    f_in = 300 + (186 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties=False), torch.bfloat16)
    got = emulate_freq_rank(x, 187, mode, tile=tile, run=run)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, 187, mode))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill,run,lane_run",
    [  # hop 32's two tap runs (four change points): a run of 32 in lane runs
       # of 3, one of 96 in lane runs of 5, t_out 40 (the last block short)
     ((2, 183, 5), (2, 40, 5), K93, 183, 0.0, 32, 3),
     ((1, 183, 4), (1, 40, 4), K93, 183, 0.0, 96, 5),
     # replicate: offset 0 repeated (a change of 60 at its row)
     ((1, 70, 3), (1, 3, 3), tuple(range(-69, 0)) + (0,) * 60, 3, 0.0, 32, 3),
     # median2d's valid fl 93, the wrapper's geometry for the track's
     # [41355, 513], on 300 rows: its last block's run ends at the call's
     # last row
     ((1, 392, 3), (1, 0, 3), tuple(range(-92, 1)), 92, 0.0,
      *mc.time_rank_geometry(tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513)[:2]),
     # duplicates inside the span, fill inf; centered K = 401 past both ends
     ((1, 90, 4), (1, 0, 4), (0,) * 33 + tuple(range(-33, 1)), 0, float("inf"), 64, 7),
     ((1, 100, 2), (1, 0, 2), tuple(range(-200, 201)), 0, 0.0, 96, 3)],
)
def test_time_steps_emulation_matches_twin(a_shape, b_shape, offsets, start, fill, run,
                                           lane_run, ties):
    rng = np.random.default_rng(len(offsets) + run)
    a = _tensor(_levels(rng, a_shape, ties), torch.float32)
    b = _tensor(_levels(rng, b_shape, ties), torch.float32)
    assert lane_run > 1
    got = emulate_time_rank(a, b, offsets, start, fill, run, lane_run)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def test_time_steps_emulation_matches_jax():
    rng = np.random.default_rng(24)
    a, b = _levels(rng, (2, 183, 3), True), _levels(rng, (2, 33, 3), True)
    want = np.asarray(jax_sliding_median(
        jnp.concatenate([a, b], axis=-2), K93, -2, "zero")[..., 183:, :])
    got = emulate_time_rank(_tensor(a, torch.float32), _tensor(b, torch.float32), K93, 183,
                            run=33, lane_run=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_time_steps_emulation_bf16():
    rng = np.random.default_rng(25)
    a = _tensor(_levels(rng, (1, 183, 4), False), torch.bfloat16)
    b = _tensor(_levels(rng, (1, 32, 4), False), torch.bfloat16)
    got = emulate_time_rank(a, b, K93, 183, 0.3, run=32, lane_run=5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.tap_median_time_plain(a, b, K93, 183, 0.3))


def test_time_rank_changes_are_the_table_edges():
    """Two change points a run of taps, the repeated tap's own, and each
    change point's row staged for every lane move of a run."""
    assert mc.time_rank_changes(tuple(range(-4, 1))) == (31, -1, 36, 1)
    assert len(mc.time_rank_changes(K93)) // 2 == 4
    rep = tuple(range(-5, 0)) + (0,) * 6
    assert mc.time_rank_changes(rep) == (31, -1, 36, -5, 37, 6)
    for offsets, run in ((K93, 32), (rep, 40), ((0,) * 33 + tuple(range(-33, 1)), 64)):
        staged = set(mc.time_rank_rows(offsets, run))
        changes = mc.time_rank_changes(offsets)
        for i in range(1, run):
            assert {q + i - mc.TIME_RANK_RUN for q in changes[::2]} <= staged


# ---------------- the key store past shared memory ----------------

# HPRConfig(fs, hop=1)'s causal time taps (the wrap border): two tap runs
K12801 = tuple(range(-25599, -19199)) + tuple(range(-6400, 1))  # 192 kHz
K25601 = tuple(range(-51199, -38399)) + tuple(range(-12800, 1))  # 384 kHz


@pytest.mark.parametrize("chunk", [32, 64, 1024])
@pytest.mark.parametrize("n", [32, 256, 4096])
def test_sort_store_orders_every_slice(n, chunk):
    """The store's passes sort any keys, pad keys (equal) included, for a
    slice within one chunk and for one of many chunks."""
    gen = torch.Generator().manual_seed(n + chunk)
    keys = torch.randint(0, 1 << 40, (3, n), generator=gen)
    keys[:, -n // 8 :] = PAD_KEY
    keys[1] = keys[1] % 7  # ties, as equal keys never arise in a kernel
    assert torch.equal(sort_store(keys, chunk), torch.sort(keys, dim=-1).values)


@pytest.mark.parametrize("count", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [32, 256, 512, 1024])
def test_merge_sort_orders_every_block(n, count):
    """The steps' merge_sort orders any keys, pad keys (equal) and ties
    included, with one run a thread (its passes in registers) and with
    several (a second buffer)."""
    gen = torch.Generator().manual_seed(n + count)
    keys = torch.randint(0, 1 << 40, (3, n), generator=gen)
    keys[0, -n // 8 :] = PAD_KEY
    keys[1] = keys[1] % 7
    keys[2, ::3] = PAD_KEY
    for row in keys.tolist():
        assert merge_sort(row, count) == sorted(row)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k,chunk", [(13, 32), (187, 64), (401, 256)])
def test_freq_store_emulation_matches_twin(k, chunk, mode, ties):
    """K2 on the key store at a tiny chunk: units of 1024 outputs (1100 a
    row: the second ragged), keys of 2048 slots sorted 32 to 256 at a
    time, so that six to seven stages pass over the slice."""
    rng = np.random.default_rng(k + chunk)
    f_in = 1100 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties), torch.float32)
    got = emulate_freq_rank(x, k, mode, chunk)
    assert got.shape == (2, 1100)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("k,mode", [(187, "reflect"), (65, "wrap")])
def test_freq_store_emulation_matches_jax(k, mode):
    rng = np.random.default_rng(31)
    x = _levels(rng, (2, 1100), ties=True)
    m = (k - 1) // 2
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, mode))
    got = emulate_freq_rank(_tensor(x, torch.float32), k, mode, chunk=32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,f_out", [(16_385, 40), (16_387, 9)])
def test_freq_store_emulation_at_its_k(k, f_out, dtype):
    """Past 16,353 taps the wrapper sends K2 to the store on its own
    (freq_rank_store): a few outputs of a pre-padded row at the real chunk,
    32,768 keys over two chunks of 16,384."""
    assert mc.freq_route(k) == "rank" and mc.freq_rank_store(k) == "scratch"
    rng = np.random.default_rng(k)
    x = _tensor(_levels(rng, (1, f_out + k - 1), True), dtype)
    got = emulate_freq_rank(x, k, "valid")
    assert got.dtype == dtype and got.shape == (1, f_out)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, "valid"))


# ---------------- the select route: a radix select an output ----------------

WRAP_LIMIT = mc.MAX_FREQ_TAPS  # K2's widest K


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,outputs", [(1, 1), (7, 3), (93, 5), (600, 2)])
def test_select_emulation_is_the_weighted_order_statistic(n, outputs, ties):
    """Any order bits, any weights (zeros, repeats): the emulated passes
    end on the weighted multiset's element at rank m, as a sort of the
    samples repeated by their weights gives it."""
    gen = torch.Generator().manual_seed(n + outputs)
    bits = torch.randint(0, 2**32, (n,), generator=gen, dtype=torch.int64)
    if ties:
        bits = bits % 5 + (2**32 - 5)  # five values at the top, many repeats
    weights = torch.randint(0, 4, (outputs, n), generator=gen)
    weights[:, 0] += 1
    for o in range(outputs):
        pool = torch.repeat_interleave(bits, weights[o])
        m = (len(pool) - 1) // 2
        got = emulate_select(bits, weights[o : o + 1], m)
        assert int(got[0]) == int(torch.sort(pool).values[m])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill,run",
    [  # the shapes the K1 key store took (runs forced small so blocks take
       # several output rows), now the select route's
     ((2, 183, 9), (2, 40, 9), K93, 183, 0.0, 32),
     ((1, 100, 5), (1, 0, 5), tuple(range(-200, 201)), 0, float("inf"), None),
     ((1, 70, 6), (1, 3, 6), tuple(range(-69, 0)) + (0,) * 60, 3, 0.0, 2),
     # the rank route's shapes: valid frames, duplicates (multiplicity 33),
     # the hop-32 step at B = 1 and 5, spans past 16,352 rows at both ends
     ((2, 67, 7), (2, 5, 7), tuple(range(-67, 0)), 67, float("inf"), None),
     ((1, 90, 4), (1, 0, 4), (0,) * 33 + tuple(range(-33, 1)), 0, float("inf"), 4),
     ((2, 183, 9), (2, 1, 9), K93, 183, 0.0, None),
     ((1, 183, 6), (1, 5, 6), K93, 183, 0.0, None),
     ((1, 300, 3), (1, 0, 3), (-16353,) + tuple(range(-65, 1)), 0, 0.0, 8),
     ((1, 40, 3), (1, 9, 3), (-70000,) + tuple(range(-32, 33)) + (70000,), 20,
      float("inf"), None)],
)
def test_time_select_emulation_matches_twin(a_shape, b_shape, offsets, start, fill, run, ties):
    rng = np.random.default_rng(len(offsets) + (run or 0))
    a = _tensor(_levels(rng, a_shape, ties), torch.float32)
    b = _tensor(_levels(rng, b_shape, ties), torch.float32)
    got = emulate_time_select(a, b, offsets, start, fill, run)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def test_time_select_emulation_matches_jax():
    rng = np.random.default_rng(23)
    a, b = _levels(rng, (2, 183, 5), True), _levels(rng, (2, 33, 5), True)
    want = np.asarray(jax_sliding_median(
        jnp.concatenate([a, b], axis=-2), K93, -2, "zero")[..., 183:, :])
    got = emulate_time_select(_tensor(a, torch.float32), _tensor(b, torch.float32), K93, 183,
                              run=16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offsets,h", [(K12801, 25_599), (K25601, 51_199)])
def test_time_select_emulation_at_hop1(offsets, h):
    """HPRConfig(192000 and 384000, hop=1)'s causal taps over their whole
    history H and 6 fresh rows of 2 bins: both take the select route on
    the card, a block an output row (12 blocks); 384 kHz's one row
    (25,601 keys) passes shared memory for the sort."""
    assert mc.time_rank_plan(offsets, h, h + 6)[2] == (offsets == K12801)
    assert mc.time_rank_pick(offsets, h, h + 6, 1, 2) == "select"
    assert mc.time_select_plan(offsets, h, h + 6, 1, 2)[1] == 1
    rng = np.random.default_rng(len(offsets))
    a = _tensor(_levels(rng, (1, h, 2), True), torch.float32)
    b = _tensor(_levels(rng, (1, 6, 2), True), torch.float32)
    got = emulate_time_select(a, b, offsets, h)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, h))


def test_time_select_emulation_bf16():
    rng = np.random.default_rng(22)
    a = _tensor(_levels(rng, (1, 183, 6), False), torch.bfloat16)
    b = _tensor(_levels(rng, (1, 32, 6), False), torch.bfloat16)
    got = emulate_time_select(a, b, K93, 183, 0.3, run=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.tap_median_time_plain(a, b, K93, 183, 0.3))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k,tile", [(13, None), (47, 5), (187, 64), (401, 256)])
def test_freq_select_emulation_matches_twin(k, tile, mode, ties):
    """Every boundary mode, ragged last tiles (517 outputs a row), the
    wrapper's tile and forced ones."""
    rng = np.random.default_rng(k + (tile or 0))
    f_in = 517 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (3, f_in), ties), torch.float32)
    got = emulate_freq_select(x, k, mode, tile)
    assert got.shape == (3, 517)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("mode", ["wrap", "edge", "reflect"])
@pytest.mark.parametrize("k,f", [(33, 5), (65, 7), (127, 64), (1001, 64), (WRAP_LIMIT, 64)])
def test_freq_select_emulation_stages_the_row_past_f(k, f, mode):
    """K past F (wrap and edge; reflect up to 2F - 1, its reach): a block
    stages the row's F samples, each counted as often as the border
    repeats it in the window (_row_count), up to K2's limit, where a
    window would otherwise stage 2,096,129 positions of 64 samples."""
    if mode == "reflect":
        k = min(k, 2 * f - 1)
    rng = np.random.default_rng(k + f)
    x = _tensor(_levels(rng, (2, f), ties=True), torch.float32)
    tile = mc.freq_select_plan(k, 2, f, mode)[0]
    assert tile + k - 1 > f  # the whole row, weighted
    got = emulate_freq_select(x, k, mode)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("k,mode", [(65, "wrap"), (187, "reflect"), (241, "edge"), (187, "wrap")])
def test_freq_select_emulation_matches_jax(k, mode):
    """Against zen_tpu's median, K past the row (120) under wrap and edge."""
    rng = np.random.default_rng(3 * k)
    x = _levels(rng, (2, 120), ties=True)
    m = (k - 1) // 2
    boundary = {"edge": "clamp"}.get(mode, mode)
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = emulate_freq_select(_tensor(x, torch.float32), k, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,mode", [(13, "valid"), (187, "reflect"), (129, "wrap")])
def test_freq_select_emulation_bf16(k, mode):
    rng = np.random.default_rng(6)
    f_in = 100 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties=False), torch.bfloat16)
    got = emulate_freq_select(x, k, mode)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


def _signed(rng, shape, dtype) -> torch.Tensor:
    """-0.0, +0.0, +-1, +inf and a positive NaN in equal shares, in
    ``dtype`` (bf16 from the float32 bits' upper half: torch's float32 to
    bf16 conversion turns NaN into a negative NaN, which the kernels'
    order puts below -inf and torch.kthvalue above +inf)."""
    levels = np.array([-0.0, 0.0, 1.0, -1.0, np.inf, np.nan], np.float32)
    x = rng.choice(levels, size=shape)
    if dtype == torch.float32:
        return torch.from_numpy(x)
    return torch.from_numpy((x.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def _same_but_zero_sign(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bitwise where the twin's value is not a zero; equal (a zero of
    either sign) where it is: the kernels order -0.0 below +0.0, the
    twins' torch.kthvalue does not tell them apart."""
    g, w = got.float(), want.float()
    assert torch.equal(g.isnan(), w.isnan())
    assert bool(((g == w) | g.isnan()).all())
    bitwise = w != 0
    assert torch.equal(g[bitwise], w[bitwise])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_orders_signed_zeros_inf_and_nan_as_the_sort(dtype):
    """-0.0 < +0.0 < +inf < NaN (and -inf, -NaN below), as the rank
    routes' keys order them: the select emulation equals the rank
    emulation bitwise on K1 and K2, and the twins but for a zero's sign."""
    rng = np.random.default_rng(31)
    a, b = _signed(rng, (2, 183, 5), dtype), _signed(rng, (2, 9, 5), dtype)
    got = emulate_time_select(a, b, K93, 183, run=4)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       emulate_time_rank(a, b, K93, 183).view(
                           torch.int16 if dtype == torch.bfloat16 else torch.int32))
    _same_but_zero_sign(got, mc.tap_median_time_plain(a, b, K93, 183))
    x = _signed(rng, (3, 301), dtype)
    for k, mode in ((47, "reflect"), (401, "wrap"), (33, "valid")):
        got = emulate_freq_select(x, k, mode)
        want = emulate_freq_rank(x, k, mode)
        ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(ints), want.view(ints))
        _same_but_zero_sign(got, mc.sliding_median_boundary_plain(x, k, mode))


# ---------------- the host side ----------------


def test_time_rank_table_counts_each_offset_between_zero_pads():
    lo, span, table = mc.time_rank_table((-3, 0, 0, -1, 0))
    pad = mc.TIME_RANK_RUN - 1
    assert (lo, span, len(table)) == (-3, 4, 4 + 2 * pad)
    assert table[pad : pad + 4] == (1, 0, 1, 3)
    assert sum(table) == 5 and not any(table[:pad]) and not any(table[pad + 4 :])


def test_time_rank_rows_are_the_taps_of_the_run():
    assert mc.time_rank_rows(K93, 1) == tuple(o + 183 for o in K93)
    rows = mc.time_rank_rows(K93, 32)
    assert len(rows) == 155 and rows == tuple(sorted(rows))
    assert rows == tuple(sorted({o + 183 + i for o in K93 for i in range(32)}))
    assert mc.time_rank_rows(tuple(range(-200, 201)), 32) == tuple(range(432))
    assert mc.time_rank_rows((-3, 0, 0, 0, 0), 2) == (0, 1, 3, 4)


def _launch_rank_bytes(offsets, run):
    """(bytes, table in shared memory) of launch_rank (csrc/median_time.cu),
    from the source's own arithmetic: key_count(staged) keys of 8 bytes,
    and the span + 2 (kRun - 1) table ints beside them where both fit
    227 KB. The wrapper reckons the keys (``time_rank_keys``)."""
    staged = len(mc.time_rank_rows(offsets, run))
    keys = 8 * max(32, 1 << (staged - 1).bit_length())
    assert mc.time_rank_keys(offsets, run) == keys
    table = 4 * (mc.time_rank_table(offsets)[1] + 2 * 31)
    return (keys + table, True) if keys + table <= 232_448 else (keys, False)


def test_time_routes_and_staging_limit():
    """The network up to 63 taps, the rank route from 65 at any span and
    every tap count: its reckoning of a block's shared memory is
    launch_rank's, the table leaves shared memory where it no longer fits
    beside the keys, the run shrinks, down to one row, where the keys do
    not fit, and past one row's keys the sort cannot take the call (the
    select route does)."""
    assert mc.time_route(tuple(range(-62, 1))) == "register"
    assert mc.time_route(tuple(range(-64, 1))) == "rank"
    assert mc.time_route(tuple(range(-12286, 1))) == "rank"
    for far in ((-16352,) + tuple(range(-65, 1)), (-16353,) + tuple(range(-65, 1)),
                (-70000,) + tuple(range(-65, 1)), (-(1 << 30),) + tuple(range(-65, 1))):
        assert mc.time_route(far) == "rank"
    # the keys of a run of 32 and a table of 16,416 ints: 67,712 bytes
    far = (-16353,) + tuple(range(-65, 1))
    assert mc.time_rank_run(far) == 32
    assert _launch_rank_bytes(far, 32) == (67_712, True)
    # past a span of about 57,000 rows the table stays in device memory
    far = (-70000,) + tuple(range(-65, 1))
    assert _launch_rank_bytes(far, 32) == (2048, False)
    # a call clamps the taps that read only fill next to V: on 300 rows the
    # far tap lands at row -300, and the table is 363 ints
    near = mc.time_rank_offsets(far, 0, 300)
    assert near == (-300,) + tuple(range(-65, 1))
    assert _launch_rank_bytes(near, 32) == (3500, True)
    # runs shrink while the keys do not fit: 601 taps 40 apart stage 19,232
    # rows at 32 (32,768 keys), 9,616 at 16 (16,384 keys and the table)
    spread = tuple(range(-24000, 1, 40))
    assert len(mc.time_rank_rows(spread, 32)) == 19_232
    assert mc.time_rank_keys(spread, 32) > mc.SMEM_OPTIN
    assert mc.time_rank_run(spread) == 16
    assert _launch_rank_bytes(spread, 16)[0] <= mc.SMEM_OPTIN
    assert mc.time_rank_plan(spread, 24000, 24040)[1:] == (16, True)
    # 192 kHz hop 1 (12,801 taps in two runs): a run of 32 stages 12,863
    # rows, 16,384 keys beside a table in device memory
    assert mc.time_rank_run(K12801) == 32
    assert _launch_rank_bytes(K12801, 32) == (131_072, False)
    assert mc.time_rank_plan(K12801, 25599, 25631)[1:] == (32, True)
    # 384 kHz hop 1 (25,601 taps): one row stages 25,601, 32,768 keys: only
    # the select route takes it
    assert mc.time_rank_run(K25601) == 1
    assert mc.time_rank_plan(K25601, 51199, 51231)[1:] == (1, False)
    assert mc.time_call_route(K25601, 51199, 51231, 1, 3) == "select"
    # K1's widest tap set, scattered: one row a block, its distinct taps,
    # 2^21 keys for a sort; the select route reads its order bits through L2
    widest = tuple(range(-3 * (mc.MAX_TIME_TAPS - 1), 1, 3))
    assert len(widest) == mc.MAX_TIME_TAPS and mc.time_rank_run(widest) == 1
    assert mc.time_rank_keys(widest, 1) == mc.KEY_BYTES * mc.RANK_STORE_MAX_KEYS
    assert mc.time_rank_plan(widest, 0, 3 * mc.MAX_TIME_TAPS)[1:] == (1, False)
    assert mc.time_select_plan(widest, 0, 3 * mc.MAX_TIME_TAPS, 1, 1)[1:] == (
        1, mc.MAX_TIME_TAPS, mc.SELECT_MAX_THREADS)
    assert 4 * mc.MAX_TIME_TAPS > mc.SELECT_SHARED_BYTES
    # the steps keep merge_sort's layout (a key's room after every 8) and
    # the rank of each relative row (span + run - 1 ints): median2d's fl 93
    # at a run of 352 stages 444 rows (512 keys, 4,608 in merge_sort's room)
    fl93 = tuple(range(-92, 1))
    assert mc.time_rank_bytes(fl93, 352, 1) == 8 * 512
    # 128 threads merge 512 keys a run each: one buffer; 16 threads a
    # column (8 columns) merge 256 keys two runs each: a second buffer
    assert mc.time_rank_bytes(fl93, 352, 11) == 9 * 512 + 4 * (93 + 351) + 4 * 352
    # four adjacent columns: each its own keys and ranks, the medians of all
    assert mc.time_rank_bytes(fl93, 160, 5, 4) == 4 * (9 * 256 + 4 * (93 + 159)) + 4 * 640
    assert mc.time_rank_bytes(fl93, 160, 9, 8) == 8 * (2 * 9 * 256 + 4 * (93 + 159)) + 4 * 1280
    # a span of 70,001 rows: no inverse fits beside the keys, so the call
    # keeps the walk from rank 0 at every lane run
    assert mc.time_rank_bytes(far, 96, 3) > mc.SMEM_OPTIN
    assert mc.time_rank_geometry(far, 70_000, 70_300, 1, 9)[1] == 1
    for offsets, start, t_v, streams, f in ((K93, 183, 215, 1, 65), (fl93, 92, 41_447, 1, 513),
                                            (spread, 24_000, 24_040, 1, 2)):
        run, lane_run, cols = mc.time_rank_geometry(offsets, start, t_v, streams, f)
        assert lane_run in mc.RANK_LANE_RUNS and run <= t_v - start
        assert cols in mc.TIME_RANK_COLUMNS and (cols == 1 or lane_run > 1)
        assert run <= (mc.TIME_RANK_RUN if lane_run == 1 else
                       mc.TIME_RANK_THREADS // cols * lane_run)
        planned = mc.time_rank_offsets(offsets, start, t_v)
        assert mc.time_rank_bytes(planned, run, lane_run, cols) <= mc.SMEM_OPTIN


def test_freq_route_crossover_and_staging_limit():
    """K2 runs its network up to FREQ_NETWORK_MAX_TAPS below
    FREQ_RANK_MIN_TAPS and ranks from the crossover on, at every K up to
    MAX_FREQ_TAPS: in shared memory up to the widest K whose keys fit at
    the smallest tile, on the key store beyond, where a unit of
    RANK_STORE_THREADS outputs at MAX_FREQ_TAPS fills a whole slice."""
    k_star = mc.FREQ_RANK_MIN_TAPS
    assert k_star % 2 == 1 and 1 < k_star <= mc.FREQ_NETWORK_MAX_TAPS + 2
    for k in range(1, k_star, 2):
        assert mc.freq_route(k) == "network"
    widest = mc.SMEM_OPTIN // mc.KEY_BYTES  # keys of one block
    last = max(k for k in range(16001, 16400, 2) if mc.freq_rank_tile(k))
    assert last == 16_353
    assert mc._pow2_at_least(mc.freq_rank_tile(last) + last - 1) <= widest
    for k in (k_star, 47, 187, 257, last):
        assert (mc.freq_route(k), mc.freq_rank_store(k)) == ("rank", "shared")
    for k in (last + 2, 57_857, 65_537, mc.MAX_FREQ_TAPS):
        assert (mc.freq_route(k), mc.freq_rank_store(k)) == ("rank", "scratch")
    assert mc._key_count(mc.RANK_STORE_THREADS + mc.MAX_FREQ_TAPS - 1) == mc.RANK_STORE_MAX_KEYS
    assert mc.MAX_FREQ_TAPS % 2 == 1 and mc.MAX_TIME_TAPS % 2 == 1
    assert min(mc.MAX_FREQ_TAPS, mc.MAX_TIME_TAPS) > 1 << 20


# the rows whose outputs are too few to share a sort (they lost to
# torch.kthvalue on the key store or the shared sort) and the paths' rank
# rows, as benches/rank_store.py times them: K1 (offsets, start, t_v,
# streams, f), K2 (k, rows, f_in, mode)
SELECT_ROWS = [
    ("time", (K12801, 25_599, 25_631, 1, 3)),  # 192 kHz hop 1, B=32
    ("freq", (mc.MAX_FREQ_TAPS, 2, 64, "wrap")),
    ("time", (tuple(range(-20_000, 1)), 0, 20_100, 1, 9)),
    ("time", (K25601, 51_199, 51_200, 1, 3)),  # 384 kHz hop 1, B=1
    ("freq", (57_857, 1, 58_112, "valid")),
    ("time", (K25601, 51_199, 51_231, 1, 3)),  # B=32
    ("freq", (65_537, 2, 65_792, "valid")),
]
SORT_ROWS = [
    ("freq", (47, 32, 2049, "reflect")),  # hop 1024
    ("freq", (187, 8, 8193, "reflect")),  # pitch-track
    ("time", (K93, 183, 215, 1, 65)),  # hop 32, B=32
    ("time", (K93, 183, 184, 1, 65)),  # hop 32, B=1
    ("freq", (187, 41, 8193, "reflect")),  # offline pass 1
    ("freq", (187, 2585, 8193, "reflect")),  # the 4-minute track's pass 1
    ("time", (tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513)),  # median2d fl 93
    ("freq", (187, 2585, 8193, "wrap")),  # median2d fl 187
    ("freq", (16_385, 4, 8193, "reflect")),  # K2's store: 8193 outputs a row
    ("freq", (257, 32, 2049, "reflect")),  # fs 8000 hop 1024
]


def _pick(kind, args):
    return (mc.time_call_route if kind == "time" else mc.freq_call_route)(*args)


@pytest.mark.parametrize("kind,args", SELECT_ROWS)
def test_cost_rule_takes_few_output_rows_to_select(kind, args):
    """The seven rows take the select route on an H100's 132 SMs (on the
    card each ran 1.7-1500x under its torch.kthvalue: PERF.md), their
    blocks an output, or a run of 32 where 180,900 outputs fill the card."""
    assert _pick(kind, args) == "select"
    if kind == "time":
        _, run, staged, threads = mc.time_select_plan(*args)
        t_out, f = args[2] - args[1], args[4]
        assert run == (32 if t_out * f > 32 * mc.H100_SMS else 1)
    else:
        tile, staged, threads = mc.freq_select_plan(*args)
        assert tile == 1 and staged == min(args[0], args[2])
    assert threads == mc.select_threads(staged)


@pytest.mark.parametrize("kind,args", SORT_ROWS)
def test_cost_rule_keeps_shared_sorts(kind, args):
    """The paths' rank rows and K2's store row keep the sort, which the
    card measured 4-80x faster than select on each (chip_smoke phase 3)."""
    assert _pick(kind, args) == "rank"
    sort, pick = (mc.time_route_costs if kind == "time" else mc.freq_route_costs)(*args)
    assert sort < pick


def test_select_geometry_and_layout():
    """A select block: power-of-two threads, about 16 staged samples each,
    64 to 1024; its order bits and bins in shared memory where both fit
    (the bins only at 1024 threads), else the bits, else the bins."""
    assert [mc.select_threads(s) for s in (1, 64, 93, 1000, 12_801, 70_001)] == [
        64, 64, 64, 64, 1024, 1024]
    assert mc.select_shared_bins(1024) and not mc.select_shared_bins(64)
    assert mc.select_layout(25_601, 1024) == (True, True, 4 * 25_601 + 64 * 1024)
    assert mc.select_layout(57_857, 1024) == (True, False, 4 * 57_857)
    assert mc.select_layout(65_537, 1024) == (False, True, 64 * 1024)
    assert mc.select_layout(442, 64, False) == (True, False, 4 * 442)
    # K1's runs halve until the call fills the SMs; K2's tiles too, and
    # the grid's second dimension caps them from below
    assert mc.time_select_plan(K93, 183, 215, 1, 65)[1] == 8
    assert mc.freq_select_plan(47, 1, 2049, "reflect")[0] == 8  # 257 blocks; 16: 129
    assert mc.freq_select_plan(13, 1, 10_000_000, "reflect")[0] == 256
    # a run of one over distinct taps counts each staged row once
    assert mc.time_select_unit(K25601, 1) and not mc.time_select_unit(K25601, 2)
    assert not mc.time_select_unit((0, 0, -1), 1)


@pytest.mark.parametrize("k", [3, 13, 47, 187, 257, 401, 4001])
def test_freq_rank_tile_minimizes_walk_plus_sort(k):
    """freq_rank_tile (the copy mirror's tile, and whether a tile's keys
    fit at all) minimizes the walk from rank 0 plus the sort per output;
    freq_rank_plan, a call's geometry, minimizes sort_us over every tile
    and run that fits a block: at run 1 that tile, past
    it runs of RANK_LANE_RUNS outputs, as many walking threads as a key
    count's freq_steps_threads and its staged outputs allow, the block's
    threads freq_rank_threads'."""
    tile = mc.freq_rank_tile(k)
    assert tile in mc.FREQ_RANK_TILES

    def cost(t):
        n = mc._pow2_at_least(t + k - 1)
        lg = n.bit_length() - 1
        return (t + k - 1) / 2 + (n // 2) * lg * (lg + 1) / t

    assert cost(tile) == min(cost(t) for t in mc.FREQ_RANK_TILES)
    for rows, f_in in ((8, 8193), (32, 2049), (2585, 8193)):
        plans = mc._freq_rank_plans(k, rows, f_in, "reflect", mc.H100_SMS)
        assert mc.freq_rank_plan(k, rows, f_in, "reflect") == min(plans)[1:]
        for us, t, run in plans:
            threads = mc.freq_rank_threads(k, t, run)
            assert t % run == 0 and t // run <= threads
            assert (threads == t == tile if run == 1 else
                    threads == mc.freq_steps_threads(mc._key_count(t + k - 1)))
            assert t + k - 1 <= mc._key_count(t + k - 1)
            assert run in mc.RANK_LANE_RUNS and mc.freq_rank_bytes(k, t, run) <= mc.SMEM_OPTIN
            seg = min(t, f_in) + k - 1
            assert us == mc.sort_us(rows * -(-f_in // t), seg, threads,
                                    mc.freq_rank_bytes(k, t, run), mc.H100_SMS, run=run,
                                    step=seg / k + 1)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh names another library, so a stale build is
    never reused."""
    for src in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "rank_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_split_builds_are_libraries_of_their_own():
    """ZEN_RANK_CUT 1 and 2 (chip_smoke's split of a rank block's time)
    name libraries beside the full one, never in its place."""
    paths = {_build.library_path(cut) for cut in (0, 1, 2)}
    assert len(paths) == 3 and _build.library_path() == _build.library_path(0)
    with pytest.raises(ValueError, match="ZEN_RANK_CUT"):
        _build.library(3)


def test_smoke_labels_the_steps_kernel():
    """chip_smoke.py's launch labels: the many-output rank calls (the
    offline passes 1, median2d's fl 93) take the steps kernel (STEPS), the
    streams' latency rows walk from rank 0; a STEPS or SCRATCH launch
    counts on its kernel's rank route too; ``by_route`` drops the STEPS
    keys, which a count from the configs alone does not hold."""
    import chip_smoke as cs

    sms = mc.H100_SMS
    assert cs.freq_call_label(187, 2585, 8193, "reflect", sms) == cs.STEPS
    assert cs.freq_call_label(187, 41, 8193, "reflect", sms) == cs.STEPS
    assert cs.freq_call_label(187, 2585, 8193, "wrap", sms) == cs.STEPS
    for rows in (1, 32):  # hop 1024's K2, B=1 and B=32
        assert cs.freq_call_label(47, rows, 2049, "reflect", sms) == "rank"
    assert cs.freq_call_label(187, 8, 8193, "reflect", sms) == "rank"  # pitch-track
    assert cs.freq_call_label(16_385, 4, 8193, "reflect", sms) == cs.SCRATCH
    # K2's network route: the 64-stream fleet's 2048 rows take its shared
    # core (FREQ_CORE), beat-track's 64 the per-output network
    assert cs.freq_call_label(13, 2048, 513, "reflect", sms) == cs.FREQ_CORE
    assert cs.freq_call_label(13, 64, 513, "reflect", sms) == "network"
    k93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # hop 32, B=32 and B=1
    assert cs.time_call_label(k93, 183, 183 + 32, 1, 65, sms) == "rank"
    assert cs.time_call_label(k93, 183, 183 + 1, 1, 65, sms) == "rank"
    assert cs.time_call_label(tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513, sms) == cs.STEPS
    # the clip's pass 2 takes K1's register route, in its shared-core form
    assert cs.time_call_label(tuple(range(-5, 6)), 0, 643, 1, 513, sms) == cs.CORE
    assert cs.launch_keys(f"tap_median_time/{cs.STEPS}") == (
        f"tap_median_time/{cs.STEPS}", "tap_median_time/rank")
    assert cs.launch_keys(f"sliding_median_boundary/{cs.SCRATCH}")[1] == (
        "sliding_median_boundary/rank")
    assert cs.launch_keys("sliding_median_boundary/network") == ("sliding_median_boundary/network",)
    counts = {"tap_median_time/rank": 2, f"tap_median_time/{cs.STEPS}": 1,
              f"sliding_median_boundary/{cs.SCRATCH}": 3}
    assert cs.by_route(counts) == {"tap_median_time/rank": 2,
                                   f"sliding_median_boundary/{cs.SCRATCH}": 3}
