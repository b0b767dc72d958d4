"""The wide median routes' block algorithms emulated in torch, shared
by the CPU tests of each route (test_torch_rank_walk.py, the walk and
the steps; test_torch_rank_store.py, the key store; test_torch_select_
time.py and test_torch_select_freq_*.py, the select route;
test_torch_rank_rules.py, the host side), and the fixture that runs
those files' tests, and the networks' (test_torch_select_network.py,
test_torch_freq_core_wide.py, test_torch_warp.py), on one torch thread.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), so
their block algorithm is emulated here, step for step, from the same
host-side choices the wrappers hand the kernels (K2's tile, K1's
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
holds the remaining rank and the prefix it extends. The tests hold every
emulation BITWISE against the plain twins and zen_tpu's median, which
pick sorted[(K-1)/2]; inputs include tie-heavy ones quantized to 8
levels, bf16, and (for the select route, against the sort's order) -0.0,
+0.0, +inf and NaN.
"""
import numpy as np
import pytest
import torch

from zen_tpu_torch.ops import median_cuda as mc


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test of a file that imports this fixture runs torch on one
    intra-op thread, the count restored after: the emulations issue
    thousands of small ops, and where the suite's workers share the CPU
    cores each op's parallel region waits on descheduled threads (with six
    workers on eight cores, a case that takes 0.4 s alone took up to 170
    s). The ops are exact (integer arithmetic, min, max, selection), so
    the thread count changes no bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32, wrap
# HPRConfig(fs, hop=1)'s causal time taps (the wrap border): two tap runs
K12801 = tuple(range(-25599, -19199)) + tuple(range(-6400, 1))  # 192 kHz
K25601 = tuple(range(-51199, -38399)) + tuple(range(-12800, 1))  # 384 kHz
WRAP_LIMIT = mc.MAX_FREQ_TAPS  # K2's widest K


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


K_PAD = 2**64 - 1  # the kernels' kPadKey
SORT_POSITIONS = 1 << 19  # rank_select.cuh's kSortPositions


def merge_passes(src: list, length: int) -> list:
    """rank_select.cuh's merge_passes: sorted runs of ``length`` keys in
    ``src`` merged pairwise, pass by pass, MERGE_RUN outputs a thread from
    the binary search of their merge path on (merge_at; a run's end reads
    as kPadKey, the first run first on ties), to one sorted run, in plain
    order (merge_index's padding is only a layout)."""
    n, r = len(src), mc.MERGE_RUN
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
            a = a_run[i] if i < length else K_PAD
            b = b_run[j] if j < length else K_PAD
            for u in range(r):
                take_a = a <= b
                dst[e0 + u] = a if take_a else b
                i, j = (i + 1, j) if take_a else (i, j + 1)
                nxt = i if take_a else j
                loaded = (a_run if take_a else b_run)[nxt] if nxt < length else K_PAD
                a, b = (loaded, b) if take_a else (a, loaded)
        src, length = dst, 2 * length
    return src


def kernel_keys(values: torch.Tensor) -> np.ndarray:
    """The kernels' 64-bit keys (make_key) of staged values [..., S] at
    positions 0 .. S - 1, as uint64."""
    bits = _order_bits(values).numpy().astype(np.uint64)
    return (bits << np.uint64(32)) | np.arange(values.shape[-1], dtype=np.uint64)


def sort_form(keys: np.ndarray) -> np.ndarray:
    """rank_select.cuh's sort_form: uint64 keys as the float64 values
    whose bits are exponent 1 over the key's order bits and its position's
    low 20 bits (numpy reads the bit patterns as doubles, as the kernel's
    __hiloint2double does)."""
    keys = keys.astype(np.uint64)
    order = keys >> np.uint64(32)
    bits = (np.uint64(1) << np.uint64(52)) | (order << np.uint64(20)) | (keys & np.uint64(0xFFFFF))
    return bits.view(np.float64)


def key_form(doubles: np.ndarray) -> np.ndarray:
    """rank_select.cuh's key_form: the keys back from sort_form's doubles,
    the 20 position bits sign-extended (the padding's 2^20 - 1 to all
    ones)."""
    bits = np.ascontiguousarray(doubles).view(np.uint64)
    order = (bits >> np.uint64(20)) & np.uint64(0xFFFFFFFF)
    pos = bits & np.uint64(0xFFFFF)
    pos = np.where(pos >= np.uint64(SORT_POSITIONS), pos | np.uint64(0xFFFFFFFFFFF00000), pos)
    return (order << np.uint64(32)) | (pos & np.uint64(0xFFFFFFFF))


def warp_bitonic(v: np.ndarray) -> np.ndarray:
    """rank_select.cuh's key_bitonic on [..., 32, R] doubles, lane by
    lane and slot by slot, element e = lane * R + j in slot j of its lane:
    for each size 2 .. 32 R the flip (e meets e ^ (size - 1)), then the
    half-cleaners (e meets e ^ stride), the lower element keeping the min
    (np.minimum and np.maximum, DMNMX's min and max of normal doubles);
    across lanes from stride R up, the partner's slot (mirrored in the
    flip) as __shfl_xor_sync hands it over."""
    r = v.shape[-1]
    lane = np.arange(32)[:, None]
    size = 2
    while size <= 32 * r:
        stride = size // 2
        while stride >= 1:
            flip = stride == size // 2
            if stride >= r:
                partner = v[..., lane[:, 0] ^ (((size - 1) if flip else stride) // r), :]
                if flip:
                    partner = partner[..., ::-1]
                low = (lane & (stride // r)) == 0
                v = np.where(low, np.minimum(v, partner), np.maximum(v, partner))
            else:
                v = v.copy()
                for j in range(r):
                    p = j ^ (size - 1) if flip else j ^ stride
                    if j < p:
                        lo, hi = np.minimum(v[..., j], v[..., p]), np.maximum(v[..., j], v[..., p])
                        v[..., j], v[..., p] = lo, hi
            stride //= 2
        size *= 2
    return v


def parked(q: np.ndarray, j) -> np.ndarray:
    """rank_select.cuh's parked: where element j of lane q's run waits."""
    r = mc.WARP_LANE_KEYS
    return q * r + (j ^ ((q >> 1) & (r - 1)))


def warp_sort_slice(keys: np.ndarray) -> np.ndarray:
    """warp_load_sort, then warp_store_plain, on each buffer of n uint64
    keys [..., n] (n a power of two, 32 to WARP_SORT_KEYS): key e = j * 32
    + lane into slot j of WARP_LANE_KEYS (kPadKey past n); the bitonic
    network on sort_form's doubles; each lane's run parked, read back as
    keys j * 32 + lane and written plainly, through one buffer as the
    kernel does in place."""
    n = keys.shape[-1]
    r = mc.WARP_LANE_KEYS
    lanes = np.full(keys.shape[:-1] + (32, r), K_PAD, dtype=np.uint64)
    e = np.arange(r)[None, :] * 32 + np.arange(32)[:, None]  # [lane, slot]
    lanes[..., e < n] = keys[..., e[e < n]]
    v = key_form(warp_bitonic(sort_form(lanes)))
    buf = np.zeros_like(keys)
    q = np.arange(32)[:, None]
    real = np.broadcast_to(q * r < n, (32, r))  # a lane's run all below n or all padding
    buf[..., parked(q, np.arange(r)[None, :])[real]] = v[..., real]
    e = np.arange(n)
    return buf[..., parked(e // r, e % r)]


def warp_merge_sort(keys: np.ndarray, count: int) -> np.ndarray:
    """rank_select.cuh's warp_merge_sort of one block's n uint64 keys (n a
    power of two >= 32) by ``count`` threads (a K2 block's, or a K1
    column's group of 16 to 128): up to WARP_SORT_KEYS keys one
    slice (warp_sort_slice); past it each slice of WARP_SORT_KEYS sorted
    in registers, then merged pass by pass from runs of WARP_SORT_KEYS
    (merge_at, a run's end read as kPadKey: in registers where each thread
    takes one merge run, else through the second buffer, merge_passes; the
    same merges either way)."""
    n = keys.shape[-1]
    assert mc._sort_rooms(n, count) == (
        2 if n > mc.WARP_SORT_KEYS and count * mc.MERGE_RUN < n else 1)
    if n <= mc.WARP_SORT_KEYS:
        return warp_sort_slice(keys)
    slices = keys.reshape(n // mc.WARP_SORT_KEYS, mc.WARP_LANE_KEYS, 32).transpose(0, 2, 1)
    # slice s: key e = j * 32 + lane of the slice in slot j of lane `lane`
    runs = key_form(warp_bitonic(sort_form(slices))).reshape(-1)
    return np.array(merge_passes([int(k) for k in runs], mc.WARP_SORT_KEYS), dtype=np.uint64)


def steps_sort(keys: np.ndarray, count: int) -> np.ndarray:
    """The rank steps' sort (warp_merge_sort) of blocks of the kernels'
    uint64 keys [B, n], n a power of two >= 32, by ``count`` threads a
    block, as the kernel runs it (one vectorized slice up to
    WARP_SORT_KEYS)."""
    if keys.shape[-1] <= mc.WARP_SORT_KEYS:
        return warp_sort_slice(keys)
    return np.stack([warp_merge_sort(row, count) for row in keys])


def _sorted_positions(values: torch.Tensor, chunk: int | None = None, steps: bool = False,
                      count: int = 32) -> tuple:
    """Staged values [..., S] sorted by (value, position), as the kernels'
    sort of their keys leaves them: (values, positions). ``chunk``: the
    key store's sort, of the keys padded to key_count(S) as the kernels
    pad them; ``steps``: the rank steps' sort by ``count`` threads a block
    (``steps_sort``), on the kernels' own keys padded so; neither: the
    shared store's (an ascending sort, emulated by torch.sort)."""
    s = values.shape[-1]
    if steps:
        n = mc._key_count(s)
        keys = kernel_keys(values.reshape(-1, s).float())
        keys = np.concatenate([keys, np.full((keys.shape[0], n - s), K_PAD, np.uint64)], -1)
        ranked = steps_sort(keys, count)[:, :s] & np.uint64(0xFFFFFFFF)
        p = torch.from_numpy(ranked.astype(np.int64)).reshape(values.shape)
        return torch.gather(values, -1, p), p
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
                      tile: int | None = None, run: int | None = None,
                      warp_sort: bool = False) -> torch.Tensor:
    """K2's rank kernel: a block per (row, tile), each staging the
    tile + K - 1 samples its outputs reach, the last tile ragged; the
    wrapper's ``freq_rank_plan`` for the call on an H100's SMs, or
    ``tile`` and ``run`` as ``_freq_launch`` forces them. Run 1: every
    output walks from rank 0 (``_walk``); a longer run: the steps
    (``emulate_freq_steps``). On the key store (where ``freq_rank_store``
    sends K, or at ``chunk`` keys of shared memory, as
    ``_freq_launch(chunk=)``) a unit is RANK_STORE_THREADS outputs and its
    keys take the store's sort. ``warp_sort``: the steps' keys go through
    their sort's emulation (``steps_sort``) by the block's threads
    (``freq_rank_threads``), not torch.sort."""
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
        values, pos = _sorted_positions(seg, chunk, warp_sort and run > 1,
                                        mc.freq_rank_threads(k, tile, run))  # [R, S]
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


def emulate_time_rank(a, b, offsets, start, fill=0.0, run=None, lane_run=None,
                      warp_sort: bool = False, cols: int = 1) -> torch.Tensor:
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
    (``emulate_time_steps``), whose keys go through their sort's emulation
    (``steps_sort``) by a column's threads of ``cols`` a block where
    ``warp_sort``, not torch.sort."""
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
        values, idx = _sorted_positions(staged.transpose(1, 2), None, warp_sort and lane_run > 1,
                                        mc.TIME_RANK_THREADS // cols)  # [C, F, S]
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


def check_freq_select_twin(k, tile, mode, ties):
    """The select route's emulation at width ``k`` (``tile`` outputs a
    block, the wrapper's where None) under border ``mode``, bitwise to the
    twin on three rows of 517 outputs (ragged last tiles); the body of
    test_torch_select_freq_*.py's test_freq_select_emulation_matches_twin,
    one border a file."""
    rng = np.random.default_rng(k + (tile or 0))
    f_in = 517 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (3, f_in), ties), torch.float32)
    got = emulate_freq_select(x, k, mode, tile)
    assert got.shape == (3, 517)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))
