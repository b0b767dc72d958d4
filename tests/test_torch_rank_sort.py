"""The rank steps' warp sort (csrc/rank_select.cuh: warp_merge_sort)
emulated as the kernel runs it (``rank_emulation``: lanes of register
runs, the bitonic network's flips and half-cleaners with their shuffle
partners, the keys as sort_form's doubles, each lane's run parked and
read back plainly, the slices' merge passes past one warp's keys), on the
kernels' own 64-bit keys: it sorts at every key count it takes, it leaves
the steps' medians bitwise those of a plain sort and of zen_tpu's sliding
median, and the cost rule picks what the card measured.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    K_PAD,
    SORT_POSITIONS,
    _levels,
    _tensor,
    emulate_freq_rank,
    emulate_time_rank,
    kernel_keys,
    key_form,
    parked,
    sort_form,
    steps_sort,
    warp_merge_sort,
)


def _block_keys(rng, n: int, bf16: bool) -> np.ndarray:
    """A block's n kernel keys: staged values of both signs with ties of
    value (8 levels, distinct positions), -0.0 beside +0.0 and infinities,
    optionally rounded to bf16, then padding up to n (a quarter of it)."""
    staged = n - n // 4
    x = (np.floor(rng.random(staged, dtype=np.float32) * 8) - 4) / 4
    special = np.array([-0.0, 0.0, -np.inf, np.inf], dtype=np.float32)
    x = np.where(rng.random(staged) < 0.15, special[rng.integers(0, 4, staged)], x)
    x = x.astype(np.float32) * np.float32(1.0 + 1.0 / 3.0)  # leaves bf16's grid
    values = torch.from_numpy(x)
    if bf16:
        values = values.to(torch.bfloat16).float()
    keys = kernel_keys(values)
    return np.concatenate([keys, np.full(n - staged, K_PAD, np.uint64)])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [1 << e for e in range(5, 15)])
def test_warp_sort_sorts_every_key_count(n, bf16):
    """warp_merge_sort equals sorted() at every power-of-two key count
    from one warp's 32 to 16,384: one warp's slice of 8 keys a lane up to
    256, past it slices of 256 merged, whatever the block's warps."""
    rng = np.random.default_rng(n + bf16)
    keys = _block_keys(rng, n, bf16)
    want = np.array(sorted(int(k) for k in keys), dtype=np.uint64)
    for count in ((32,) if n <= mc.WARP_SORT_KEYS else (32, 256, 1024)):
        assert np.array_equal(warp_merge_sort(keys, count), want), count


def test_sort_form_orders_keys_as_normal_doubles():
    """sort_form maps the keys (positions below 2^19, and the padding) to
    normal doubles of exponent 1 in the keys' order, no NaN and no
    subnormal, and key_form brings each back whole."""
    rng = np.random.default_rng(7)
    order = rng.integers(0, 1 << 32, 4000, dtype=np.uint64)
    order[:8] = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF]
    pos = rng.integers(0, SORT_POSITIONS, 4000, dtype=np.uint64)
    pos[7] = SORT_POSITIONS - 1
    keys = np.concatenate([(order << np.uint64(32)) | pos, [np.uint64(K_PAD)]])
    doubles = sort_form(keys)
    assert np.all(np.isfinite(doubles)) and np.all(doubles >= np.finfo(np.float64).tiny)
    assert np.all(doubles.view(np.uint64) >> np.uint64(52) == 1)
    assert np.array_equal(key_form(doubles), keys)
    assert np.array_equal(np.argsort(doubles, kind="stable"), np.argsort(keys, kind="stable"))


def test_parked_layout_is_free_of_bank_conflicts():
    """warp_store_plain's parking: a bijection of a warp's 32 r slots, and
    each half-warp's 8-byte accesses (a lane's slot j written, keys j * 32
    + lane read) fall on 16 distinct bank pairs."""
    r = mc.WARP_LANE_KEYS
    lane = np.arange(32)
    spots = np.array([parked(lane, j) for j in range(r)])  # [j, lane]
    assert sorted(spots.reshape(-1).tolist()) == list(range(32 * r))
    for j in range(r):
        e = j * 32 + lane
        read = parked(e // r, e % r)
        assert np.array_equal(np.sort(read), np.sort(e))  # the keys j * 32 .. j * 32 + 31
        for half in (lane < 16, lane >= 16):
            assert len(set((spots[j][half] % 16).tolist())) == 16
            assert len(set((read[half] % 16).tolist())) == 16


@pytest.mark.parametrize("n", [64, 512, 2048])
def test_steps_sort_leaves_the_plain_sort(n):
    """Keys are distinct but for the padding, so the steps' sort of a
    batch of blocks leaves the array any ascending sort leaves (numpy's,
    and torch.sort's of the same keys as signed integers), whatever a
    block's threads."""
    rng = np.random.default_rng(n)
    keys = np.stack([_block_keys(rng, n, False) for _ in range(3)])
    want = np.sort(keys, axis=-1)
    flipped = torch.from_numpy((keys ^ np.uint64(1 << 63)).view(np.int64))
    assert np.array_equal(torch.sort(flipped, dim=-1).values.numpy().view(np.uint64)
                          ^ np.uint64(1 << 63), want)
    for count in (32, 64, 256):
        assert np.array_equal(steps_sort(keys, count), want), count


# K2's steps geometries: the 4-minute track's pass 1 (2585 rows of 8193)
# and median2d's fl 187 on it, the clip's pass 1 (41 rows) and
# pitch-track's 8 rows, as the rule plans them, run on short rows
K2_ROWS = {"track": 2585, "clip": 41, "pitch-track": 8}


@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("row", sorted(K2_ROWS))
def test_freq_steps_warp_sort_matches_jax(row, mode):
    """K2's steps emulated with their warp sort, at the rule's geometry for
    the row (its steps forced where the rule walks from rank 0): bitwise
    to the steps over torch.sort's order and to zen_tpu's sliding median,
    every border, tie-heavy."""
    k = 187
    tile, run = mc.freq_rank_plan(k, K2_ROWS[row], 8193, mode)
    if run == 1:
        tile, run = 160, 5
    rng = np.random.default_rng(K2_ROWS[row])
    f_in = 600 + (k - 1 if mode == "valid" else 0)  # ragged last tiles; one shape for JAX
    x = _levels(rng, (2, f_in), ties=True)
    if mode == "valid":
        want = np.asarray(jax_sliding_median(jnp.asarray(x), range(0, k), -1, "zero"))[
            :, : f_in - k + 1]
    else:
        m = (k - 1) // 2
        boundary = {"edge": "clamp"}.get(mode, mode)
        want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = {warp: emulate_freq_rank(_tensor(x, torch.float32), k, mode, tile=tile, run=run,
                                   warp_sort=warp).numpy() for warp in (True, False)}
    np.testing.assert_array_equal(got[True], got[False])
    np.testing.assert_array_equal(got[True], want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("border", ["valid", "zero", "inf"])
def test_time_steps_warp_sort_matches_jax(border, bf16):
    """K1's steps emulated with their warp sort at median2d's fl 93
    geometry (the rule's for the track's [41355, 513]): the causal valid
    taps, and centered taps past both ends reading 0 or +inf; bitwise to
    the steps over torch.sort's order, to the twin and (at fill 0) to
    zen_tpu's sliding median."""
    if border == "valid":
        offsets, start, fill = tuple(range(-92, 1)), 92, 0.0
    else:
        offsets, start, fill = tuple(range(-46, 47)), 0, (0.0 if border == "zero" else np.inf)
    run, lane_run, cols = mc.time_rank_geometry(tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513)
    rng = np.random.default_rng(93 + bf16)
    x = _levels(rng, (1, 300 + start, 3), ties=True)
    a = _tensor(x, torch.bfloat16 if bf16 else torch.float32)
    got = {warp: emulate_time_rank(a, a[:, :0], offsets, start, fill, run, lane_run,
                                   warp_sort=warp, cols=cols) for warp in (True, False)}
    assert torch.equal(got[True], got[False])
    assert torch.equal(got[True], mc.tap_median_time_plain(a, a[:, :0], offsets, start, fill))
    if fill == 0.0 and not bf16:
        want = np.asarray(jax_sliding_median(jnp.asarray(x), offsets, -2, "zero"))[:, start:]
        np.testing.assert_array_equal(got[True].numpy(), want)


def test_rule_picks_what_the_card_measured():
    """The refit cost rule (sort_us: SORT_WARP_US, SORT_STAGE_US,
    SM_FULL_RATE_THREADS) picks, of every rank geometry, the fastest that
    benches/rank_geometry.py measured on an H100 80GB HBM3 at 700 W: tile
    320 and runs of 5 on the 4-minute track's pass 1 and median2d's fl 187
    (693.28 and 747.84 us), tile 288 at runs of 3 on the clip's pass 1
    (21.95), the walk from rank 0 on pitch-track's 8 rows (13.18 against
    13.73 at the steps' best), and 8 columns of 144 rows at runs of 9 on
    median2d's fl 93 (811.30)."""
    for mode, f_in in (("reflect", 8193), ("wrap", 8193), ("edge", 8193), ("valid", 8193 + 186)):
        assert mc.freq_rank_plan(187, 2585, f_in, mode) == (320, 5)
    assert mc.freq_rank_plan(187, 41, 8193, "reflect") == (288, 3)
    assert mc.freq_rank_plan(187, 8, 8193, "reflect") == (64, 1)
    assert mc.time_rank_geometry(tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513) == (144, 9, 8)
    assert mc.freq_rank_threads(187, 320, 5) == 64 and mc.freq_rank_threads(187, 288, 3) == 96
