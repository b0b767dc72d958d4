"""The rank route's two kernels, the walk from rank 0 and the steps from a
neighbour's median, emulated on the CPU (``rank_emulation``: K2's segment
and K1's column tile sorted once per block, each output's rank walked or
stepped), held bitwise against the plain twins and zen_tpu's median,
tie-heavy and bf16; the steps' sort and K1's change points of the steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    K93,
    K_PAD,
    _levels,
    _tensor,
    emulate_freq_rank,
    emulate_time_rank,
    warp_merge_sort,
)


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


@pytest.mark.parametrize("count", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [32, 256, 512, 1024])
def test_merge_sort_orders_every_block(n, count):
    """The steps' sort (warp_merge_sort: warp slices, then merge passes
    past one) orders a block's keys, pad keys (equal) and ties of value
    included, by ``count`` threads (a K1 column's group of 16 up to a K2
    block's), with one merge run a thread (its passes in registers) and
    with several (a second buffer)."""
    rng = np.random.default_rng(n + count)
    order = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64)
    order[1] %= np.uint64(7)
    keys = (order << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    keys[0, -n // 8 :] = K_PAD
    keys[2, ::3] = K_PAD
    for row in keys:
        assert np.array_equal(warp_merge_sort(row, count), np.sort(row))
