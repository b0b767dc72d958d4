"""The select route (csrc/radix_select.cuh, a radix select an output)
emulated on the CPU: the weighted order statistic itself, K1's column
blocks (``rank_emulation.emulate_time_select``) at the hop-1 rows and
bf16, and the order it gives -0.0, +0.0, +inf and NaN; bitwise to the
plain twins and zen_tpu's median. K2's rows are in
test_torch_select_freq_*.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    K12801,
    K25601,
    K93,
    _levels,
    _same_but_zero_sign,
    _signed,
    _tensor,
    emulate_freq_rank,
    emulate_freq_select,
    emulate_select,
    emulate_time_rank,
    emulate_time_select,
)


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
