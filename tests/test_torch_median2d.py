"""The port's whole-matrix median filter (zen_tpu_torch.ops.median's
median2d and its twin median2d_plain) against zen_tpu's median2d and
the port's numpy model np_filter2d, BITWISE, on the CPU.

A median of an odd tap count is pure selection, so every comparison is
assert_array_equal. On CPU tensors median2d runs the mapping it runs on
the card (which wrapper, which taps, which rows) through the kernel
wrappers' plain twins; median2d_plain is sliding_median alone. The
card's kernels against these twins are in tests/test_torch_cuda.py.

The impulse cases are tests/test_ops.py's (the reference's
mfilt.test.cu): a matrix whose middle row is 5 and middle column 8.
Shapes repeat across tests so that zen_tpu's jit compiles once per shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from zen_tpu.ops import median as jm  # noqa: E402

from zen_tpu_torch import ZenError  # noqa: E402
from zen_tpu_torch.engine.oracle import np_filter2d  # noqa: E402
from zen_tpu_torch.ops import median as tm  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from zen_tpu_torch.ops.median import (  # noqa: E402
    BORDERS,
    DIRECTIONS,
    FREQUENCY,
    REPLICATE,
    TIME_ANTICAUSAL,
    TIME_CAUSAL,
    VALID,
    WRAP,
    median2d,
    median2d_plain,
)

SIZES = [(9, 9, 3), (10, 20, 5), (64, 17, 5)]  # tests/test_ops.py's impulse sizes


def marked_matrix(t, f):
    """Middle row = 5, middle column = 8 (mfilt.test.cu:31-39)."""
    x = np.zeros((t, f), np.float32)
    x[t // 2, :] = 5
    x[:, f // 2] = 8
    return x


def zen(x: np.ndarray, fl, direction, border) -> np.ndarray:
    """zen_tpu's median2d; bf16 when ``x`` holds bf16 values read as float32."""
    return np.asarray(jm.median2d(jnp.asarray(x), fl, direction, border))


def both(x: torch.Tensor, fl, direction, border) -> np.ndarray:
    """median2d and median2d_plain on ``x``, held bitwise to each other."""
    got = median2d(x, fl, direction, border)
    plain = median2d_plain(x, fl, direction, border)
    assert got.dtype == plain.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=False)
    return got.float().numpy()


# ---------------- the impulse patterns of mfilt.test.cu ----------------


@pytest.mark.parametrize("t,f,fl", SIZES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_valid_impulse_patterns(direction, t, f, fl):
    """'valid': the marked column survives in the written rows (causal
    i >= fl, mfilt.test.cu:117-134; anticausal fm <= i <= t-fm-2, :246-263),
    the marked row in the written columns (j <= f-fl-1, :173-191);
    everything else is 0, as zen_tpu gives it."""
    x = marked_matrix(t, f)
    out = both(torch.from_numpy(x), fl, direction, VALID)
    np.testing.assert_array_equal(out, zen(x, fl, direction, VALID))
    fm = fl // 2
    want = np.zeros_like(x)
    if direction == TIME_CAUSAL:
        want[fl:, f // 2] = 8
    elif direction == TIME_ANTICAUSAL:
        want[fm : t - fm - 1, f // 2] = 8
    else:
        want[t // 2, : f - fl] = 5
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("border", [WRAP, REPLICATE])
def test_wrap_replicate_preserve_structures(direction, border):
    """Centered variants: the full marked row or column survives
    everywhere, the background stays zero."""
    x = marked_matrix(11, 13)
    out = both(torch.from_numpy(x), 3, direction, border)
    np.testing.assert_array_equal(out, zen(x, 3, direction, border))
    if direction == FREQUENCY:
        assert (out[11 // 2, :] == 5).all()
    else:
        assert (out[:, 13 // 2] == 8).all()
    assert out[0, 0] == 0


def test_degenerate_filter_raises():
    """Filter bigger than the matrix dim throws (mfilt.test.cu:235-244),
    in both packages; the filter's own dim decides."""
    for fl, direction, t, f in ((171, FREQUENCY, 9, 9), (10, TIME_CAUSAL, 9, 20),
                                (10, TIME_ANTICAUSAL, 9, 20)):
        with pytest.raises(ZenError):
            tm.validate_filter(fl, direction, t, f)
        with pytest.raises(Exception, match="bigger than matrix dimension"):
            jm.validate_filter(fl, direction, t, f)
    for fl, direction, t, f in ((3, FREQUENCY, 9, 9), (9, FREQUENCY, 2, 9),
                                (9, TIME_CAUSAL, 9, 2)):
        tm.validate_filter(fl, direction, t, f)
        jm.validate_filter(fl, direction, t, f)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("border", BORDERS)
def test_random_data_matches_numpy_model(direction, border):
    """Random data (tests/test_ops.py's model): both packages and
    np_filter2d agree bitwise."""
    x = np.random.default_rng(0).standard_normal((12, 18)).astype(np.float32)
    out = both(torch.from_numpy(x), 5, direction, border)
    np.testing.assert_array_equal(out, zen(x, 5, direction, border))
    np.testing.assert_array_equal(out, np_filter2d(x, 5, direction, border))


# ---------------- the edge grid ----------------


def _grid_fl(kind: str, dim: int) -> int:
    return {"one": 1, "even": 4, "dim": dim, "past_dim": dim + 3}[kind]


@pytest.mark.parametrize("shape", [(7, 10), (1, 6)])
@pytest.mark.parametrize("kind", ["one", "even", "dim", "past_dim"])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("border", BORDERS)
def test_edge_grid(shape, kind, direction, border):
    """filter_len 1, even (made odd), equal to the filtered dim and past
    it (wrap goes round more than once, valid writes nothing), and T = 1:
    both packages and the numpy model agree bitwise."""
    fl = _grid_fl(kind, shape[1] if direction == FREQUENCY else shape[0])
    x = np.random.default_rng(fl).random(shape, dtype=np.float32)
    out = both(torch.from_numpy(x), fl, direction, border)
    np.testing.assert_array_equal(out, zen(x, fl, direction, border))
    np.testing.assert_array_equal(out, np_filter2d(x, fl, direction, border))


# ---------------- +inf, bf16, leading dims, views ----------------


def _variant(kind: str, rng) -> tuple:
    """(numpy input for zen_tpu, torch input for the port) of shape
    [..., 12, 18]: +inf rows and columns; bf16 (zen_tpu reads the same
    bf16 values); leading batch dims (zen_tpu filters each matrix); a
    transposed, non-contiguous view."""
    x = rng.random((12, 18), dtype=np.float32) + np.float32(1e-3)
    if kind == "inf":
        x[3:5, :] = np.inf
        x[:, 7] = np.inf
        return x, torch.from_numpy(x)
    if kind == "bf16":
        xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        return xb, torch.from_numpy(xb).to(torch.bfloat16)
    if kind == "batch":
        xs = rng.random((2, 3, 12, 18), dtype=np.float32)
        return xs, torch.from_numpy(xs)
    return x, torch.from_numpy(np.ascontiguousarray(x.T)).T


@pytest.mark.parametrize("kind", ["inf", "bf16", "batch", "view"])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("border", BORDERS)
def test_inputs_the_kernels_take(kind, direction, border):
    want_in, x = _variant(kind, np.random.default_rng(7))
    out = both(x, 5, direction, border)
    if kind == "batch":
        want = np.stack([np.stack([zen(m, 5, direction, border) for m in row])
                         for row in want_in])
    elif kind == "bf16":
        want = np.asarray(jm.median2d(jnp.asarray(want_in).astype(jnp.bfloat16), 5, direction,
                                      border).astype(jnp.float32))
    else:
        want = zen(want_in, 5, direction, border)
    np.testing.assert_array_equal(out, want)
    if kind == "inf":
        assert np.isinf(out).any()


def test_nan_is_ranked_not_propagated():
    """A NaN tap: zen_tpu's jnp.median makes every window holding it NaN;
    the port's kthvalue twins rank NaN above +inf, so a window of (1, NaN,
    2) gives 2 and no output is NaN. A recorded difference (ROADMAP
    Queue 3): the kernels take magnitudes, where NaN does not arise."""
    x = np.ones((5, 6), np.float32)
    x[:, 2] = 2.0
    x[2, 3] = np.nan
    want = zen(x, 3, FREQUENCY, WRAP)
    assert np.isnan(want[2, 2:5]).all() and np.isnan(want).sum() == 3
    out = both(torch.from_numpy(x), 3, FREQUENCY, WRAP)
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out[2, 2:5], [2.0, 2.0, 1.0])
    np.testing.assert_array_equal(np.delete(out, 2, axis=0), np.delete(want, 2, axis=0))


@pytest.mark.parametrize("fn", [median2d, median2d_plain])
@pytest.mark.parametrize("direction,border", [("time", WRAP), (FREQUENCY, "zero"),
                                              (TIME_CAUSAL, "reflect")])
def test_unknown_direction_or_border_raises(fn, direction, border):
    """zen_tpu takes any border but wrap and replicate as 'valid'; the
    port refuses what it does not know."""
    with pytest.raises(ZenError, match="unknown median"):
        fn(torch.ones(4, 5), 3, direction, border)


# ---------------- the mapping onto the kernels ----------------


@pytest.mark.parametrize(
    "direction,border,shape,fl,want",
    [(FREQUENCY, WRAP, (6, 9), 4, ("K2", 5, "wrap")),
     (FREQUENCY, REPLICATE, (6, 9), 13, ("K2", 13, "edge")),
     (FREQUENCY, VALID, (6, 9), 5, ("K2", 5, "valid")),
     (FREQUENCY, VALID, (6, 9), 8, None),  # F - fl < 1: nothing written
     (TIME_CAUSAL, WRAP, (6, 9), 5, ("K1", tuple(range(-4, 1)), 4, 10)),
     (TIME_ANTICAUSAL, REPLICATE, (6, 9), 9, ("K1", tuple(range(-8, 1)), 8, 14)),
     (TIME_CAUSAL, VALID, (6, 9), 3, ("K1", (-3, -2, -1), 0, 6)),
     (TIME_ANTICAUSAL, VALID, (6, 9), 3, ("K1", (-1, 0, 1), 0, 6)),
     (TIME_CAUSAL, VALID, (6, 9), 6, None),  # T <= fl
     (TIME_ANTICAUSAL, VALID, (6, 9), 5, ("K1", tuple(range(-2, 3)), 0, 6)),  # one row
     (TIME_ANTICAUSAL, VALID, (6, 9), 6, None)])  # T - fl < 1
def test_median2d_calls_one_kernel_wrapper(monkeypatch, direction, border, shape, fl, want):
    """Each direction and border reaches the kernel the card launches
    (K1 tap_median_time for time, K2 sliding_median_boundary for
    frequency) once, with the taps and rows of the mapping, and none
    where 'valid' writes nothing."""
    calls = []
    time_wrapper, freq_wrapper = mc.tap_median_time, mc.sliding_median_boundary

    def k1(a, b, offsets, start, fill=0.0):
        calls.append(("K1", tuple(offsets), start, a.shape[-2] + b.shape[-2]))
        return time_wrapper(a, b, offsets, start, fill)

    def k2(x, k, mode):
        calls.append(("K2", k, mode))
        return freq_wrapper(x, k, mode)

    monkeypatch.setattr(mc, "tap_median_time", k1)
    monkeypatch.setattr(mc, "sliding_median_boundary", k2)
    x = torch.from_numpy(np.random.default_rng(3).random(shape, dtype=np.float32))
    out = median2d(x, fl, direction, border)
    assert calls == ([want] if want else [])
    torch.testing.assert_close(out, median2d_plain(x, fl, direction, border), rtol=0, atol=0)


# ---------------- helpers copied from zen_tpu ----------------


def test_filter_length_helpers_are_zen_tpu_s():
    for n in range(1, 40):
        assert tm.odd_filter_len(n) == jm.odd_filter_len(n)
        assert tm.centered_offsets(n) == jm.centered_offsets(n)
    assert (tm.TIME_CAUSAL, tm.TIME_ANTICAUSAL, tm.FREQUENCY, tm.WRAP, tm.VALID,
            tm.REPLICATE) == (jm.TIME_CAUSAL, jm.TIME_ANTICAUSAL, jm.FREQUENCY, jm.WRAP,
                              jm.VALID, jm.REPLICATE)


@pytest.mark.parametrize("boundary", ["zero", "wrap", REPLICATE, "clamp", "reflect"])
@pytest.mark.parametrize("dim", [0, -1])
def test_tap_stack_matches_zen_tpu(boundary, dim):
    """[K, *x.shape] shifted views, fill 7 under 'zero'."""
    x = np.random.default_rng(5).random((6, 8), dtype=np.float32)
    offsets = (-3, -1, 0, 2, 5) if boundary != "reflect" else (-3, 0, 2)
    got = tm.tap_stack(torch.from_numpy(x), offsets, dim, boundary, fill=7.0)
    want = np.asarray(jm.tap_stack(jnp.asarray(x), offsets, dim, boundary, fill=7.0))
    assert got.shape == (len(offsets),) + x.shape
    np.testing.assert_array_equal(got.numpy(), want)
