"""zen_tpu_torch/ops/box.py against zen_tpu/ops/box.py, on the CPU.

Both packages get the same numpy inputs (made from a seed) and run the
same additions in the same order (the pow2 doubling tree per run, short
runs tap by tap, duplicates last, one division). Against zen_tpu's
``sliding_mean`` run op by op the match is bitwise, infs and their
positions included, at every boundary, pattern and pad width here.
zen_tpu's ``box2d`` is jitted, and XLA compiles its division by K as a
multiplication by float32(1/K): there the finite values agree within
1 ulp and the infs sit in the same places. The port divides on every
device (``box._divide``), so the card can match the CPU to the bit.
Against the direct per-tap mean (another order of the same additions)
the tree agrees within 2e-6, as zen_tpu's own test holds its tree
(tests/test_ops.py:193-232).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops import box as jbox  # noqa: E402
from zen_tpu_torch import ZenError  # noqa: E402
from zen_tpu_torch.ops import box as tbox  # noqa: E402

PATTERNS = {
    "centered run": tuple(range(-6, 7)),
    "causal long run": tuple(range(-23, 0)),
    "split runs (hop 256 wrap)": tuple(range(-21, -16)) + tuple(range(-5, 1)),
    "duplicates (replicate)": (-5, -4, -3, -2, -1, 0, 0, 0, 0, 0, 0),
    "short runs": (-9, -8, -5, -3, -2, -1, 0),
    "K=3 (fallback)": (-5, -1, 0),
    "forward run (valid)": tuple(range(0, 13)),
    "run of 31": tuple(range(-15, 16)),
}
INF = float("inf")


def _inputs(seed: int, shape=(24, 130)):
    """Reciprocal-feature-like values with inf cells (|S| = 0 bins)."""
    rng = np.random.default_rng(seed)
    x = 1.0 / np.square(rng.random(shape, dtype=np.float32) + np.float32(0.05))
    x = x.astype(np.float32)
    x[rng.random(shape) < 0.02] = np.inf
    return x


def _both(x, offsets, dim, boundary, fill):
    want = np.asarray(jbox.sliding_mean(jnp.asarray(x), offsets, dim, boundary, fill))
    got = tbox.sliding_mean(torch.from_numpy(x), offsets, dim, boundary, fill).numpy()
    return got, want


@pytest.mark.parametrize("dim", [-1, -2])
@pytest.mark.parametrize("boundary", ["wrap", "reflect", "clamp", "replicate", "zero"])
def test_sliding_mean_bitwise_to_zen_tpu(boundary, dim):
    """Every pattern at this boundary and axis, with inf cells in the
    input and +inf as the 'zero' boundary's fill."""
    x = _inputs(1)
    for name, offs in PATTERNS.items():
        got, want = _both(x, offs, dim, boundary, INF)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=name)
        assert not np.isnan(got).any(), name
        np.testing.assert_array_equal(got, want, err_msg=f"{boundary} {dim} {name}")


@pytest.mark.parametrize("boundary", ["wrap", "clamp", "zero"])
def test_pads_wider_than_the_row_bitwise(boundary):
    """Reaches at or past the row take zen_tpu's per-tap fallback (whole
    taps of fill, wrapped or clamped rows), in both packages alike."""
    x = _inputs(2, (3, 5, 7))
    for offs in (tuple(range(-9, 1)), tuple(range(-3, 9)), (-20, -1, 0, 0, 14)):
        for dim in (-1, -2):
            got, want = _both(x, offs, dim, boundary, INF)
            np.testing.assert_array_equal(got, want, err_msg=f"{offs} {dim}")


def test_reflect_past_the_row_raises():
    """jnp.take reads no defined sample past a reflected row; the port
    refuses, as its median's tap_index does (ops/median.py:32-33)."""
    x = torch.ones(4, 6)
    with pytest.raises(ZenError, match="reflect"):
        tbox.sliding_mean(x, tuple(range(-6, 7)), -1, "reflect")


@pytest.mark.parametrize("direction", ["frequency", "time"])
@pytest.mark.parametrize("border", ["wrap", "replicate"])
def test_box2d_bitwise_to_zen_tpu(border, direction):
    x = _inputs(3, (2, 40, 33))
    for filter_len in (4, 5, 12, 31):
        want = np.asarray(jbox.box2d(jnp.asarray(x), filter_len, direction, border))
        got = tbox.box2d(torch.from_numpy(x), filter_len, direction, border).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=str(filter_len))
        fin = np.isfinite(want)
        np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=1)
    with pytest.raises(ZenError, match="valid"):
        tbox.box2d(torch.from_numpy(x), 5, direction, "valid")


def test_tree_matches_direct_taps():
    """The doubling tree against the direct per-tap order (tests/test_ops.py:
    193-222): another order of the same additions, within 2e-6."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((24, 130)).astype(np.float32))
    for dim in (-1, -2):
        for boundary in ("wrap", "reflect", "clamp", "zero"):
            for name, offs in PATTERNS.items():
                got = tbox.sliding_mean(x, offs, dim, boundary)
                want = tbox._taps_mean(x, sorted(offs), dim % 2, boundary, 0.0)
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=2e-6,
                                           err_msg=f"{dim} {boundary} {name}")


def test_inf_prefill_never_nan():
    """tests/test_ops.py:224-231: windows touching the +inf fill are inf
    exactly, the others finite, none NaN (no running sum holds inf)."""
    rng = np.random.default_rng(3)
    xi = torch.from_numpy(np.abs(rng.standard_normal((24, 130))).astype(np.float32) + 0.1)
    got = tbox.sliding_mean(xi, tuple(range(-9, 1)), -2, "zero", fill=INF).numpy()
    assert np.isinf(got[:9]).all()
    assert np.isfinite(got[9:]).all()
    assert not np.isnan(got).any()


def test_division_is_a_true_division():
    """The mean divides the tree's sum by K on the tensor's own device (a
    Python-scalar divisor of a CUDA tensor is applied as a multiplication
    by its reciprocal, up to an ulp away): the result equals numpy's
    float32 true division of the sum."""
    x = torch.from_numpy(_inputs(4, (5, 64)))
    total = tbox._window_sum(tbox._pad(x, 6, 6, 1, "wrap", 0.0), 0, 13, 64, 1)
    got = tbox.sliding_mean(x, tuple(range(-6, 7)), -1, "wrap").numpy()
    np.testing.assert_array_equal(got, total.numpy() / np.float32(13))
