"""The port's medians against zen_tpu's, BITWISE.

A median of an odd tap count is pure selection (jnp.median, the Pallas
networks and the port's kthvalue twins and CUDA kernels all pick
sorted[(K-1)/2]), so every comparison here is assert_array_equal: no
tolerance. Inputs are continuous random values from numpy, with no
signed zeros, handed to both packages.

The Pallas kernels run as tests/test_pallas.py runs them on the CPU:
in TPU interpret mode. The CUDA kernels against these same twins are
in tests/test_torch_cuda.py (card only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zen_tpu.engine.oracle import _np_taps  # noqa: E402
from zen_tpu.ops import median_pallas as mp  # noqa: E402
from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch import ZenError  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from zen_tpu_torch.ops.median import sliding_median  # noqa: E402

T1024 = (-5, -1, 0)
T256 = tuple(range(-21, -16)) + tuple(range(-5, 1))


@pytest.fixture(autouse=True)
def maybe_interpret(monkeypatch):
    if jax.default_backend() != "tpu":
        from jax.experimental.pallas import tpu as pltpu

        ctx = pltpu.force_tpu_interpret_mode()
        ctx.__enter__()
        yield
        ctx.__exit__(None, None, None)
    else:
        yield


def _mags(rng, *shape):
    return (rng.random(shape, dtype=np.float32) + np.float32(1e-3))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    """The same bf16 values for both packages: a jnp bf16 array and the
    torch bf16 tensor of its exact float32 read-back."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, _t(np.asarray(xb, np.float32)).to(torch.bfloat16)


def _np32(y):
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float32)


# ---------------- plain twins vs zen_tpu.ops.median ----------------


@pytest.mark.parametrize("fill", [0.0, float("inf")])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start",
    [
        ((1, 5, 2049), (1, 32, 2049), T1024, 5),  # hop 1024, B = 32
        ((4, 21, 513), (4, 32, 513), T256, 21),  # hop 256 fleet, B = 32
        ((1, 6, 2049), (1, 0, 2049), T1024, 5),  # hop 1024, B = 1 (one input)
    ],
)
def test_time_plain_matches_jax(a_shape, b_shape, offsets, start, fill):
    rng = np.random.default_rng(1)
    a, b = _mags(rng, *a_shape), _mags(rng, *b_shape)
    want = np.asarray(
        jax_sliding_median(
            jnp.concatenate([a, b], axis=-2), offsets, -2, "zero", fill=fill
        )[..., start:, :]
    )
    got = mc.tap_median_time(_t(a), _t(b), offsets, start, fill).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "rows,f,k,mode",
    [
        (32, 2049, 47, "reflect"),  # hop 1024, fast_rfft
        (64, 513, 13, "reflect"),  # hop 256 fleet rows (cut from 2048)
        (8, 4096, 47, "wrap"),  # hop 1024, full C2C spectrum
        (8, 513, 13, "edge"),
    ],
)
def test_freq_plain_matches_jax(rows, f, k, mode):
    rng = np.random.default_rng(2)
    x = _mags(rng, rows, f)
    m = (k - 1) // 2
    boundary = {"edge": "clamp"}.get(mode, mode)
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = mc.sliding_median_boundary(_t(x), k, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("boundary", ["zero", "wrap", "clamp", "reflect"])
@pytest.mark.parametrize("dim", [-1, -2])
def test_sliding_median_matches_jax_every_boundary(boundary, dim):
    """Negative values, duplicate offsets, reaches past the edge."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 17, 19)).astype(np.float32)
    for offsets in ((-3, -2, -1, 0, 0, 0, 0), (-9, -1, 0, 4, 9), (0,)):
        if boundary == "reflect" and max(map(abs, offsets)) > 16:
            continue
        want = np.asarray(
            jax_sliding_median(jnp.asarray(x), offsets, dim, boundary, fill=np.inf)
        )
        got = sliding_median(_t(x), offsets, dim, boundary, fill=float("inf"))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "offsets,boundary,dim",
    [(tuple(range(-5, 0)) + (0,) * 6, "zero", -2),  # replicate, causal hop 256
     (tuple(range(-11, 0)), "zero", -2),  # valid, causal hop 256
     (tuple(range(-6, 7)), "clamp", -1),  # replicate frequency window
     (tuple(range(0, 13)), "zero", -1),  # valid forward window
     (T256, "zero", -2)],
)
def test_plain_bf16_matches_jax(offsets, boundary, dim):
    """On bf16 values the plain reference picks the element
    zen_tpu.ops.median.sliding_median picks, duplicate offsets included
    (the replicate border repeats offset 0)."""
    rng = np.random.default_rng(14)
    xb, xt = _bf16(_mags(rng, 3, 24, 40))
    want = jax_sliding_median(xb, offsets, dim, boundary, fill=0.0)
    got = sliding_median(xt, offsets, dim, boundary, fill=0.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


# ---------------- port vs the Pallas kernels (interpret mode) ----------------


@pytest.mark.parametrize(
    "c,h,b,f,offsets",
    [(3, 5, 8, 130, tuple(range(-4, 1))), (1, 7, 7, 64, (-7, -3, 0)),
     (2, 5, 32, 200, T1024)],
)
def test_time_pair_matches_pallas(c, h, b, f, offsets):
    rng = np.random.default_rng(4)
    hist, fresh = _mags(rng, c, h, f), _mags(rng, c, b, f)
    want = np.asarray(mp.tap_median_time_pair_pallas(hist, fresh, offsets))
    got = mc.tap_median_time(_t(hist), _t(fresh), offsets, h).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "c,h,b,f,offsets,r",
    [(3, 21, 16, 130, T256, 2), (3, 21, 16, 130, T256, 3), (2, 21, 32, 64, T256, 3),
     (2, 11, 16, 130, tuple(range(-11, 0)), 4)],
)
def test_time_core_plain_matches_pallas_pair(c, h, b, f, offsets, r):
    """K1's shared core, run by its plain version at the R values it is
    built for at the fleets' taps (hop 256's two tap runs under wrap, one
    run under the valid border), against zen_tpu's pair kernel."""
    rng = np.random.default_rng(r)
    hist, fresh = _mags(rng, c, h, f), _mags(rng, c, b, f)
    want = np.asarray(mp.tap_median_time_pair_pallas(hist, fresh, offsets))
    got = mc.tap_median_time_core_plain(_t(hist), _t(fresh), offsets, h, 0.0, r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "offsets,start,fill",
    [((-3, -2, -1, 0, 0, 0, 0), 0, 0.0), (T1024, 5, 0.0),
     (tuple(range(-3, 4)), 2, float("inf"))],
)
def test_time_single_matches_pallas(offsets, start, fill):
    rng = np.random.default_rng(5)
    x = _mags(rng, 2, 16, 130)
    want = np.asarray(mp.tap_median_time_pallas(x, offsets, fill=fill, start=start))
    got = mc.tap_median_time(_t(x), _t(x[:, :0]), offsets, start, fill).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge"])
@pytest.mark.parametrize("shape,k", [((16, 200), 5), ((4, 32, 513), 13)])
def test_freq_boundary_matches_pallas(shape, k, mode):
    """(4, 32, 513) folds to 128 rows and takes the fused kernel #7;
    (16, 200) takes jnp.pad + the padded kernel #5."""
    rng = np.random.default_rng(6)
    x = _mags(rng, *shape)
    want = np.asarray(mp.sliding_median_boundary_pallas(x, k, mode))
    got = mc.sliding_median_boundary(_t(x), k, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c,t,f,k,start",
    [(256, 24, 130, 9, 8),  # every tap in bounds: the unpadded branch
     (320, 12, 64, 5, 0)],  # taps before row 0: the padded fill branch
)
def test_time_piped_matches_pallas(c, t, f, k, start, dtype):
    """#4 _time_kernel_piped, the wide-fleet route (C >= 256, one tile),
    at tests/test_pallas.py's shape family: the port's K1 (its twin
    here) equals it bitwise at f32 and bf16, and the JAX call is shown
    to have taken _time_impl_piped."""
    from unittest import mock

    rng = np.random.default_rng(15)
    offsets = tuple(range(-(k - 1), 1))
    x = rng.standard_normal((c, t, f)).astype(np.float32)
    if dtype == "bfloat16":
        xj, xt = _bf16(x)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    with mock.patch.object(mp, "_time_impl_piped", wraps=mp._time_impl_piped) as piped:
        want = mp.tap_median_time_pallas(xj, offsets, 0.0, start)
    assert piped.call_count == 1
    got = mc.tap_median_time(xt, xt[:, :0], offsets, start)
    assert got.dtype == xt.dtype and want.dtype == xj.dtype
    np.testing.assert_array_equal(_np32(got), _np32(want))


def test_time_pair_bf16_matches_pallas():
    """#1 on bf16 (stream_state='bf16' at B >= H): the hop-256 fleet's
    taps over 8 streams."""
    rng = np.random.default_rng(16)
    hj, ht = _bf16(_mags(rng, 8, 21, 513))
    fj, ft = _bf16(_mags(rng, 8, 32, 513))
    want = mp.tap_median_time_pair_pallas(hj, fj, T256)
    got = mc.tap_median_time(ht, ft, T256, 21)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_freq_fused_bf16_matches_pallas(mode):
    """#7 on bf16: 128 folded rows of 513 bins at K = 13."""
    rng = np.random.default_rng(17)
    xj, xt = _bf16(_mags(rng, 4, 32, 513))
    assert mp.fused_freq_supported(xj.shape, 13, xj.dtype)
    want = mp.sliding_median_boundary_pallas(xj, 13, mode)
    got = mc.sliding_median_boundary(xt, 13, mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


# The offline routes (#3, #6, #8 of the kernel table): the TPU picks
# them from the shape; the port's wrappers take one route for all.


def test_time_pipelined_matches_pallas():
    """600 rows with centered taps -5..5 take _time_kernel_pipelined
    (n_t > 1), the shape of tests/test_pallas.py:320."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((600, 200)).astype(np.float32)
    offsets = tuple(range(-5, 6))
    want = np.asarray(mp.tap_median_time_pallas(x, offsets))
    got = mc.tap_median_time(_t(x), _t(x[:0]), offsets, 0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "shape,k,layout",
    [((24, 300), 131, "lane"),  # K > 128: tb = 8 rows, n_t = 3 (#6)
     ((130, 513), 13, "sublane")],  # >= 128 rows that do not tile (#8)
)
def test_freq_offline_routes_match_pallas(shape, k, layout):
    rng = np.random.default_rng(12)
    x = _mags(rng, *shape)
    assert not mp.fused_freq_supported(shape, k, jnp.float32)
    assert mp._auto_layout(k, (shape[0], shape[1] + k - 1)) == layout
    want = np.asarray(mp.sliding_median_boundary_pallas(x, k, "reflect"))
    got = mc.sliding_median_boundary(_t(x), k, "reflect").numpy()
    np.testing.assert_array_equal(got, want)


def test_freq_valid_matches_padded_pallas():
    """'valid' is the padded kernel #5's contract on a pre-padded row."""
    rng = np.random.default_rng(7)
    k = 47
    xp = _mags(rng, 8, 130 + k - 1)
    want = np.asarray(mp.sliding_median_last_axis_pallas(xp, k))
    got = mc.sliding_median_boundary(_t(xp), k, "valid").numpy()
    assert got.shape == (8, 130)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,k,mode",
    [((4, 32, 513), 13, "reflect"),  # 128 folded rows: the fused kernel #7
     ((4, 32, 513), 13, "edge"),
     ((130, 513), 13, "reflect"),  # >= 128 rows that do not tile: the sublane route #8
     ((8, 130 + 12), 13, "valid"),  # a pre-padded row: the padded kernel #5
     ((2, 64, 129), 31, "wrap")],
)
def test_freq_core_plain_matches_pallas(shape, k, mode, dtype):
    """K2's shared core, run by its plain version at each R it is built
    for at K (13: 3 and 4; 31: 6 and 8), against the Pallas frequency
    kernels the paths' shapes take, f32 and bf16."""
    rng = np.random.default_rng(k + len(mode))
    x = _mags(rng, *shape)
    xj, xt = _bf16(x) if dtype == "bfloat16" else (jnp.asarray(x), _t(x))
    want = (mp.sliding_median_last_axis_pallas(xj, k) if mode == "valid"
            else mp.sliding_median_boundary_pallas(xj, k, mode))
    for r in mc.freq_core_runs(k):
        got = mc.sliding_median_boundary_core_plain(xt, k, mode, r)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(_np32(got), _np32(want))


# ---------------- wrapper contract (no card needed) ----------------


def test_cpu_tensors_take_the_plain_twin_and_count_nothing():
    rng = np.random.default_rng(8)
    x = _t(_mags(rng, 2, 9, 33))
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    mc.tap_median_time(x, x[:, :0], T1024, 5)
    mc.sliding_median_boundary(x, 5, "reflect")
    assert mc.tap_median_time.launches == n_time
    assert mc.sliding_median_boundary.launches == n_freq


def test_cpu_rows_of_the_core_s_geometry_take_the_plain_twin():
    """A CPU tensor of a geometry whose CUDA call takes K2's shared core
    (643 rows of 513 bins at K = 13, the clip's pass 2) goes to the plain
    twin and counts no launch and no core."""
    assert mc.freq_network_form(13, 643, 513, "reflect") == ("core", 3)
    x = _t(_mags(np.random.default_rng(18), 643, 513))
    n, cores = mc.sliding_median_boundary.launches, mc.sliding_median_boundary.cores
    got = mc.sliding_median_boundary(x, 13, "reflect")
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, 13, "reflect"))
    assert (mc.sliding_median_boundary.launches, mc.sliding_median_boundary.cores) == (n, cores)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: mc.tap_median_time(x, x, (-1, 0), 2),  # even K
        lambda x: mc.tap_median_time(x, x, (0,) * (mc.MAX_TIME_TAPS + 2), 0),  # K
        lambda x: mc.tap_median_time(x, x, T1024, 50),  # start past the rows
        lambda x: mc.tap_median_time(x, x[:1], T1024, 5),  # mismatched streams
        lambda x: mc.sliding_median_boundary(x, 4, "reflect"),  # even K
        lambda x: mc.sliding_median_boundary(x, mc.MAX_FREQ_TAPS + 2, "wrap"),  # K
        lambda x: mc.sliding_median_boundary(x, 5, "mirror"),  # unknown mode
        lambda x: mc.sliding_median_boundary(x, 71, "reflect"),  # reach >= F
        lambda x: mc.sliding_median_boundary(x, 35, "valid"),  # wider than row
        lambda x: mc.sliding_median_boundary(x.half(), 5, "wrap"),  # float16
        lambda x: mc.tap_median_time(x, x.bfloat16(), T1024, 5),  # mixed dtypes
        lambda x: mc.tap_median_time(x.double(), x.double(), T1024, 5),  # float64
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    x = torch.ones((2, 9, 33))
    with pytest.raises(ZenError):
        call(x)


def test_every_config_fits_both_kernels():
    """Every (fs, hop, causal) of the test_torch_config.py sweep, and hop
    1 at 96 to 384 kHz, gives tap counts both kernels take on the card:
    up to 401 time taps at 44.1/48 kHz (hop 8), 25,601 at 384 kHz hop 1
    (K1's rank route on the key store; 12,801 at 192 kHz, past the 12,287
    the port took before), and 257 frequency taps (fs 8000 hop 1024),
    past the 64 and 255 the first kernels stopped at."""
    from zen_tpu_torch import HPRConfig

    k_time, k_freq = {}, []
    grid = [(fs, hop) for fs in (1000.0, 8000.0, 22050.0, 44100.0, 48000.0)
            for hop in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)]
    grid += [(fs, 1) for fs in (96000.0, 176400.0, 184320.0, 192000.0, 384000.0)]
    for fs, hop in grid:
        for causal in (False, True):
            try:
                cfg = HPRConfig(fs=fs, hop=hop, causal=causal)
            except ZenError:
                continue
            k_time[fs, hop] = max(k_time.get((fs, hop), 0), len(cfg.time_offsets))
            k_freq.append(cfg.freq_filter_len)
    assert max(k for (fs, _), k in k_time.items() if fs <= 48000.0) == 401
    assert [k_time[fs, 1] for fs in (96000.0, 176400.0, 184320.0, 192000.0, 384000.0)] == [
        6401, 11761, 12289, 12801, 25601]
    assert max(k_freq) == 257
    assert max(k_time.values()) <= mc.MAX_TIME_TAPS and max(k_freq) <= mc.MAX_FREQ_TAPS


# ---------------- every tap count: the wide K against numpy ----------------
#
# zen_tpu's median at these K is held through its numpy oracle's tap rule
# (zen_tpu.engine.oracle._np_taps: wrap takes p % n, clamp clips, zero
# clips and zeroes the taps outside) with np.median: jax's sliding_median
# traces one static slice a tap, and XLA compiling 12,801 of them is too
# slow for tier-1. _np_taps itself stacks every position's taps (K x n
# floats: 1.3 GB at 192 kHz's history), so _np_median applies the same
# rule at the output positions only; test_np_median_is_the_oracle_rule
# holds the two equal where _np_taps fits.

# HPRConfig(fs, hop=1)'s time taps: causal (the wrap border's two runs) and centered
HOP1_TAPS = {
    (192000.0, True): tuple(range(-25599, -19199)) + tuple(range(-6400, 1)),
    (192000.0, False): tuple(range(-6400, 6401)),
    (384000.0, True): tuple(range(-51199, -38399)) + tuple(range(-12800, 1)),
    (384000.0, False): tuple(range(-12800, 12801)),
}


def _np_median(x: np.ndarray, offsets, axis: int, boundary: str, positions,
               fill: float = 0.0) -> np.ndarray:
    """np.median over ``offsets`` at output ``positions`` along ``axis``,
    the taps taken by _np_taps' rule ('zero' taps outside read ``fill``)."""
    n = x.shape[axis]
    idx = np.asarray(positions)[:, None] + np.asarray(offsets)[None, :]
    take = idx % n if boundary == "wrap" else np.clip(idx, 0, n - 1)
    taps = np.moveaxis(x, axis, -1)[..., take]  # [..., positions, K]
    if boundary == "zero":
        taps = np.where((idx >= 0) & (idx < n), taps, np.float32(fill))
    return np.moveaxis(np.median(taps, axis=-1), -1, axis)


@pytest.mark.parametrize("boundary", ["zero", "wrap", "clamp"])
def test_np_median_is_the_oracle_rule(boundary):
    rng = np.random.default_rng(40)
    x = _mags(rng, 3, 300, 2)
    offsets = tuple(range(-120, -70)) + tuple(range(-50, 1))
    want = np.median(_np_taps(x, offsets, 1, boundary), axis=0)
    np.testing.assert_array_equal(_np_median(x, offsets, 1, boundary, range(300)), want)
    np.testing.assert_array_equal(_np_median(x, offsets, 1, boundary, range(200, 300)),
                                  want[:, 200:])


@pytest.mark.parametrize("fs,causal", list(HOP1_TAPS))
def test_time_hop1_taps_match_numpy(fs, causal):
    """tap_median_time at HPRConfig(fs, hop=1)'s offsets, which it refused
    before: causal, the pair form over the whole history and 4 fresh rows;
    centered, the one-input form's last 8 rows of 13,000 (taps past V's
    end read fill)."""
    from zen_tpu_torch import HPRConfig

    cfg = HPRConfig(fs=fs, hop=1, causal=causal)
    offsets = HOP1_TAPS[fs, causal]
    assert cfg.time_offsets == offsets
    rng = np.random.default_rng(len(offsets))
    if causal:
        a, b, start = _mags(rng, 1, cfg.time_history, 3), _mags(rng, 1, 4, 3), cfg.time_history
    else:
        a, start = _mags(rng, 1, 13_000, 2), 12_992
        b = a[:, :0]
    v = np.concatenate([a, b], axis=1)
    got = mc.tap_median_time(_t(a), _t(b), offsets, start).numpy()
    np.testing.assert_array_equal(got, _np_median(v, offsets, 1, "zero", range(start, v.shape[1])))


def test_time_takes_every_k_to_its_limit():
    """MAX_TIME_TAPS taps in one run (accepted on the CPU as on the card,
    whose key store holds one row's 2^21 keys); two more are refused."""
    rng = np.random.default_rng(41)
    a, b = _mags(rng, 1, 40, 2), _mags(rng, 1, 2, 2)
    offsets = tuple(range(-(mc.MAX_TIME_TAPS - 1), 1))
    v = np.concatenate([a, b], axis=1)
    got = mc.tap_median_time(_t(a), _t(b), offsets, 40, float("inf")).numpy()
    np.testing.assert_array_equal(got, _np_median(v, offsets, 1, "zero", range(40, 42),
                                                  float("inf")))
    with pytest.raises(ZenError, match="odd K"):
        mc.tap_median_time(_t(a), _t(b), offsets + (0, 0), 40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,f_out", [(57_859, 5), (65_537, 3)])
def test_freq_valid_wide_k_matches_numpy(k, f_out, dtype):
    """K2 'valid' past 57,857 (its old cap), a few outputs of a pre-padded
    row: the twin computes only those."""
    rng = np.random.default_rng(k)
    x = _mags(rng, 2, f_out + k - 1)
    xt = _t(x)
    if dtype == "bfloat16":
        x, xt = _np32(_bf16(x)[0]), _bf16(x)[1]
    got = mc.sliding_median_boundary(xt, k, "valid")
    assert got.dtype == xt.dtype and got.shape == (2, f_out)
    np.testing.assert_array_equal(_np32(got), _np_median(x, range(k), 1, "zero", range(f_out)))


@pytest.mark.parametrize("k,f", [(65_537, 40), (mc.MAX_FREQ_TAPS, 4)])
def test_freq_wrap_wide_k_matches_numpy(k, f):
    """'wrap' windows many times a short row's width: past 57,857 taps,
    and at MAX_FREQ_TAPS itself (two more are refused)."""
    rng = np.random.default_rng(k)
    x = _mags(rng, 2 if k < mc.MAX_FREQ_TAPS else 1, f)
    m = (k - 1) // 2
    got = mc.sliding_median_boundary(_t(x), k, "wrap").numpy()
    np.testing.assert_array_equal(got, _np_median(x, range(-m, m + 1), 1, "wrap", range(f)))
    with pytest.raises(ZenError, match="odd K"):
        mc.sliding_median_boundary(_t(x), mc.MAX_FREQ_TAPS + 2, "wrap")


@pytest.mark.parametrize("fs", [192000.0, 384000.0])
def test_realtime_hop1_steps_and_its_time_median_matches_numpy(fs, monkeypatch):
    """HPRRealtime(fs, hop=1) on the CPU, refused before at K1's old cap:
    a block of 5 hops, then one hop. Each step's time median (captured at
    tap_median_time, the pair form over the history) equals numpy's median
    of the step's rows, and every stem sample is finite."""
    from zen_tpu_torch import HPRRealtime

    calls = []
    real = mc.tap_median_time

    def spy(a, b, offsets, start, fill=0.0):
        out = real(a, b, offsets, start, fill)
        calls.append((a.clone(), b.clone(), offsets, start, fill, out))
        return out

    monkeypatch.setattr(mc, "tap_median_time", spy)
    rt = HPRRealtime(fs, hop=1, device="cpu")
    assert len(rt.cfg.time_offsets) == {192000.0: 12_801, 384000.0: 25_601}[fs]
    rng = np.random.default_rng(int(fs))
    audio = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    outs = [rt.process_block(audio[:5, None]), rt.process_next_hop(audio[5:])]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert len(calls) == 2
    for a, b, offsets, start, fill, out in calls:
        assert tuple(offsets) == rt.cfg.time_offsets and start == a.shape[-2]
        v = torch.cat([a, b], dim=-2).numpy()
        want = _np_median(v, offsets, -2, "zero", range(start, v.shape[-2]), fill)
        np.testing.assert_array_equal(out.numpy(), want)
