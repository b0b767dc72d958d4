"""zen_tpu_torch's CUDA kernels on the card: every test carries the
``cuda`` marker and skips without an NVIDIA GPU (a CUDA kernel has no
CPU or interpret mode). This file imports neither jax nor zen_tpu, so it
also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernels are held BITWISE against their plain twins on the same CUDA
inputs (median = selection); the twins are held bitwise against
zen_tpu in tests/test_torch_median.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zen_tpu_torch import (  # noqa: E402
    HPRConfig,
    HPRIOffline,
    HPRRealtime,
    MultiStreamHPR,
    ZenError,
)
from zen_tpu_torch.engine import spectral as sp  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402

T1024 = (-5, -1, 0)
T256 = tuple(range(-21, -16)) + tuple(range(-5, 1))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mags(rng, *shape, device):
    x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((1, 5, 2049), (1, 32, 2049), T1024, 5, 0.0),
     ((64, 21, 513), (64, 32, 513), T256, 21, 0.0),
     ((1, 6, 2049), (1, 0, 2049), T1024, 5, 0.0),
     ((3, 16, 130), (3, 0, 130), tuple(range(-3, 4)), 2, float("inf")),
     ((2, 9, 77), (2, 4, 77), (-3, -2, -1, 0, 0, 0, 0), 0, 0.0),
     ((1, 30, 257), (1, 3, 257), tuple(range(-24, 1)), 0, 0.0),
     # offline pass 2 (hop 256, centered K = 11) and pass 1 (hop 4096, K = 1)
     ((1, 643, 513), (1, 0, 513), tuple(range(-5, 6)), 0, 0.0),
     ((1, 41, 8193), (1, 0, 8193), (0,), 0, 0.0),
     # past the register kernel: K = 93 (44.1 kHz hop 32, causal pair form),
     # K = 67 with duplicates, K = 401 (48 kHz hop 8, centered)
     ((2, 183, 65), (2, 40, 65), tuple(range(-183, -137)) + tuple(range(-46, 1)),
      183, 0.0),
     ((1, 90, 33), (1, 0, 33), (0,) * 33 + tuple(range(-33, 1)), 0, float("inf")),
     ((1, 900, 17), (1, 0, 17), tuple(range(-200, 201)), 0, 0.0)],
)
def test_time_kernel_matches_twin(cuda_device, a_shape, b_shape, offsets, start, fill):
    rng = np.random.default_rng(9)
    a = _mags(rng, *a_shape, device=cuda_device)
    b = _mags(rng, *b_shape, device=cuda_device)
    before = mc.tap_median_time.launches
    got = mc.tap_median_time(a, b, offsets, start, fill)
    torch.cuda.synchronize()
    assert mc.tap_median_time.launches == before + 1
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((64, 21, 513), (64, 32, 513), T256, 21, 0.0),  # the 64-stream fleet
     ((32, 21, 513), (32, 16, 513), T256, 21, 0.0),  # a 512-stream block's shard
     ((1, 643, 513), (1, 0, 513), tuple(range(-5, 6)), 0, 0.0),  # the clip's pass 2
     ((3, 40, 130), (3, 0, 130), tuple(range(-8, 9)), 5, float("inf")),  # fill past both ends
     ((8, 11, 1024), (8, 16, 1024), tuple(range(-11, 0)), 11, 0.0),  # the valid border
     ((4, 91, 129), (4, 32, 129), tuple(range(-91, -68)) + tuple(range(-23, 1)), 91, 0.0),
     ((4, 62, 129), (4, 37, 129), tuple(range(-31, 32)), 62, float("inf"))],
)
def test_time_core_matches_twin(cuda_device, a_shape, b_shape, offsets, start, fill, dtype):
    """K1's shared core at each R it is built for, at the paths' tap sets
    (one run, the causal wrap's two), bitwise to the twin."""
    rng = np.random.default_rng(len(offsets) + a_shape[1])
    a = _mags(rng, *a_shape, device=cuda_device).to(dtype)
    b = _mags(rng, *b_shape, device=cuda_device).to(dtype)
    want = mc.tap_median_time_plain(a, b, offsets, start, fill)
    runs = mc.time_core_runs(offsets)
    assert runs
    for r in runs:
        got = mc._time_launch(a, b, offsets, start, fill, "register", core=r)
        torch.cuda.synchronize()
        assert torch.equal(got, want), r


def test_register_route_takes_the_core_where_planned(cuda_device):
    """tap_median_time counts a shared-core launch in ``cores`` (and on
    the register route) where time_network_form picks it, and takes the
    per-output network at hop 1024's K = 3 and the replicate border's
    majority tap; a shape the core is not built for raises."""
    rng = np.random.default_rng(11)
    hist, fresh = (_mags(rng, 64, 21, 513, device=cuda_device),
                   _mags(rng, 64, 32, 513, device=cuda_device))
    register, cores = mc.tap_median_time.routes["register"], mc.tap_median_time.cores
    got = mc.tap_median_time(hist, fresh, T256, 21)
    torch.cuda.synchronize()
    assert (mc.tap_median_time.routes["register"], mc.tap_median_time.cores) == (
        register + 1, cores + 1)
    assert torch.equal(got, mc.tap_median_time_plain(hist, fresh, T256, 21))
    replicate = tuple(range(-5, 0)) + (0,) * 6
    h5, f5 = _mags(rng, 8, 5, 1024, device=cuda_device), _mags(rng, 8, 16, 1024, device=cuda_device)
    for a, b, offsets, start in ((hist[:1, :5], fresh[:1], T1024, 5), (h5, f5, replicate, 5)):
        a, b = a.contiguous(), b.contiguous()
        got = mc.tap_median_time(a, b, offsets, start)
        torch.cuda.synchronize()
        assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start))
    assert (mc.tap_median_time.routes["register"], mc.tap_median_time.cores) == (
        register + 3, cores + 1)
    with pytest.raises(ZenError, match="no shared core"):
        mc._time_launch(hist, fresh, T256, 21, 0.0, "register", core=4)


@pytest.mark.parametrize(
    "rows,f,k,mode",
    [(32, 2049, 47, "reflect"), (2048, 513, 13, "reflect"),
     (37, 4096, 47, "wrap"), (37, 513, 13, "edge"), (37, 2095, 47, "valid"),
     (5, 17, 17, "reflect"), (3, 40, 93, "wrap"), (1, 300, 255, "edge"),
     # offline pass 1 (hop 4096, K = 187) and pass 2 (hop 256, K = 13)
     (41, 8193, 187, "reflect"), (643, 513, 13, "reflect"),
     # past the old 255 cap: fs 8000 hop 1024, and a 50 KB row segment
     # (above the 48 KB a block takes without an opt-in)
     (32, 2049, 257, "reflect"), (1, 600, 12289, "wrap"),
     (2, 2304, 257, "valid")],
)
def test_freq_kernel_matches_twin(cuda_device, rows, f, k, mode):
    rng = np.random.default_rng(10)
    x = _mags(rng, rows, f, device=cuda_device)
    before = mc.sliding_median_boundary.launches
    got = mc.sliding_median_boundary(x, k, mode)
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.launches == before + 1
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


def _bf16(rng, *shape, device):
    return _mags(rng, *shape, device=device).to(torch.bfloat16)


@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [  # #4: the 512-stream hop-256 step at B = 16 and B = 1 (wrap, K = 11)
     ((512, 21, 513), (512, 16, 513), T256, 21, 0.0),
     ((512, 21, 513), (512, 1, 513), T256, 21, 0.0),
     # #4's padded branch: one input, taps before row 0 read the fill
     ((256, 64, 513), (256, 0, 513), tuple(range(-5, 6)), 0, 0.0),
     # #1 bf16, the 512-stream fleet's replicate (duplicated taps) and
     # valid borders, past 4096 streams
     ((64, 21, 513), (64, 32, 513), T256, 21, 0.0),
     ((512, 5, 1024), (512, 16, 1024), tuple(range(-5, 0)) + (0,) * 6, 5, float("inf")),
     ((512, 11, 1024), (512, 16, 1024), tuple(range(-11, 0)), 11, 0.0),
     ((4100, 11, 65), (4100, 2, 65), tuple(range(-11, 0)), 11, 0.0),
     # the rank route on bf16
     ((2, 183, 65), (2, 40, 65), tuple(range(-183, -137)) + tuple(range(-46, 1)),
      183, 0.0)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_kernel_wide_fleets_match_twin(cuda_device, dtype, a_shape, b_shape,
                                            offsets, start, fill):
    rng = np.random.default_rng(13)
    a = _mags(rng, *a_shape, device=cuda_device).to(dtype)
    b = _mags(rng, *b_shape, device=cuda_device).to(dtype)
    before = mc.tap_median_time.launches
    got = mc.tap_median_time(a, b, offsets, start, fill)
    torch.cuda.synchronize()
    assert mc.tap_median_time.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


@pytest.mark.parametrize(
    "rows,f,k,mode",
    [(8192, 513, 13, "reflect"), (8192, 1024, 13, "edge"), (8192, 1036, 13, "valid"),
     (37, 4096, 47, "wrap"), (1, 600, 12289, "wrap")],
)
def test_freq_kernel_bf16_matches_twin(cuda_device, rows, f, k, mode):
    rng = np.random.default_rng(14)
    x = _bf16(rng, rows, f, device=cuda_device)
    before = mc.sliding_median_boundary.launches
    got = mc.sliding_median_boundary(x, k, mode)
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


def _ties(rng, *shape, device):
    """Tie-heavy magnitudes: 8 levels."""
    x = np.floor(rng.random(shape, dtype=np.float32) * 8) / 8 + np.float32(0.125)
    return torch.from_numpy(x.astype(np.float32)).to(device)


K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((2, 183, 65), (2, 40, 65), K93, 183, 0.0),  # 44.1 kHz hop 32, wrap
     ((1, 64, 33), (1, 5, 33), tuple(range(-65, 0)), 64, 0.0),  # K = 65
     ((3, 127, 9), (3, 33, 9), tuple(range(-127, 0)), 127, float("inf")),  # valid
     ((1, 300, 17), (1, 0, 17), tuple(range(-93, 94)), 0, 0.0),  # K = 187
     ((2, 70, 9), (2, 7, 9), tuple(range(-128, 0)) + (0,) * 129, 7, 0.0),  # K = 257
     ((1, 900, 17), (1, 0, 17), tuple(range(-200, 201)), 0, 0.0),  # K = 401
     ((1, 10, 5), (1, 0, 5), tuple(range(-200, 201)), 0, float("inf"))],  # mostly fill
)
def test_time_rank_route_matches_twin(cuda_device, dtype, ties, a_shape, b_shape, offsets,
                                      start, fill):
    """K1's rank route (65 to 401 taps, ragged runs of 32 rows, wrap,
    valid, replicate and centered tap sets), tie-heavy and bf16, forced;
    and the wrapper, which counts the wide route its cost rule picks (the
    warp route on the few-output rows)."""
    rng = np.random.default_rng(len(offsets))
    make = _ties if ties else _mags
    a = make(rng, *a_shape, device=cuda_device).to(dtype)
    b = make(rng, *b_shape, device=cuda_device).to(dtype)
    assert mc.time_route(offsets) == "rank"
    want = mc.tap_median_time_plain(a, b, offsets, start, fill)
    assert torch.equal(mc._time_launch(a, b, offsets, start, fill, "rank"), want)
    route = mc.time_call_route(mc._int_offsets(offsets), start, a_shape[1] + b_shape[1],
                               a_shape[0], a_shape[2], mc._sm_count(cuda_device))
    before = mc.tap_median_time.routes[route]
    got = mc.tap_median_time(a, b, offsets, start, fill)
    torch.cuda.synchronize()
    assert mc.tap_median_time.routes[route] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill,run,lane_run,cols",
    [((2, 183, 65), (2, 40, 65), K93, 183, 0.0, 32, 3, 1),  # hop 32's two tap runs
     ((1, 183, 9), (1, 200, 9), K93, 183, 0.0, 96, 5, 1),  # the last run ends short
     ((2, 70, 9), (2, 7, 9), tuple(range(-128, 0)) + (0,) * 129, 7, 0.0, 77, 7, 2),  # replicate
     ((1, 392, 17), (1, 0, 17), tuple(range(-92, 1)), 92, 0.0, 352, 11, 1),  # median2d fl 93
     ((1, 392, 19), (1, 0, 19), tuple(range(-92, 1)), 92, 0.0, 160, 5, 4),  # 19 = 4 * 4 + 3
     ((2, 392, 13), (2, 0, 13), tuple(range(-92, 1)), 92, 0.0, 112, 7, 8),  # 2 merge runs
     ((1, 300, 17), (1, 0, 17), tuple(range(-93, 94)), 0, float("inf"), 160, 5, 2),  # fill
     ((1, 90, 33), (1, 0, 33), (0,) * 33 + tuple(range(-33, 1)), 0, float("inf"), 64, 3, 1)],
)
def test_time_rank_steps_match_twin(cuda_device, dtype, ties, a_shape, b_shape, offsets,
                                    start, fill, run, lane_run, cols):
    """K1's rank route with steps (``_time_launch(run=, lane_run=,
    cols=)``): hop 32's two tap runs, a replicate set with a repeated 0,
    median2d's valid fl 93 over 1, 4 and 8 adjacent columns a block (the
    last block's columns partly past F), centered taps past both ends,
    duplicates, a call whose last run ends at its last row, tie-heavy and
    bf16."""
    rng = np.random.default_rng(len(offsets) + run)
    make = _ties if ties else _mags
    a = make(rng, *a_shape, device=cuda_device).to(dtype)
    b = make(rng, *b_shape, device=cuda_device).to(dtype)
    got = mc._time_launch(a, b, offsets, start, fill, "rank", run=run, lane_run=lane_run,
                          cols=cols)
    torch.cuda.synchronize()
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def test_time_rank_route_takes_steps_where_planned(cuda_device):
    """The wrapper's plan for median2d's valid fl 93 on 2000 rows of 513
    takes the steps (as at the 4-minute track's 41,355); tap_median_time
    launches them, counted in ``steps``; the hop-32 step, whose walk from
    rank 0 the rank route would take, goes to the warp route."""
    offsets = tuple(range(-92, 1))
    sms = mc._sm_count(cuda_device)
    assert mc.time_rank_geometry(offsets, 92, 41_355 + 92, 1, 513, sms)[1] > 1
    assert mc.time_rank_geometry(offsets, 92, 2092, 1, 513, sms)[1] > 1
    rng = np.random.default_rng(93)
    a = _mags(rng, 2092, 513, device=cuda_device)
    rank, steps = mc.tap_median_time.routes["rank"], mc.tap_median_time.steps
    got = mc.tap_median_time(a, a[:0], offsets, 92)
    torch.cuda.synchronize()
    assert (mc.tap_median_time.routes["rank"], mc.tap_median_time.steps) == (rank + 1, steps + 1)
    assert torch.equal(got, mc.tap_median_time_plain(a, a[:0], offsets, 92))
    assert mc.time_rank_geometry(K93, 183, 183 + 32, 1, 65, sms)[1] == 1
    assert mc.time_call_route(K93, 183, 183 + 32, 1, 65, sms) == "warp"
    h, b = _mags(rng, 1, 183, 65, device=cuda_device), _mags(rng, 1, 32, 65, device=cuda_device)
    warp = mc.tap_median_time.routes["warp"]
    got = mc.tap_median_time(h, b, K93, 183)
    torch.cuda.synchronize()
    assert (mc.tap_median_time.routes["rank"], mc.tap_median_time.steps) == (rank + 1, steps + 1)
    assert mc.tap_median_time.routes["warp"] == warp + 1
    assert torch.equal(got, mc.tap_median_time_plain(h, b, K93, 183))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "t,offsets,start,shared_table",
    [(300, (-16353,) + tuple(range(-65, 1)), 0, True),  # a span of 16,354 rows
     (65536, (-70000,) + tuple(range(-65, 1)), 0, False),  # past the table's fit
     (40, (-70000,) + tuple(range(-32, 33)) + (70000,), 20, True)],  # both ends
)
def test_time_rank_route_any_span_matches_twin(cuda_device, t, offsets, start, shared_table, dtype):
    """Offsets of any span take the rank route: the far taps, which read
    only fill, move next to V (``time_rank_offsets``), and where the
    table still does not fit beside the keys the walk reads it from
    device memory."""
    rng = np.random.default_rng(16)
    a = _mags(rng, 1, t, 9, device=cuda_device).to(dtype)
    assert mc.time_route(offsets) == "rank"
    near = mc.time_rank_offsets(offsets, start, t)
    keys = mc.time_rank_keys(near, mc.time_rank_run(near))
    assert (keys + 4 * len(mc.time_rank_table(near)[2]) <= mc.SMEM_OPTIN) == shared_table
    want = mc.tap_median_time_plain(a, a[:, :0], offsets, start, float("inf"))
    assert torch.equal(mc._time_launch(a, a[:, :0], offsets, start, float("inf"), "rank"), want)
    route = mc.time_call_route(offsets, start, t, 1, 9, mc._sm_count(cuda_device))
    before = mc.tap_median_time.routes[route]
    got = mc.tap_median_time(a, a[:, :0], offsets, start, float("inf"))
    torch.cuda.synchronize()
    assert mc.tap_median_time.routes[route] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", list(range(mc.REGISTER_TAPS + 2, 32 * mc.WARP_SLOTS[-1], 2)))
def test_time_warp_route_every_k_matches_twin(cuda_device, k, dtype):
    """K1's warp route at every K it takes (65..255: four taps a lane up to
    128, eight above), forced, tie-heavy, under each border's tap set (the
    causal wrap's two runs in the pair form, the valid border's previous K
    frames, the replicate border's repeated 0, centered) with fill 0, +inf
    and -inf; a call of 3 streams x 9 output rows x 37 columns (108
    warps, a ragged last block of four)."""
    rng = np.random.default_rng(300 + k)
    m = k // 2
    h = 2 * k
    a = _ties(rng, 3, h, 37, device=cuda_device).to(dtype)
    b = _ties(rng, 3, 9, 37, device=cuda_device).to(dtype)
    wrap = tuple(range(-h + 1, -h + 1 + m)) + tuple(range(-m, 1))
    valid = tuple(range(-k, 0))
    replicate = tuple(range(-m, 0)) + (0,) * (m + 1)
    centered = tuple(range(-m, m + 1))
    for offsets, fill in ((wrap, 0.0), (valid, float("inf")), (replicate, 0.0),
                          (centered, float("-inf")), (centered, float("inf"))):
        assert len(offsets) == k and mc.time_route(offsets) == "rank"
        got = mc._time_launch(a, b, offsets, h, fill, "warp")
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, h, fill)), (offsets, fill)


def test_time_warp_route_is_the_hop32_step(cuda_device):
    """The hop-32 step's K = 93 takes the warp route through the wrapper
    at B = 32 and B = 1, counted in ``routes['warp']``; a tap count past
    256 raises on it, never falls back."""
    rng = np.random.default_rng(32)
    h = _mags(rng, 1, 183, 65, device=cuda_device)
    warp = mc.tap_median_time.routes["warp"]
    for t in (32, 1):
        fresh = _mags(rng, 1, t, 65, device=cuda_device)
        got = mc.tap_median_time(h, fresh, K93, 183)
        torch.cuda.synchronize()
        assert torch.equal(got, mc.tap_median_time_plain(h, fresh, K93, 183))
    assert mc.tap_median_time.routes["warp"] == warp + 2
    with pytest.raises(ZenError, match="warp route"):
        mc._time_launch(h, h[:, :0], tuple(range(-256, 1)), 183, 0.0, "warp")


def _around_k_star():
    k = mc.FREQ_RANK_MIN_TAPS
    return [k - 2, k] if k > 1 else [k, k + 2]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [65, 93, 127, 187, 257, 401, "k_star_below", "k_star"])
def test_freq_rank_route_matches_twin(cuda_device, k, mode, dtype, ties):
    """K2 from 65 to 401 taps (the rank route) and right at K* on both
    sides (the network below it, the rank route from it), 37 rows of
    1000 outputs (ragged tiles)."""
    if isinstance(k, str):
        k = _around_k_star()[k == "k_star"]
    rng = np.random.default_rng(k)
    f_in = 1000 + (k - 1 if mode == "valid" else 0)
    x = (_ties if ties else _mags)(rng, 37, f_in, device=cuda_device).to(dtype)
    route = mc.freq_route(k)
    assert route == ("rank" if k >= mc.FREQ_RANK_MIN_TAPS else "network")
    before = mc.sliding_median_boundary.routes[route]
    got = mc.sliding_median_boundary(x, k, mode)
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.routes[route] == before + 1
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


NETWORK_KS = list(range(1, 32, 2))  # K1's network to 31 taps
WIDE_NETWORK_KS = list(range(33, mc.REGISTER_TAPS + 1, 2))  # and on to 63
FREQ_NETWORK_KS = list(range(1, mc.FREQ_NETWORK_MAX_TAPS + 1, 2))  # K2's network, 1..63


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", NETWORK_KS)
def test_time_network_every_k_matches_twin(cuda_device, k, dtype):
    """K1's network kernel at every K up to 31, tie-heavy
    (test_time_network_33_to_63_matches_twin has 33..63): a causal pair
    with a duplicated offset 0 (ragged last run: 13 rows), and a centered
    one-input case whose taps read fill = inf on both ends."""
    rng = np.random.default_rng(k)
    a = _ties(rng, 3, 21, 130, device=cuda_device).to(dtype)
    b = _ties(rng, 3, 13, 130, device=cuda_device).to(dtype)
    causal = tuple(range(-(k - 3), 1)) + (0, 0) if k > 1 else (0,)
    centered = tuple(range(-(k // 2), k // 2 + 1))
    before = mc.tap_median_time.routes["register"]
    for offsets, start, fill in ((causal, 21, 0.0), (centered, 0, float("inf"))):
        assert mc.time_route(offsets) == "register" and len(offsets) == k
        got = mc.tap_median_time(a, b, offsets, start, fill)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))
    assert mc.tap_median_time.routes["register"] == before + 2


@pytest.mark.parametrize("run", [1, 2, 3, 8, 16])
def test_time_network_every_run_length_matches_twin(cuda_device, run):
    rng = np.random.default_rng(run)
    a = _mags(rng, 5, 21, 513, device=cuda_device)
    b = _mags(rng, 5, 19, 513, device=cuda_device)
    got = mc._time_launch(a, b, T256, 21, 0.0, "register", run=run)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, T256, 21))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", WIDE_NETWORK_KS)
def test_time_network_33_to_63_matches_twin(cuda_device, k, dtype):
    """33 to 63 taps run K1's network too (the counting kernel that took
    them is gone), tie-heavy: the pair form under a causal wrap (two tap
    runs, fill 0), and the one-input form centered with fill +inf and
    causal with fill -inf."""
    rng = np.random.default_rng(k)
    a = _ties(rng, 3, 70, 129, device=cuda_device).to(dtype)
    b = _ties(rng, 3, 13, 129, device=cuda_device).to(dtype)
    m = k // 2
    wrap = tuple(range(-69, -69 + m)) + tuple(range(-m, 1))
    centered = tuple(range(-m, m + 1))
    causal = tuple(range(-(k - 1), 1))
    before = mc.tap_median_time.routes["register"]
    for x, y, offsets, start, fill in ((a, b, wrap, 70, 0.0),
                                       (a, a[:, :0], centered, 0, float("inf")),
                                       (a, a[:, :0], causal, 0, float("-inf"))):
        assert mc.time_route(offsets) == "register" and len(offsets) == k
        got = mc.tap_median_time(x, y, offsets, start, fill)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, mc.tap_median_time_plain(x, y, offsets, start, fill))
    assert mc.tap_median_time.routes["register"] == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", FREQ_NETWORK_KS)
def test_freq_network_every_k_matches_twin(cuda_device, k, mode, dtype):
    """K2's network route at every K it takes (1..63), in the form its
    rule picks, tie-heavy, on rows of 513 outputs (one block a row) and
    2049 (three blocks of 683, or the core's finer chunks)."""
    rng = np.random.default_rng(100 + k)
    before = mc.sliding_median_boundary.routes["network"]
    for rows, f_out in ((37, 513), (3, 2049)):
        f_in = f_out + (k - 1 if mode == "valid" else 0)
        x = _ties(rng, rows, f_in, device=cuda_device).to(dtype)
        got = mc._freq_launch(x, k, mode, "network")
        assert got.dtype == dtype
        assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))
    if mc.freq_route(k) == "network":
        mc.sliding_median_boundary(x, k, mode)
        assert mc.sliding_median_boundary.routes["network"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [k for k in FREQ_NETWORK_KS if mc.freq_core_runs(k)])
def test_freq_core_every_shape_matches_twin(cuda_device, k, mode, dtype):
    """K2's shared core at every R it is built for at each K (5..63), on
    tie-heavy rows with +inf and -inf samples: 37 rows of 131 outputs (one
    block a row, a ragged last run), 3 of 2049 and 1 of 2049 (three blocks
    of 683, the hop-1024 step's B = 32 and B = 1 geometry)."""
    rng = np.random.default_rng(200 + k)
    for rows, f_out in ((37, 131), (3, 2049), (1, 2049)):
        f_in = f_out + (k - 1 if mode == "valid" else 0)
        x = _ties(rng, rows, f_in, device=cuda_device)
        x[torch.rand(x.shape, device=cuda_device) < 0.03] = float("inf")
        x[torch.rand(x.shape, device=cuda_device) < 0.03] = float("-inf")
        x = x.to(dtype)
        want = mc.sliding_median_boundary_plain(x, k, mode)
        for r in mc.freq_core_runs(k):
            got = mc._freq_launch(x, k, mode, "network", core=r)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            assert torch.equal(got, want), (rows, f_out, r)


def test_freq_network_takes_the_core_where_planned(cuda_device):
    """sliding_median_boundary counts a shared-core launch in ``cores``
    (and on the network route) where freq_network_form picks it (the
    clip's pass 2: 643 rows at K = 13; the hop-1024 step's K = 47 at B =
    32 and B = 1), and takes the per-output network on beat-track's 64
    rows and at hop 32's K = 1; a shape the core is not built for raises."""
    rng = np.random.default_rng(12)
    network, cores = (mc.sliding_median_boundary.routes["network"],
                      mc.sliding_median_boundary.cores)
    for x, k, took in ((_mags(rng, 643, 513, device=cuda_device), 13, 1),
                       (_mags(rng, 32, 2049, device=cuda_device), 47, 1),
                       (_mags(rng, 1, 2049, device=cuda_device), 47, 1),
                       (_mags(rng, 64, 513, device=cuda_device), 13, 0),
                       (_mags(rng, 32, 65, device=cuda_device), 1, 0)):
        got = mc.sliding_median_boundary(x, k, "reflect")
        torch.cuda.synchronize()
        assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, "reflect"))
        network, cores = network + 1, cores + took
        assert (mc.sliding_median_boundary.routes["network"],
                mc.sliding_median_boundary.cores) == (network, cores)
    with pytest.raises(ZenError, match="no shared core"):
        mc._freq_launch(x, 13, "reflect", "network", core=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "rows,f_in,k,mode",
    [(4, 8193, 16_385, "reflect"),  # the first kernel's counting took these
     (1, 58_112, 57_857, "valid"),  # its widest
     (2, 65_792, 65_537, "valid")],  # past its cap
)
def test_freq_rank_store_matches_twin(cuda_device, rows, f_in, k, mode, dtype):
    """K2's rank route past shared memory, tie-heavy: at these K its sort
    takes the key store (the counting kernel that took them is gone); the
    wrapper keeps the store for the R=4 row of 8193 outputs a row and
    counts the launch there (the two pre-padded rows of 256 outputs take
    the select route: test_freq_select_matches_twin)."""
    assert mc.freq_route(k) == "rank" and mc.freq_rank_store(k) == "scratch"
    x = _ties(np.random.default_rng(k), rows, f_in, device=cuda_device).to(dtype)
    got = mc._freq_launch(x, k, mode, "rank")
    assert got.dtype == dtype
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))
    if mc.freq_call_route(k, rows, f_in, mode, mc._sm_count(x.device)) == "rank":
        before = mc.sliding_median_boundary.stores["scratch"]
        assert torch.equal(mc.sliding_median_boundary(x, k, mode), got)
        assert mc.sliding_median_boundary.stores["scratch"] == before + 1


@pytest.mark.parametrize("chunk", [32, 64, 1024])
@pytest.mark.parametrize("mode", ["reflect", "valid"])
@pytest.mark.parametrize("k", [13, 187, 401])
def test_freq_rank_store_small_chunk_matches_twin(cuda_device, k, mode, chunk):
    """The key store at small K with a small chunk of shared memory, so
    that most of its stages run as passes over device memory: units of
    1024 outputs on rows of 2100 (the last ragged)."""
    f_in = 2100 + (k - 1 if mode == "valid" else 0)
    x = _ties(np.random.default_rng(k + chunk), 5, f_in, device=cuda_device)
    got = mc._freq_launch(x, k, mode, "rank", chunk=chunk)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_time_select_matches_twin(cuda_device, causal, dtype):
    """K1 at HPRConfig(384000, hop=1)'s 25,601 taps, tie-heavy: one output
    row's keys pass shared memory, so the wrapper takes the select route
    (the K1 key store that took it is gone) and counts it there. Causal:
    the step's pair form (history 51,199 rows, 32 fresh, 3 bins);
    centered: the one-input form from row 13,100 of 26,000 (fill inf),
    where every tap of a row is distinct (no tap reads only fill)."""
    cfg = HPRConfig(fs=384000.0, hop=1, causal=causal)
    rng = np.random.default_rng(25_601)
    if causal:
        a = _ties(rng, 1, cfg.time_history, 3, device=cuda_device).to(dtype)
        b, start, fill = _ties(rng, 1, 32, 3, device=cuda_device).to(dtype), cfg.time_history, 0.0
    else:
        a = _ties(rng, 1, 26_000, 2, device=cuda_device).to(dtype)
        b, start, fill = a[:, :0], 13_100, float("inf")
    offsets = cfg.time_offsets
    t_v = a.shape[1] + b.shape[1]
    assert not mc.time_rank_plan(offsets, start, t_v)[2]
    assert mc.time_call_route(offsets, start, t_v, 1, a.shape[2],
                              mc._sm_count(a.device)) == "select"
    before = mc.tap_median_time.routes["select"]
    got = mc.tap_median_time(a, b, offsets, start, fill)
    torch.cuda.synchronize()
    assert mc.tap_median_time.routes["select"] == before + 1
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


@pytest.mark.parametrize("run", [1, 8, 32])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((2, 183, 65), (2, 40, 65), K93, 183, 0.0),
     ((1, 900, 17), (1, 0, 17), tuple(range(-200, 201)), 0, float("inf")),
     ((1, 70, 6), (1, 3, 6), tuple(range(-69, 0)) + (0,) * 60, 3, 0.0)],
)
def test_time_select_runs_match_twin(cuda_device, a_shape, b_shape, offsets, start, fill, run):
    """K1's select route at runs of 1 to 32 output rows a block, on the
    shapes the key store's small-chunk test took: duplicated taps (the
    replicate border's offset 0, 61 times) counted by the table."""
    rng = np.random.default_rng(run)
    a = _ties(rng, *a_shape, device=cuda_device)
    b = _ties(rng, *b_shape, device=cuda_device)
    got = mc._time_launch(a, b, offsets, start, fill, "select", run=run)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_select_past_shared_memory_matches_twin(cuda_device, dtype):
    """K1's select route where a row's 70,001 taps' order bits pass shared
    memory: each pass reads them from V through L2 (100 output rows of 2
    columns, a block each, every tap inside V)."""
    rng = np.random.default_rng(70_001)
    a = _ties(rng, 1, 70_100, 2, device=cuda_device).to(dtype)
    offsets = tuple(range(-70_000, 1))
    _, run, staged, threads = mc.time_select_plan(offsets, 70_000, 70_100, 1, 2,
                                                  mc._sm_count(a.device))
    assert run == 1 and not mc.select_layout(staged, threads)[0]
    before = mc.tap_median_time.routes["select"]
    got = mc.tap_median_time(a, a[:, :0], offsets, 70_000)
    torch.cuda.synchronize()
    assert mc.tap_median_time.routes["select"] == before + 1
    assert torch.equal(got, mc.tap_median_time_plain(a, a[:, :0], offsets, 70_000))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "rows,f_in,k,mode",
    [(1, 58_112, 57_857, "valid"),  # shared memory holds the row's order bits
     (2, 65_792, 65_537, "valid"),  # they pass it: read through L2
     (2, 64, mc.MAX_FREQ_TAPS, "wrap"),  # 64 samples, each counted ~32,752 times
     (3, 100, 1001, "edge"),
     (1, 200, 399, "reflect")],  # K = 2F - 1: the row's samples, counted twice
)
def test_freq_select_matches_twin(cuda_device, rows, f_in, k, mode, dtype):
    """K2's rows of few outputs, tie-heavy: the wrapper takes the select
    route and counts it there."""
    x = _ties(np.random.default_rng(k), rows, f_in, device=cuda_device).to(dtype)
    assert mc.freq_call_route(k, rows, f_in, mode, mc._sm_count(x.device)) == "select"
    before = mc.sliding_median_boundary.routes["select"]
    got = mc.sliding_median_boundary(x, k, mode)
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.routes["select"] == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


def test_select_orders_nan_and_signed_zeros_as_the_rank_routes(cuda_device):
    """-0.0, +0.0, +-1, +inf and NaN in equal shares: the select route's
    outputs are the rank routes' bit for bit (-0.0 below +0.0, NaN above
    +inf), K1 and K2."""
    levels = torch.tensor([-0.0, 0.0, 1.0, -1.0, float("inf"), float("nan")], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = levels[torch.randint(0, 6, (3, 400), device=cuda_device, generator=gen)]
    for k, mode in ((65, "wrap"), (187, "reflect"), (33, "valid")):
        got = mc._freq_launch(x, k, mode, "select")
        assert torch.equal(got.view(torch.int32), mc._freq_launch(x, k, mode, "rank").view(
            torch.int32))
    a, b = x[:, :300, None].expand(3, 300, 2).contiguous(), x[:, 300:, None].expand(
        3, 100, 2).contiguous()
    got = mc._time_launch(a, b, K93, 183, 0.0, "select", run=8)
    assert torch.equal(got.view(torch.int32),
                       mc._time_launch(a, b, K93, 183, 0.0, "rank").view(torch.int32))


@pytest.mark.parametrize("tile", [1, 7, 64, 256])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [33, 187, 401])
def test_freq_select_tiles_match_twin(cuda_device, k, mode, tile):
    """K2's select route at 1 to 256 outputs a block, every border, on
    rows of 300 outputs (K = 401 under wrap and edge: the row's samples,
    weighted)."""
    f_in = 300 + (k - 1 if mode == "valid" else 0)
    x = _ties(np.random.default_rng(k + tile), 5, f_in, device=cuda_device)
    got = mc._freq_launch(x, k, mode, "select", tile=tile)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("tile,run", [(t, 1) for t in mc.FREQ_RANK_TILES]
                         + [(96, 3), (160, 5), (288, 9), (832, 13)])
@pytest.mark.parametrize("k", [13, 47, 187, 257])
def test_freq_rank_every_tile_matches_twin(cuda_device, k, tile, run):
    """K2's rank route at each tile and run of outputs a thread (the walk
    from rank 0 at run 1, the steps past it), whichever the wrapper picks
    for K: ragged last tiles whose last threads' runs end short, tie-heavy
    rows."""
    rng = np.random.default_rng(k + tile)
    x = _ties(rng, 5, 1000, device=cuda_device)
    got = mc._freq_launch(x, k, "reflect", "rank", tile=tile, run=run)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, "reflect"))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k", [65, 187])
def test_freq_rank_steps_route_matches_twin(cuda_device, k, mode, dtype, ties):
    """K2's rank route where the wrapper's plan takes the steps (400 rows
    of 2000 outputs), every border, f32 and bf16, tie-heavy."""
    rng = np.random.default_rng(k + 1)
    f_in = 2000 + (k - 1 if mode == "valid" else 0)
    x = (_ties if ties else _mags)(rng, 400, f_in, device=cuda_device).to(dtype)
    assert mc.freq_rank_plan(k, 400, f_in, mode, mc._sm_count(x.device))[1] > 1
    wrapper = mc.sliding_median_boundary
    before = wrapper.routes["rank"], wrapper.steps
    got = wrapper(x, k, mode)
    torch.cuda.synchronize()
    assert (wrapper.routes["rank"], wrapper.steps) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


# K2's steps at each key count a block may sort, n = key_count(tile + k - 1):
# (k, tile, run) from one warp's 32 keys to 8192 (warp_merge_sort's slices of
# 256 and its merge passes past them; the track's pass 1 at 512)
FREQ_SORT_GEOMETRIES = [(13, 18, 3), (13, 48, 3), (47, 80, 5), (187, 69, 3), (187, 320, 5),
                        (187, 224, 7), (187, 832, 13), (257, 1785, 7), (3001, 4250, 17)]


def _signed_ties(rng, *shape, device, dtype):
    """Tie-heavy values of both signs with -0.0, +0.0, -inf and +inf."""
    x = (np.floor(rng.random(shape, dtype=np.float32) * 8) - 4) / 4
    special = np.array([-0.0, 0.0, -np.inf, np.inf], dtype=np.float32)
    pick = rng.random(shape) < 0.1
    x = np.where(pick, special[rng.integers(0, 4, shape)], x).astype(np.float32)
    return torch.from_numpy(x).to(device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k,tile,run", FREQ_SORT_GEOMETRIES)
def test_freq_rank_steps_sort_matches_twin(cuda_device, k, tile, run, mode, dtype):
    """K2's steps with their warp sort at every key count from 32 to 8192,
    every border, f32 and bf16, tie-heavy values of both signs with signed
    zeros and infinities: equal to the twin (whose kthvalue does not tell
    -0.0 from +0.0; test_steps_sort_orders_each_block holds the sort's
    order bitwise)."""
    rng = np.random.default_rng(k + tile)
    f_in = 2 * tile + 37 + (k - 1 if mode == "valid" else 0)
    x = _signed_ties(rng, 3, f_in, device=cuda_device, dtype=dtype)
    want = mc.sliding_median_boundary_plain(x, k, mode)
    got = mc._freq_launch(x, k, mode, "rank", tile=tile, run=run)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _order_sorted(v: np.ndarray) -> np.ndarray:
    """float32 values sorted as the rank keys order them (-0.0 below +0.0)."""
    u = v.astype(np.float32).view(np.uint32)
    bits = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    bits = np.sort(bits, axis=-1)
    return np.where(bits >> 31 == 1, bits & np.uint32(0x7FFFFFFF), ~bits).astype(
        np.uint32).view(np.float32)


@pytest.mark.parametrize("k,tile,run", FREQ_SORT_GEOMETRIES)
def test_steps_sort_orders_each_block(cuda_device, k, tile, run):
    """The sort alone: the split build that ends K2's steps after the sort
    (ZEN_RANK_CUT = 2) writes each block's sorted staged values at ranks
    0 .. tile - 1 in place of its medians; they equal the block's staged
    row segment sorted on the host, bitwise (-0.0 below +0.0)."""
    rng = np.random.default_rng(tile)
    f_in = 2 * tile + 37 + k - 1
    x = _signed_ties(rng, 2, f_in, device=cuda_device, dtype=torch.float32)
    host = x.cpu().numpy()
    f_out = f_in - k + 1
    want = np.empty((2, f_out), np.float32)
    for j0 in range(0, f_out, tile):
        live = min(tile, f_out - j0)
        want[:, j0:j0 + live] = _order_sorted(host[:, j0:j0 + live + k - 1])[:, :live]
    got = mc._freq_launch(x, k, "valid", "rank", tile=tile, run=run, cut=2)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))


# K1's steps at each key count a column may sort (staged rows rounded up to a
# power of two) over 1, 2, 4 and 8 adjacent columns a block:
# (offsets, start, run, lane_run, cols)
TIME_SORT_GEOMETRIES = [
    (tuple(range(-7, 8)), 7, 40, 5, 8),  # 54 rows: 64 keys
    ((0,) * 33 + tuple(range(-33, 1)), 33, 64, 3, 2),  # duplicates: 128 keys
    (tuple(range(-92, 1)), 92, 160, 5, 4),  # median2d's fl 93: 256 keys a column
    (tuple(range(-92, 1)), 92, 144, 9, 8),  # 16 threads a column
    (tuple(range(-92, 1)), 92, 352, 11, 1),  # 512 keys
    (tuple(range(-92, 1)), 92, 420, 7, 2),
    (tuple(range(-200, 201)), 0, 384, 3, 1),  # centered K = 401: 1024 keys
    (tuple(range(-1000, 1)), 1000, 300, 3, 1),  # 2048 keys
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets,start,run,lane_run,cols", TIME_SORT_GEOMETRIES)
def test_time_rank_steps_sort_matches_twin(cuda_device, offsets, start, run, lane_run, cols,
                                           dtype):
    """K1's steps with their warp sort at every key count from 64 to 2048
    a column, 1 to 8 columns a block (the last block's columns partly past
    F), fill -inf and +inf, f32 and bf16, tie-heavy values of both signs
    with signed zeros and infinities: equal to the twin."""
    rng = np.random.default_rng(len(offsets) + run)
    a = _signed_ties(rng, 1, 2 * run + start + 11, 13, device=cuda_device, dtype=dtype)
    b = _signed_ties(rng, 1, 5, 13, device=cuda_device, dtype=dtype)
    for fill in (float("-inf"), float("inf")):
        got = mc._time_launch(a, b, offsets, start, fill, "rank", run=run, lane_run=lane_run,
                              cols=cols)
        torch.cuda.synchronize()
        assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def test_wrappers_refuse_float16_and_mixed_dtypes(cuda_device):
    x = torch.ones((2, 9, 33), device=cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    with pytest.raises(ZenError, match="float32 or bfloat16"):
        mc.tap_median_time(x.half(), x.half(), T1024, 5)
    with pytest.raises(ZenError, match="float32 or bfloat16"):
        mc.sliding_median_boundary(x.half(), 5, "wrap")
    with pytest.raises(ZenError, match="differ in dtype"):
        mc.tap_median_time(x, x.bfloat16(), T1024, 5)
    assert mc.tap_median_time.launches == n_time
    assert mc.sliding_median_boundary.launches == n_freq


@pytest.mark.parametrize("kw", [{"stream_state": "bf16"}, {"border": "valid"},
                                {"border": "replicate"}])
def test_fleet_variants_on_card_match_cpu(cuda_device, kw):
    """256 streams at B = 4 < H (fs 8000, hop 64), card vs CPU port
    under chip_smoke's flip rule."""
    import chip_smoke as cs

    rng = np.random.default_rng(15)
    audio = rng.standard_normal((256, 64 * 24)).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        ms = MultiStreamHPR(256, 8000.0, 64, device=dev, **kw)
        x = torch.from_numpy(audio).reshape(256, 6, 4, 64)
        outs[str(dev)] = torch.cat([ms.process_block(x[:, j]) for j in range(6)],
                                   dim=2).cpu().numpy()
    assert ms.state.feat_hist.dtype == (torch.bfloat16 if kw.get("stream_state") else torch.float32)
    cs.compare_stream(ms.cfg, audio, [4] * 6, outs[str(cuda_device)], outs["cpu"],
                      ("harmonic", "percussive", "residual"))


def test_unsupported_cuda_input_raises_without_fallback(cuda_device):
    x = torch.ones((2, 9, 33), device=cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    with pytest.raises(ZenError):
        mc.tap_median_time(x, x, (0,) * (mc.MAX_TIME_TAPS + 2), 0)
    with pytest.raises(ZenError):
        mc.sliding_median_boundary(x, mc.MAX_FREQ_TAPS + 2, "wrap")
    with pytest.raises(ZenError):
        mc.sliding_median_boundary(x.double(), 5, "wrap")  # float64
    with pytest.raises(ZenError):
        mc.sliding_median_boundary(x.transpose(1, 2), 5, "wrap")  # strided
    assert mc.tap_median_time.launches == n_time
    assert mc.sliding_median_boundary.launches == n_freq


def test_realtime_on_card_matches_cpu(cuda_device):
    """Small-config stream, card vs CPU port: 5e-5 x scale (the
    realtime parity class); noise input keeps every bin far above FFT
    round-off, so no hard-mask bin sits near enough to beta to flip."""
    rng = np.random.default_rng(11)
    audio = rng.standard_normal(64 * 80).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        rt = HPRRealtime(8000.0, 64, device=dev)
        outs[str(dev)] = rt.process_stream(audio, block_hops=7)
    want, got = outs["cpu"], outs[str(cuda_device)]
    for i in range(3):
        scale = max(1.0, float(np.abs(want[i]).max()))
        np.testing.assert_allclose(got[i] / scale, want[i] / scale, atol=5e-5)


def test_multistream_on_card_counts_kernel_launches(cuda_device):
    ms = MultiStreamHPR(4, 8000.0, 64, device=cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    ms.process_block(torch.randn(4, 5, 64))
    assert mc.tap_median_time.launches == n_time + 1
    assert mc.sliding_median_boundary.launches == n_freq + 1


def test_torch_median_impl_rejects_cuda_tensors(cuda_device):
    """median_impl='torch' (what convert maps zen_tpu's 'xla' to) pins
    the plain reference, which takes CPU tensors only: on CUDA tensors
    it raises instead of running torch.kthvalue on the card."""
    cfg = HPRConfig(fs=8000.0, hop=64, causal=True, median_impl="torch")
    x = torch.ones((1, 4, sp.num_bins(cfg)), device=cuda_device)
    with pytest.raises(ZenError, match="CPU tensors only"):
        sp.freq_filtered(x, cfg)
    with pytest.raises(ZenError, match="CPU tensors only"):
        sp.time_filtered_tail(x, cfg, 0)
    with pytest.raises(ZenError, match="CPU tensors only"):
        HPRRealtime(8000.0, 64, median_impl="torch", device=cuda_device).process_block(
            torch.zeros((2, 64)))


def _hold_offline(sep, x):
    """Each pass of ``sep`` on the card vs the port on the CPU under
    chip_smoke's flip rule (pass 2 fed the card's intermediate), and
    process() bitwise against the composition of its two passes."""
    import chip_smoke as cs

    h, p, r = sep.process(x)
    pass1, st1 = cs.hold_pass_on_cpu(sep.cfg_h, x)
    pass2, st2 = cs.hold_pass_on_cpu(sep.cfg_p, pass1["percussive"] + pass1["residual"])
    assert torch.equal(h, pass1["harmonic"])
    assert torch.equal(p, pass2["percussive"]) and torch.equal(r, pass2["residual"])
    assert all(o.device == x.device and o.dtype == torch.float32 for o in (h, p, r))
    return st1, st2


def test_offline_on_card_matches_cpu(cuda_device):
    """HPRIOffline at BASELINE.json configs[0] (44.1 kHz, 4096 / 256,
    beta 2.5) on a clip of the reference's length, with K2 at K = 187
    (pass 1) and K1 centered K = 11 (pass 2) on the card."""
    import chip_smoke as cs

    sep = HPRIOffline(44100.0, 4096, 256, 2.5, 2.5, device=cuda_device)
    x = torch.from_numpy(cs.synthetic_mix(cs.CLIP_SAMPLES, 44100.0, seed=3)).to(cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    _hold_offline(sep, x)
    assert mc.tap_median_time.launches > n_time
    assert mc.sliding_median_boundary.launches > n_freq


def test_configs_past_the_old_caps_run_on_card(cuda_device):
    """fs 8000 / hop 1024 (frequency K = 257) streams and separates on
    the card; the offline pass 2 at hop 64 uses K1's register kernel."""
    rng = np.random.default_rng(12)
    audio = rng.standard_normal(1024 * 12).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        outs[str(dev)] = HPRRealtime(8000.0, hop=1024, device=dev).process_stream(audio, 4)
    for i in range(3):
        want = outs["cpu"][i]
        scale = max(1.0, float(np.abs(want).max()))
        got = outs[str(cuda_device)][i]
        np.testing.assert_allclose(got / scale, want / scale, atol=5e-5)
    sep = HPRIOffline(8000.0, 1024, 64, device=cuda_device)
    _hold_offline(sep, torch.from_numpy(audio).to(cuda_device))


# ---------------- the copy-only mirrors (#9, #10) and the timer ----------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,start,t_out",
    [((512, 53, 513), 21, 32),  # hbm_pattern's 512-stream slab
     ((3, 9, 65), 5, 4), ((1, 7, 1), 0, 7), ((5, 40, 257), 39, 1), ((2, 6, 33), 6, 0),
     # ragged last runs of 8 rows, ragged column tiles of 128, many streams
     ((4100, 13, 65), 2, 11), ((2, 40, 129), 1, 39), ((3, 30, 128), 0, 17)],
)
def test_rows_copy_matches_twin(cuda_device, dtype, shape, start, t_out):
    from zen_tpu_torch.ops import probe_cuda as pc

    x = _mags(np.random.default_rng(13), *shape, device=cuda_device).to(dtype)
    before = pc.rows_copy.launches
    got = pc.rows_copy(x, start, t_out)
    torch.cuda.synchronize()
    assert pc.rows_copy.launches == before + (1 if t_out else 0)
    assert got.dtype == dtype and torch.equal(got, pc.rows_copy_plain(x, start, t_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge"])
@pytest.mark.parametrize(
    "shape,k",
    [((16384, 513), 13),  # hbm_pattern's folded fresh rows
     ((37, 65), 13), ((5, 17), 1), ((3, 2049), 47), ((2, 3, 300), 187), ((1, 40), 257),
     # the network route's staging: rows of one, two and three blocks
     ((7, 1024), 31), ((7, 1025), 13), ((3, 2049), 5)],
)
def test_segment_copy_matches_twin(cuda_device, dtype, mode, shape, k):
    from zen_tpu_torch.ops import probe_cuda as pc

    if mode == "reflect" and (k - 1) // 2 > shape[-1] - 1:
        k = 2 * (shape[-1] - 1) - 1  # the widest reflect fitting the row
    x = _mags(np.random.default_rng(14), *shape, device=cuda_device).to(dtype)
    before = pc.segment_copy.launches
    got = pc.segment_copy(x, k, mode)
    torch.cuda.synchronize()
    assert pc.segment_copy.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, pc.segment_copy_plain(x, k, mode))


def test_copy_mirrors_refuse_what_the_kernels_do_not_take(cuda_device):
    from zen_tpu_torch.ops import probe_cuda as pc

    x = torch.ones((4, 9, 65), device=cuda_device)
    with pytest.raises(ZenError, match="contiguous"):
        pc.rows_copy(x.transpose(0, 1), 0, 2)
    with pytest.raises(ZenError, match="contiguous"):
        pc.segment_copy(x[..., ::2], 13, "wrap")
    with pytest.raises(ZenError):
        pc.segment_copy(x, 13, "valid")


def test_device_ms_times_the_card_not_the_host(cuda_device):
    """A call that sleeps 20 ms on the host beside a small kernel: the
    spin covers the host's time, or device_ms raises; it never returns
    the host's wall time."""
    import time

    from zen_tpu_torch.runtime import profiling

    x = torch.ones(1 << 20, device=cuda_device)

    def slow_host(t):
        time.sleep(0.02)
        return t * 1.0

    try:
        ms = profiling.device_ms(slow_host, x, iters=3, repeats=2, warmup=1)
    except ZenError:
        return
    assert 0 < ms < 5.0


def test_device_ms_refuses_a_synchronizing_call(cuda_device):
    """A call that waits for the card (here a read back to the host)
    leaves the card idle inside every window: device_ms raises."""
    from zen_tpu_torch.runtime import profiling

    x = torch.ones(1 << 16, device=cuda_device)
    with pytest.raises(ZenError, match="spin"):
        profiling.device_ms(lambda t: t * float(t[0].item()), x, iters=4, repeats=1)


def test_device_ms_matches_a_kernel_alone(cuda_device):
    """A chain of one kernel: device_ms within 20% of CUDA events around
    a long run of the same launches after a synchronize."""
    from zen_tpu_torch.runtime import profiling

    x = torch.ones(1 << 24, device=cuda_device)
    ms = profiling.device_ms(lambda t: t * 1.0000001, x, iters=20, repeats=3)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    y = x
    torch.cuda.synchronize()
    start.record()
    for _ in range(50):
        y = y * 1.0000001
    stop.record()
    stop.synchronize()
    ref = start.elapsed_time(stop) / 50
    assert abs(ms - ref) <= 0.2 * ref


def test_block_step_does_not_synchronize(cuda_device):
    """The streaming step enqueues without waiting on the card: the
    percussive-only fleet (one stem row of the OLA carry) and the
    harmonic + residual rows (an index of two rows apart)."""
    from zen_tpu_torch.drivers import realtime as rt
    from zen_tpu_torch.engine.config import OUTPUT_HARMONIC, OUTPUT_PERCUSSIVE, OUTPUT_RESIDUAL

    for outputs in (OUTPUT_PERCUSSIVE, OUTPUT_HARMONIC | OUTPUT_RESIDUAL):
        cfg = HPRConfig(fs=8000.0, hop=64, causal=True, outputs=outputs)
        state = rt.init_state(cfg, 4, cuda_device)
        blocks = torch.randn(4, 5, 64, device=cuda_device)
        rt.block_step(cfg, state, blocks)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rt.block_step(cfg, state, blocks)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_reset_streams_does_not_synchronize(cuda_device):
    """Recycling stream slots enqueues fills and never waits on the card
    (no index tensor is copied up from the host); the reset slots hold a
    fresh stream's state, the others keep theirs."""
    ms = MultiStreamHPR(6, 8000.0, 64, device=cuda_device)
    ms.process_block(torch.randn(6, 5, 64))
    kept = [t.clone() for t in ms.state]
    fresh = MultiStreamHPR(6, 8000.0, 64, device=cuda_device).state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms.reset_streams([4, 1, 2, -1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, was, new in zip(ms.state, kept, fresh):
        assert torch.equal(got[[1, 2, 4, 5]], new[[1, 2, 4, 5]])
        assert torch.equal(got[[0, 3]], was[[0, 3]])


@pytest.mark.parametrize("kw", [{"use_sse": True}, {"use_sse": True, "stream_state": "bf16"},
                                {"fft_impl": "dft_bf16"}, {"fft_impl": "dft"},
                                {"fft_impl": "dft_f32"}])
def test_sse_and_dft_block_step_do_not_synchronize(cuda_device, kw):
    """The SSE step (box means built from slices, a divisor made on the
    card) and the DFT steps (matrices uploaded once, then cached) enqueue
    without waiting on the card, B < H and B >= H."""
    from zen_tpu_torch.drivers import realtime as rt

    cfg = HPRConfig(fs=8000.0, hop=64, causal=True, **kw)
    for b in (5, 20):
        state = rt.init_state(cfg, 4, cuda_device)
        blocks = torch.randn(4, b, 64, device=cuda_device)
        rt.block_step(cfg, state, blocks)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rt.block_step(cfg, state, blocks)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("mode", ["dft_f32", "dft", "dft_bf16"])
def test_dft_modes_ignore_the_global_tf32_flags(cuda_device, mode):
    """Each mode fixes its own arithmetic: the same bits whatever the
    global TF32 switches say, and the switches are left as they were."""
    from zen_tpu_torch.ops import fft as zfft

    x = torch.randn(300, 512, device=cuda_device)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    outs = []
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.backends.cudnn.allow_tf32 = flag
            outs.append(zfft.dft_matmul(x, 512, 1024, False, mode))
            assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(outs[0], outs[1])
    ref = torch.fft.rfft(x.double(), n=1024)
    got = outs[0].double()
    err = float((torch.cat([ref.real, ref.imag], -1) - got).abs().max() / ref.abs().max())
    assert err < {"dft_f32": 1e-6, "dft": 2e-5, "dft_bf16": 1e-2}[mode], err


@pytest.mark.parametrize("mode", ["dft_f32", "dft", "dft_bf16"])
def test_dft_matmuls_on_card_match_cpu(cuda_device, mode):
    """The card's products of the mode's operands against the CPU's:
    bf16 products are exact on both, so only the sums' order differs
    (1e-5 x |x| @ |W|, tests/test_torch_dft.py's bound)."""
    from zen_tpu_torch.ops import fft as zfft

    x = torch.randn(64, 512)
    got = zfft.dft_matmul(x.to(cuda_device), 512, 1024, False, mode).cpu()
    want = zfft.dft_matmul(x, 512, 1024, False, mode)
    w = torch.from_numpy(zfft._dft_mats(512, 1024)[0])
    assert ((got - want).abs() <= 1e-5 * (x.abs() @ w.abs())).all()


def test_sse_box_mean_on_card_bitwise_to_cpu(cuda_device):
    """The box mean's additions and its division run in the same order
    on the card: bitwise to the CPU, +inf prefill rows included."""
    from zen_tpu_torch.ops.box import sliding_mean

    rng = np.random.default_rng(21)
    x = 1.0 / np.square(rng.random((8, 53, 513), dtype=np.float32) + np.float32(1e-3))
    x[:, :21] = np.inf
    x = torch.from_numpy(x.astype(np.float32))
    for offs, dim, boundary in ((T256, -2, "zero"), (tuple(range(-6, 7)), -1, "reflect"),
                                (tuple(range(-23, 24)), -1, "wrap"), (T1024, -2, "zero")):
        want = sliding_mean(x, offs, dim, boundary, float("inf"))
        got = sliding_mean(x.to(cuda_device), offs, dim, boundary, float("inf")).cpu()
        assert torch.equal(got, want), (offs[:3], boundary)


def test_sse_streams_on_card_match_cpu_without_median_launches(cuda_device):
    """SSE at fs 8000 / hop 64, 32 streams, B = 4 < H and B = 20 >= H:
    card vs CPU port within the oracle class (chip_smoke.SSE_ATOL), no
    median kernel launched."""
    import chip_smoke as cs

    rng = np.random.default_rng(23)
    audio = rng.standard_normal((32, 64 * 40)).astype(np.float32)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    for b in (4, 20):
        outs = {}
        for dev in ("cpu", cuda_device):
            ms = MultiStreamHPR(32, 8000.0, 64, use_sse=True, device=dev)
            x = torch.from_numpy(audio).reshape(32, -1, b, 64)
            outs[str(dev)] = torch.cat([ms.process_block(x[:, j]) for j in range(x.shape[1])],
                                       dim=2).cpu().numpy()
        cs.rel_err(outs[str(cuda_device)], outs["cpu"], cs.SSE_ATOL, f"SSE B={b}")
    assert (mc.tap_median_time.launches, mc.sliding_median_boundary.launches) == (n_time, n_freq)


def test_checkpointed_process_blocked_resumes_bitwise_on_card(cuda_device, tmp_path):
    """A kill after a durable segment and a resume give the uninterrupted
    process_blocked's stems, bit for bit, as tensors on the card."""
    rng = np.random.default_rng(21)
    audio = torch.from_numpy(rng.standard_normal(44100).astype(np.float32)).to(cuda_device)
    sep = HPRIOffline(44100.0, 4096, 256, 2.5, 2.5, device=cuda_device)
    kw = dict(block_frames_h=4, block_frames_p=64, ckpt_every_blocks=2,
              ckpt_dir=str(tmp_path), tag="t")
    want = sep.process_blocked(audio, block_frames_h=4, block_frames_p=64)

    class Kill(Exception):
        pass

    def kill(next_block, n_blocks):
        raise Kill

    with pytest.raises(Kill):
        sep.process_blocked(audio, on_segment=kill, **kw)
    got = sep.process_blocked(audio, **kw)
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)


def test_live_stream_on_card_matches_process_stream(cuda_device):
    from zen_tpu_torch.runtime.stream import LiveStream

    rng = np.random.default_rng(22)
    audio = rng.standard_normal(8 * 16 * 256).astype(np.float32)
    live = LiveStream(44100.0, 256, block_hops=16, ring_capacity=1 << 16, device=cuda_device)
    live.warmup()
    assert live.push(audio) == len(audio)
    while live.poll():
        pass
    want = HPRRealtime(44100.0, 256, device=cuda_device).process_stream(audio, block_hops=16)
    for i, stem in enumerate(("harmonic", "percussive", "residual")):
        np.testing.assert_array_equal(live.pull(stem, len(audio)), want[i])


def test_pipelined_cascade_on_two_streams_equals_sequential(cuda_device):
    """Pass 1 on stream A in the worker, pass 2 on stream B: the stems
    equal process() on the caller's stream bitwise, are ready on the
    caller's stream, and the launch counters (incremented from both
    threads) count every pass's kernels."""
    from zen_tpu_torch.drivers.pipeline import PipelinedHPRIOffline

    rng = np.random.default_rng(31)
    sep = HPRIOffline(44100.0, 4096, 256, 2.0, 2.0, device=cuda_device)
    tracks = [rng.standard_normal(44100 * s // 2).astype(np.float32) for s in (3, 5, 2, 4)]
    want = [sep.process(t) for t in tracks]
    pipe = PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device=cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    got = list(pipe.process_stream(tracks))
    assert mc.tap_median_time.launches - n_time == 2 * len(tracks)
    assert mc.sliding_median_boundary.launches - n_freq == 2 * len(tracks)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.device == b.device and torch.equal(a, b)


def test_corpus_on_card_equals_process_per_track(cuda_device, tmp_path):
    """separate_corpus on dp=1 and dp=2 meshes of the card: each track's
    stems (as its writer receives them) equal peak_normalize(process()) of
    the lone track at dp=1, bitwise, and of the batched process() at dp=2
    (a track a shard)."""
    from zen_tpu_torch.drivers.corpus import separate_corpus
    from zen_tpu_torch.io.audio import peak_normalize
    from zen_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(32)
    store = {str(tmp_path / f"t{i}.wav"): (44100, rng.standard_normal(n).astype(np.float32))
             for i, n in enumerate((44100, 60000, 52000))}
    paths = sorted(store)
    sep = HPRIOffline(44100.0, 4096, 256, 2.0, 2.0, device=cuda_device)
    for dp in (1, 2):
        got = {}
        res = separate_corpus(paths, str(tmp_path / f"dp{dp}"),
                              make_mesh({"dp": dp, "sp": 1}, devices=[cuda_device] * dp),
                              reader=lambda p: store[p],
                              writer=lambda p, fs, a: got.update({p: np.array(a)}))
        assert res == {"done": 0, "processed": 3}
        batches = [[p] for p in paths] if dp == 1 else [paths[:2], paths[2:]]
        for batch in batches:
            lengths = [len(store[p][1]) for p in batch]
            if dp == 1:
                stems = [[s.cpu().numpy()] for s in sep.process(store[batch[0]][1])]
            else:
                xb = np.zeros((len(batch), max(lengths)), np.float32)
                for row, p in zip(xb, batch):
                    row[: len(store[p][1])] = store[p][1]
                stems = [[row[:n] for row, n in zip(s.cpu().numpy(), lengths)]
                         for s in sep.process(xb, lengths=lengths)]
            for j, p in enumerate(batch):
                base = p[:-4]
                for name, s in zip(("harm", "perc", "residual"), stems):
                    out = str(tmp_path / f"dp{dp}" / f"{base.rsplit('/', 1)[1]}_{name}.wav")
                    np.testing.assert_array_equal(got[out], peak_normalize(s[j]))


def test_app_transforms_on_card_match_cpu(cuda_device):
    """odf_batch and the autocorrelation on the card against the CPU port
    at the classes of tests/test_torch_apps.py: 1e-5 x max|odf| and 1e-5 x
    max|acf| per chunk (cuFFT against the CPU FFT)."""
    from zen_tpu_torch.apps.btrack import frames_from_hops, odf_batch
    from zen_tpu_torch.apps.mpm import _autocorr_batch

    rng = np.random.default_rng(33)
    audio = np.zeros(44100 * 4, np.float32)
    for i in range(0, len(audio) - 600, 22050):
        audio[i : i + 600] = rng.standard_normal(600) * np.exp(-np.arange(600) / 120)
    frames = frames_from_hops(audio)
    want = odf_batch(torch.from_numpy(frames)).numpy()
    got = odf_batch(torch.from_numpy(frames).to(cuda_device))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    chunks = (audio[: 40 * 4096].reshape(40, 4096)
              + 0.5 * np.sin(np.arange(4096) * 0.05)).astype(np.float32)
    for strict in (False, True):
        want = _autocorr_batch(torch.from_numpy(chunks), 4096, strict).numpy()
        got = _autocorr_batch(torch.from_numpy(chunks).to(cuda_device), 4096, strict)
        err = np.abs(got.cpu().numpy() - want).max(axis=1) / np.abs(want).max(axis=1)
        assert err.max() <= 1e-5, (strict, err.max())


# ---------------- the parallel layer on virtual shards of the card ----------------


def _card_mesh(axes, device):
    from zen_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, devices=[device] * int(np.prod(list(axes.values()))))


def test_sharded_blocked_sp4_bitwise_on_card(cuda_device):
    """sharded_hpri_blocked at sp=4 on one card: bitwise to
    process_blocked() at the same block sizes, and one K1 and one K2 a
    block of every shard plus the block before each span but the first."""
    from zen_tpu_torch.parallel import sharded as tsh

    sep = HPRIOffline(44100.0, 4096, 256, 2.0, 2.0, device=cuda_device)
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal(44100 * 12).astype(np.float32) * 0.3).to(cuda_device)
    want = sep.process_blocked(x, 8, 128)
    mesh = _card_mesh({"sp": 4}, cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    got = tsh.sharded_hpri_blocked(x, sep.cfg_h, sep.cfg_p, mesh, 8, 128)
    torch.cuda.synchronize()
    blocks = sum(4 * tsh._sharded_blocking(len(x), cfg, bf, 4)[1] + 3
                 for cfg, bf in ((sep.cfg_h, 8), (sep.cfg_p, 128)))
    assert mc.tap_median_time.launches - n_time == blocks
    assert mc.sliding_median_boundary.launches - n_freq == blocks
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)


def test_tp_on_card_matches_cpu(cuda_device):
    """tp_hpri_offline at tp=4 on one card against the same on the CPU,
    pass by pass under chip_smoke's flip rule at the TP class (2e-4 x
    scale); K2's valid route runs in every shard."""
    import chip_smoke as cs
    from zen_tpu_torch.parallel import sharded as tsh

    sep = HPRIOffline(8000.0, 256, 64, 2.0, 2.0, fast_rfft=False, device=cuda_device)
    x = torch.from_numpy(cs.synthetic_mix(8000 * 3, 8000.0, seed=41)).to(cuda_device)
    meshes = {"card": _card_mesh({"tp": 4}, cuda_device), "cpu": _card_mesh({"tp": 4}, "cpu")}
    n_freq = mc.sliding_median_boundary.launches
    got = tsh.tp_hpri_offline(x, sep.cfg_h, sep.cfg_p, meshes["card"])
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.launches - n_freq == 8
    assert all(g.device.type == "cuda" and bool(torch.isfinite(g).all()) for g in got)
    audio = {"card": x, "cpu": x.cpu()}
    for cfg in (sep.cfg_h, sep.cfg_p):
        (g, m_g), (w, m_w) = (cs.tp_pass(audio[k], cfg, meshes[k]) for k in ("card", "cpu"))
        cs.hold_pass(f"tp hop {cfg.hop}", g, w, m_g, m_w, cfg.hop, cs.TP_ATOL)
        audio = {"card": g["percussive"] + g["residual"]}
        audio["cpu"] = audio["card"].cpu()


def test_sharded_paths_do_not_synchronize(cuda_device):
    """Every shard's work is enqueued without the host waiting on the
    card: a dp x sp pass, a TP pass, the blocked scan and a sharded
    fleet's step, each once to warm up and then under
    set_sync_debug_mode('error')."""
    from zen_tpu_torch.parallel import sharded as tsh

    cfg = HPRConfig(fs=8000.0, hop=64, causal=False)
    x = torch.randn(2, 8000, device=cuda_device)
    ms = MultiStreamHPR(8, 8000.0, 64, mesh=_card_mesh({"dp": 4}, cuda_device))
    blocks = torch.randn(8, 5, 64, device=cuda_device)
    runs = [
        lambda: tsh.sharded_hpri_offline(x, cfg, cfg, _card_mesh({"dp": 2, "sp": 2}, cuda_device),
                                         lengths=[8000, 6000]),
        lambda: tsh.tp_separate(x[0], cfg, _card_mesh({"tp": 2}, cuda_device)),
        lambda: tsh.sharded_separate_blocked(x[0], cfg, _card_mesh({"sp": 2}, cuda_device), 16),
        lambda: ms.process_block(blocks),
    ]
    for run in runs:
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_multistream_mesh_on_card_equals_unsharded(cuda_device):
    """64 streams at dp=4 on one card against the unsharded fleet, gathered
    on the card in stream order, under chip_smoke's flip rule (cuFFT's
    bits can depend on the batch, 16 streams a shard against 64); each
    shard launches its own K1 and K2 a block."""
    import chip_smoke as cs

    audio = cs.fleet_audio(64, 3 * 8 * 256, 44100.0)
    blocks = torch.from_numpy(audio).reshape(64, 3, 8, 256)
    one = MultiStreamHPR(64, 44100.0, 256, device=cuda_device)
    ms = MultiStreamHPR(64, 44100.0, 256, mesh=_card_mesh({"dp": 4}, cuda_device))
    got, want = [], []
    for j in range(3):
        want.append(one.process_block(blocks[:, j]))
        n_time = mc.tap_median_time.launches
        got.append(ms.process_block(blocks[:, j]))
        torch.cuda.synchronize()
        assert mc.tap_median_time.launches - n_time == 4
        assert got[-1].device == want[-1].device
    got, want = torch.cat(got, dim=2), torch.cat(want, dim=2)
    if not torch.equal(got, want):
        m_s = torch.cat([cs.stream_masks(ms.cfg, audio[16 * i : 16 * (i + 1)], [8] * 3,
                                         cuda_device) for i in range(4)], dim=1)
        cs.hold_masks(m_s, cs.stream_masks(ms.cfg, audio, [8] * 3, cuda_device), 256,
                      got.cpu().numpy(), want.cpu().numpy(),
                      ("harmonic", "percussive", "residual"))


def test_soak_dispatch_does_not_synchronize(cuda_device):
    """The soak's per-dispatch stats are reduced on the card: a dispatch of
    block steps enqueues without the host waiting, and its one readback
    comes after."""
    from zen_tpu_torch.benches import soak

    run = soak.Soak(soak.parse(["--fs", "8000", "--hop", "64", "--streams", "4",
                                "--block-hops", "4", "--steps", "3", "--dispatches", "1"]))
    run.dispatch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mx, bad = run.dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(bad) == 0 and float(mx) == float(run.prev.abs().max()) > 0


def test_headline_chains_do_not_synchronize(cuda_device):
    """What the headline times with device_ms stays on the card: a chained
    streaming step (median and SSE) and the chained offline cascade."""
    from zen_tpu_torch.benches import headline

    sizes = headline.SIZES[True]
    runs = []
    for kw in ({}, {"use_sse": True}):
        fn, x = headline.stream_chain(headline.stream_config(8000.0, 128, **kw), 2, 4,
                                      cuda_device, seed=0)
        runs.append((fn, x))
    sep = headline.offline_separator(sizes, cuda_device)
    clip = torch.randn(16000, device=cuda_device)
    runs.append((lambda a: clip + 1e-12 * sum(sep.process(a)), clip))
    for fn, x in runs:
        y = fn(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(y)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_dryrun_multichip_on_card(cuda_device):
    """The sharded dry run on four virtual shards of the card: every
    factorization held bitwise or, where cuFFT's batch changes bits, under
    the flip rule; the line says which."""
    from zen_tpu_torch.entry import dryrun_multichip

    line = dryrun_multichip(4, device=cuda_device)
    assert line.startswith("dryrun_multichip ok on 4 shards of cuda")
    assert "(virtual: one device repeated)" in line


def test_pipelined_cascade_given_the_card_twice_equals_one_device(cuda_device):
    """devices=[card, card] is the one-card path (two streams of it):
    bitwise equal to device=card."""
    from zen_tpu_torch.drivers.pipeline import PipelinedHPRIOffline

    rng = np.random.default_rng(33)
    sep = HPRIOffline(44100.0, 4096, 256, 2.0, 2.0, device=cuda_device)
    tracks = [rng.standard_normal(44100 * s // 2).astype(np.float32) for s in (3, 2, 4)]
    one = list(PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device=cuda_device)
               .process_stream(tracks))
    two = list(PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, devices=[cuda_device, cuda_device])
               .process_stream(tracks))
    for a, b in zip(one, two):
        for x, y in zip(a, b):
            assert x.device == y.device and torch.equal(x, y)


def test_pipelined_cascade_on_two_cards_equals_one(cuda_device):
    """Pass 1 on card 0, pass 2 on card 1, the intermediate crossing as a
    peer copy: the stems equal the one-card pipeline's bitwise. Unverified
    on a host with one card (it skips there)."""
    from zen_tpu_torch.drivers.pipeline import PipelinedHPRIOffline

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the distinct-card pipeline is unverified on one")
    rng = np.random.default_rng(34)
    sep = HPRIOffline(44100.0, 4096, 256, 2.0, 2.0, device="cuda:0")
    tracks = [rng.standard_normal(44100 * s // 2).astype(np.float32) for s in (3, 2, 4)]
    one = list(PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device="cuda:0").process_stream(tracks))
    two = list(PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, devices=["cuda:0", "cuda:1"])
               .process_stream(tracks))
    for a, b in zip(one, two):
        assert [x.device.index for x in b] == [0, 1, 1]
        for x, y in zip(a, b):
            assert torch.equal(x, y.to(x.device))


def test_corpus_in_two_processes_on_the_card(cuda_device):
    """tools/multihost_smoke.py --device cuda, two processes sharing the
    card (dp = 2 x sp = 2, the long track's sharded blocked route): the
    stems byte-equal the golden single-process run's."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "zen_tpu_torch.tools.multihost_smoke",
                           "--device", "cuda", "--nprocs", "2", "--legs", "run",
                           "--timeout", "600"],
                          cwd=root, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    report = json.loads(proc.stdout.splitlines()[-1])
    workers = report["legs"]["run"]["workers"]
    assert [w["results"] for w in workers] == [{"done": 0, "processed": 5}] * 2
    assert all(sum(w["launches"].values()) > 0 for w in workers)


def test_rings_across_two_processes_on_the_card(cuda_device):
    """tools/multihost_smoke.py --device cuda --size cpu, two processes
    sharing the card: one sp ring cut across them (`zen-torch corpus --mesh
    sp=2 --nprocs 2`, the long track's blocked scan too, then killed before
    its pass 2 and resumed) and the tp rings of tp_hpri_offline at tp 2 and
    4, their halos and ordered sums over gloo: every process's stems
    byte-equal to one process's run of the same global mesh (the smoke
    raises otherwise), with the kernels launched on every process."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "zen_tpu_torch.tools.multihost_smoke",
                           "--device", "cuda", "--size", "cpu", "--nprocs", "2", "--legs",
                           "sp,sp_resume,tp", "--timeout", "600"],
                          cwd=root, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    legs = json.loads(proc.stdout.splitlines()[-1])["legs"]
    for name, kind in (("sp", "halo"), ("sp_resume", "halo"), ("tp", "halo"), ("tp", "sum")):
        for w in legs[name]["workers"]:
            assert w["traffic"][kind]["bytes"] > 0, (name, kind, w["worker"])
            assert sum(w["launches"].values()) > 0, (name, w["worker"])


MEDIAN2D_DIRECTIONS = ("time_causal", "time_anticausal", "frequency")


@pytest.mark.parametrize("border", ["wrap", "valid", "replicate"])
@pytest.mark.parametrize("direction", MEDIAN2D_DIRECTIONS)
@pytest.mark.parametrize("shape,fl", [((41, 513), 11), ((29, 2049), 187), ((300, 65), 93),
                                      ((2, 30, 40), 5), ((9, 9), 13), ((1, 6), 4)])
def test_median2d_on_card_matches_plain(cuda_device, shape, fl, direction, border):
    """median2d on CUDA tensors: bitwise to median2d_plain on the CPU
    (held against zen_tpu in tests/test_torch_median2d.py) at every
    direction and border, at the networks' and the rank routes' K and
    past both dims (fl 13 on [9, 9], fl 5 on T = 1); each call launches
    K1 (time) or K2 (frequency) once, and nothing where 'valid' writes
    no output, so no plain path ran on the card."""
    from zen_tpu_torch.ops.median import median2d, median2d_plain, odd_filter_len

    x = _mags(np.random.default_rng(fl), *shape, device=cuda_device)
    wrapper = mc.sliding_median_boundary if direction == "frequency" else mc.tap_median_time
    other = mc.tap_median_time if direction == "frequency" else mc.sliding_median_boundary
    before, before_other = wrapper.launches, other.launches
    got = median2d(x, fl, direction, border)
    torch.cuda.synchronize()
    n = shape[-1] if direction == "frequency" else shape[-2]
    launched = border != "valid" or n - odd_filter_len(fl) >= 1
    assert wrapper.launches == before + launched and other.launches == before_other
    assert got.device == x.device and got.dtype == x.dtype
    assert torch.equal(got.cpu(), median2d_plain(x.cpu(), fl, direction, border))


@pytest.mark.parametrize("border", ["wrap", "valid", "replicate"])
@pytest.mark.parametrize("direction", MEDIAN2D_DIRECTIONS)
def test_median2d_on_card_keeps_infs(cuda_device, direction, border):
    """+inf rows and a column: the card bitwise to median2d_plain, which
    tests/test_torch_median2d.py holds against zen_tpu's jnp.median."""
    from zen_tpu_torch.ops.median import median2d, median2d_plain

    x = _mags(np.random.default_rng(3), 40, 129, device=cuda_device)
    x[10:12, :] = float("inf")
    x[:, 60] = float("inf")
    got = median2d(x, 7, direction, border)
    assert torch.isinf(got).any()
    assert torch.equal(got.cpu(), median2d_plain(x.cpu(), 7, direction, border))


def test_median2d_plain_refuses_cuda_tensors(cuda_device):
    from zen_tpu_torch.ops.median import median2d_plain

    with pytest.raises(ZenError, match="CPU tensors"):
        median2d_plain(torch.ones(4, 5, device=cuda_device), 3, "frequency", "wrap")


def test_step_spans_cover_the_profiler_busy_time(cuda_device):
    """The event times a profiler other than ``profiling.trace()`` gets,
    where they read the device's time: an 8192-stream, 16-hop fleet step,
    four steps enqueued behind a spin under torch.profiler. Every phase
    span has a device time, and the leaves' event times sum to within 3%
    of the union of the device operations the profiler saw for the same
    calls (the spin aside) and of their extent. An event interval holds
    every wait of the card on the host and every gap between two kernels,
    so it reads the device time only where the host stays ahead of a card
    that runs long kernels, as the spin and this size make it. At 64
    streams, kernels of a few µs with gaps between them, the events read
    far above the busy time: there the kernel records of
    ``test_traced_step_spans_hold_the_busy_time_at_64_streams`` hold."""
    from torch.profiler import ProfilerActivity, profile

    from zen_tpu_torch.engine.config import OUTPUT_PERCUSSIVE
    from zen_tpu_torch.runtime import profiling

    steps, spin_ms, streams = 4, 200.0, 8192
    ms = MultiStreamHPR(streams, 44100.0, 256, outputs=OUTPUT_PERCUSSIVE, device=cuda_device)
    ms.warmup((16,))
    blocks = torch.randn(streams, 16, 256, generator=torch.Generator().manual_seed(5))
    blocks = blocks.to(cuda_device)
    cycles = int(spin_ms * profiling._spin_cycles_per_ms(cuda_device))
    torch.cuda.synchronize()
    profiling.drain_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cycles)
        spin_end = torch.cuda.Event()
        spin_end.record()
        for _ in range(steps):
            ms.process_block(blocks)
        covered = not spin_end.query()
        torch.cuda.synchronize()
    assert covered, "the spin ended before the steps were enqueued"
    totals = profiling.drain_spans()
    leaves = ("zen.frame", "zen.analyze", "zen.k1", "zen.k2", "zen.mask", "zen.synth",
              "zen.ola", "zen.advance")
    assert set(totals) == {"zen.step", *leaves}
    assert all(t["calls"] == steps and t["device_s"] > 0 for t in totals.values())
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation and "sleep" not in e.name.lower()
                 and "spin" not in e.name.lower())
    busy, hi = 0.0, float("-inf")
    for a, b in ops:  # the union of the intervals, in µs
        if b > hi:
            busy += b - max(a, hi)
            hi = b
    extent = ops[-1][1] - ops[0][0]
    leaf_us = sum(totals[n]["device_s"] for n in leaves) * 1e6
    step_us = totals["zen.step"]["device_s"] * 1e6
    detail = {n: round(totals[n]["device_s"] * 1e6 / steps, 2) for n in totals}
    assert abs(leaf_us / busy - 1) < 0.03, (leaf_us, busy, extent, step_us, detail)
    assert abs(leaf_us / extent - 1) < 0.03, (leaf_us, busy, extent, step_us, detail)
    assert leaf_us <= step_us * 1.001, (leaf_us, step_us)


def test_traced_step_spans_hold_the_busy_time_at_64_streams(cuda_device, tmp_path):
    """A 64-stream, 16-hop fleet step, four steps under
    ``profiling.trace()``: the leaves' device µs in ``spans.json``, the
    profiler's kernel records grouped by the span that launched them, sum
    to within 3% of the union of the device operations the profiler saw
    for the same calls, and the step holds its leaves. At this size the
    card waits on the host between kernels; those waits are not counted."""
    import json

    from zen_tpu_torch.drivers.realtime import block_step, init_state
    from zen_tpu_torch.engine.config import OUTPUT_PERCUSSIVE
    from zen_tpu_torch.runtime import profiling

    steps, streams = 4, 64
    cfg = MultiStreamHPR(streams, 44100.0, 256, outputs=OUTPUT_PERCUSSIVE,
                         device=cuda_device).cfg
    state = init_state(cfg, streams, cuda_device)
    blocks = torch.randn(streams, 16, 256, generator=torch.Generator().manual_seed(5))
    blocks = blocks.to(cuda_device)
    block_step(cfg, state, blocks)  # builds the kernels and the FFT plans
    torch.cuda.synchronize()
    with profiling.trace(tmp_path) as prof:
        for _ in range(steps):
            block_step(cfg, state, blocks)
    spans = json.loads((tmp_path / "spans.json").read_text())
    leaves = ("zen.frame", "zen.analyze", "zen.k1", "zen.k2", "zen.mask", "zen.synth",
              "zen.ola", "zen.advance")
    assert set(spans) == {"zen.step", *leaves}
    assert all(t["calls"] == steps and t["device_us"] > 0 for t in spans.values()), spans
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation)
    busy, hi = 0.0, float("-inf")
    for a, b in ops:  # the union of the intervals, in µs
        if b > hi:
            busy += b - max(a, hi)
            hi = b
    leaf_us = sum(spans[n]["device_us"] for n in leaves)
    step_us = spans["zen.step"]["device_us"]
    detail = {n: round(spans[n]["device_us"] / steps, 2) for n in spans}
    assert abs(leaf_us / busy - 1) < 0.03, (leaf_us, busy, step_us, detail)
    assert leaf_us <= step_us * 1.001, (leaf_us, step_us)


# ---------------- the mask-and-apply kernel (ops/mask_cuda.py) ----------------

MASK_CONFIGS = [
    {}, {"outputs": 2}, {"outputs": 2 | 4}, {"outputs": 1 | 4}, {"beta": 1.3}, {"beta": 0.5},
]


def _mask_bits(x):
    return torch.view_as_real(x.contiguous()).view(torch.int32)


def _mask_subsets(cfg):
    import itertools

    live = sp.live_stems(cfg)
    return [c for r in range(1, len(live) + 1) for c in itertools.combinations(live, r)]


@pytest.mark.parametrize("kw", MASK_CONFIGS, ids=["all", "p", "p-r", "h-r", "beta1.3", "beta0.5"])
@pytest.mark.parametrize(
    "shape,dim",
    [((64, 16, 513), 1),  # the step's [C, L, B, bins]
     ((2585, 8193), 0), ((41355, 513), 0),  # the 4-minute track's passes: [L, T, bins]
     ((7, 8193), 0),  # an odd element count: the vector route's scalar tail
     ((1, 3, 11), 1),  # one o, 33 elements
     ((5, 3, 7), 1),  # 21 elements an o: L > 1 takes the scalar route
     ((3, 5), 0)],
)
def test_mask_kernel_bitwise_to_the_tensor_expression(cuda_device, kw, shape, dim):
    """Every live-stem subset, both layouts, L = 1, 2, 3: the kernel's
    output bit for bit (int32 views) the tensor path's expression
    (``parent_masked``) on the same CUDA tensors, ties at beta and beta -
    eps, h = p = 0 and signed zeros included."""
    from test_torch_mask import mask_inputs, parent_masked
    from zen_tpu_torch.engine.config import EPS
    from zen_tpu_torch.ops import mask_cuda as mk

    cfg = HPRConfig(fs=8000.0, hop=64, causal=True, **kw)
    s, h, p = mask_inputs(np.random.default_rng(21), shape, cfg.beta, cuda_device)
    for stems in _mask_subsets(cfg):
        args = (s, h, p, cfg.beta, EPS, stems, cfg.output_harmonic, cfg.output_percussive, dim)
        n = mk.mask_apply.launches
        got = mk.mask_apply(*args)
        want = parent_masked(s, h, p, cfg.beta, stems, cfg.output_harmonic,
                             cfg.output_percussive, dim)
        torch.cuda.synchronize()
        assert mk.mask_apply.launches == n + 1
        for row in range(len(stems)):
            assert torch.equal(_mask_bits(got.select(dim, row)),
                               _mask_bits(want.select(dim, row))), (stems, row)


def test_mask_kernel_takes_unaligned_views(cuda_device):
    """Operands that start off a 16-byte boundary (the blocked pass's
    core rows) take the scalar route, bit for bit the tensor path's."""
    from test_torch_mask import mask_inputs, parent_masked
    from zen_tpu_torch.engine.config import EPS
    from zen_tpu_torch.ops import mask_cuda as mk

    s, h, p = mask_inputs(np.random.default_rng(22), (21, 513), 2.0, cuda_device)
    s, h, p = s[1:], h[1:], p[1:]  # 513 elements in: 2052 and 4104 bytes
    for stems in [(1,), (0, 1, 2)]:
        got = mk.mask_apply(s, h, p, 2.0, EPS, stems)
        want = parent_masked(s, h, p, 2.0, stems)
        assert torch.equal(_mask_bits(got), _mask_bits(want))


def test_mask_kernel_refuses_what_it_does_not_take(cuda_device):
    from zen_tpu_torch.engine.config import EPS
    from zen_tpu_torch.ops import mask_cuda as mk

    s = torch.zeros((4, 6), dtype=torch.complex64, device=cuda_device)
    h = torch.zeros((4, 6), device=cuda_device)
    n = mk.mask_apply.launches
    with pytest.raises(ZenError, match="contiguous"):
        mk.mask_apply(s.t(), h.t(), h.t(), 2.0, EPS, (1,))
    with pytest.raises(ZenError, match="devices"):
        mk.mask_apply(s, h.cpu(), h, 2.0, EPS, (1,))
    assert mk.mask_apply.launches == n


def _step_twice(cfg, state, blocks):
    from zen_tpu_torch.drivers import realtime as rt

    return [rt.block_step(cfg, state, blocks[:, j]) for j in range(blocks.shape[1])]


@pytest.mark.parametrize("kw", [{"outputs": 2}, {}, {"stream_state": "bf16"}],
                         ids=["percussive", "all", "bf16"])
def test_block_step_stems_bitwise_to_the_tensor_path(cuda_device, kw, monkeypatch):
    """A 64-stream hop-256 step: stems and state bit for bit those of the
    tensor path (the seam's twin on the same CUDA tensors), one kernel
    launch a step."""
    from zen_tpu_torch.drivers.realtime import StreamState, init_state
    from zen_tpu_torch.ops import mask_cuda as mk

    cfg = HPRConfig(fs=44100.0, hop=256, causal=True, **kw)
    rng = np.random.default_rng(23)
    state = init_state(cfg, 64, cuda_device)
    state.ring.copy_(torch.from_numpy(rng.standard_normal(state.ring.shape).astype(np.float32)))
    other = StreamState(*(t.clone() for t in state))
    blocks = torch.from_numpy(rng.standard_normal((64, 2, 16, 256)).astype(np.float32)).to(
        cuda_device)
    n = mk.mask_apply.launches
    got = _step_twice(cfg, state, blocks)
    torch.cuda.synchronize()
    assert mk.mask_apply.launches == n + 2
    monkeypatch.setattr(mk, "mask_apply", mk.mask_apply_plain)
    want = _step_twice(cfg, other, blocks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, b in zip(state, other):
        assert torch.equal(a, b)


def test_two_pass_track_stems_bitwise_to_the_tensor_path(cuda_device, monkeypatch):
    """HPRIOffline at BASELINE.json configs[0] on a 10-s track: stems bit
    for bit the tensor path's, one kernel launch a pass."""
    import chip_smoke as cs
    from zen_tpu_torch.ops import mask_cuda as mk

    sep = HPRIOffline(44100.0, 4096, 256, 2.5, 2.5, device=cuda_device)
    x = torch.from_numpy(cs.synthetic_mix(441000, 44100.0, seed=24)).to(cuda_device)
    n = mk.mask_apply.launches
    got = sep.process(x)
    torch.cuda.synchronize()
    assert mk.mask_apply.launches == n + 2
    monkeypatch.setattr(mk, "mask_apply", mk.mask_apply_plain)
    for g, w in zip(got, sep.process(x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kw", [{"soft_mask": True}, {"use_sse": True}], ids=["soft", "sse"])
def test_soft_and_sse_masks_launch_no_mask_kernel(cuda_device, kw):
    from zen_tpu_torch.ops import mask_cuda as mk

    n = mk.mask_apply.launches
    MultiStreamHPR(8, 8000.0, 64, device=cuda_device, **kw).process_block(torch.randn(8, 4, 64))
    HPRIOffline(8000.0, 256, 64, device=cuda_device, **kw).process(np.random.default_rng(
        25).standard_normal(8000).astype(np.float32))
    torch.cuda.synchronize()
    assert mk.mask_apply.launches == n
