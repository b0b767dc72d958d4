"""The copy-only mirrors #9 and #10 (zen_tpu_torch/ops/probe_cuda.py)
against the two Pallas copy kernels of benches/hbm_pattern.py, BITWISE.

The Pallas kernels are closures inside that script's main(), so each is
rebuilt here from its source lines at a small shape and run as
tests/test_torch_median.py runs the median kernels on the CPU: in TPU
interpret mode (the manual DMAs and semaphores of #10 included). The
CUDA kernels against these same twins are in tests/test_torch_cuda.py
(card only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from zen_tpu_torch import ZenError  # noqa: E402
from zen_tpu_torch.ops import probe_cuda as pc  # noqa: E402

S, H, B, F = 3, 5, 4, 17  # streams, history rows, block hops, bins
T = H + B


@pytest.fixture(autouse=True)
def interpret():
    if jax.default_backend() == "tpu":
        yield
        return
    with pltpu.force_tpu_interpret_mode():
        yield


def _align(x, a):
    return -(-x // a) * a


def _mags(rng, *shape):
    return rng.random(shape, dtype=np.float32) + np.float32(1e-3)


def _pair(x, dtype):
    """The same values for both packages, float32 or bf16 (a jnp bf16
    array and the torch bf16 tensor of its exact float32 read-back)."""
    xj = jnp.asarray(x, dtype)
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)


def time_dma_call(dtype):
    """benches/hbm_pattern.py:181-190, `_time_dma_kernel` and its
    pallas_call, at [S, T, F]."""

    def _time_dma_kernel(x_ref, o_ref):
        o_ref[0] = x_ref[0, H : H + B, :]

    return pl.pallas_call(
        _time_dma_kernel,
        out_shape=jax.ShapeDtypeStruct((S, B, F), dtype),
        grid=(S,),
        in_specs=[pl.BlockSpec((1, T, F), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, B, F), lambda i: (i, 0, 0)),
    )


def freqT_dma(y, kf, tb, fb):
    """benches/hbm_pattern.py:240-301, `_freqT_dma_kernel`, its
    pallas_call and the `freqT_dma` wrapper (row pad, kernel, un-pad;
    without the chain's `* c_mul`), on y [1, FP, R] with the chunk walk
    tb x fb given here instead of the TPU tile pick."""
    _, fp, r = y.shape
    n_f = -(-_align(r, 128) // fb)
    n_t = -(-fp // tb)
    rows = _align(tb + kf - 1, 8)
    t_pad = _align(max(fp, (n_t - 1) * tb + rows), 8)

    def _freqT_dma_kernel(x_hbm, out_hbm, slabs, outbufs, in_sems, out_sems):
        j = pl.program_id(0)

        def in_dma(slot, i):
            return pltpu.make_async_copy(
                x_hbm.at[0, pl.ds(i * tb, rows), pl.ds(j * fb, fb)],
                slabs.at[slot],
                in_sems.at[slot],
            )

        def out_dma(slot, i):
            return pltpu.make_async_copy(
                outbufs.at[slot],
                out_hbm.at[0, pl.ds(i * tb, tb), pl.ds(j * fb, fb)],
                out_sems.at[slot],
            )

        in_dma(0, 0).start()

        def body(i, _):
            slot = jax.lax.rem(i, 2)
            nxt = jax.lax.rem(i + 1, 2)

            @pl.when(i + 1 < n_t)
            def _():
                in_dma(nxt, i + 1).start()

            in_dma(slot, i).wait()

            @pl.when(i >= 2)
            def _():
                out_dma(slot, i - 2).wait()

            outbufs[slot] = slabs[slot, :tb, :]
            out_dma(slot, i).start()
            return ()

        jax.lax.fori_loop(0, n_t, body, (), unroll=False)

        @pl.when(n_t >= 2)
        def _():
            out_dma(jax.lax.rem(n_t - 2, 2), n_t - 2).wait()

        out_dma(jax.lax.rem(n_t - 1, 2), n_t - 1).wait()

    call = pl.pallas_call(
        _freqT_dma_kernel,
        out_shape=jax.ShapeDtypeStruct((1, n_t * tb, n_f * fb), y.dtype),
        grid=(n_f,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[
            pltpu.VMEM((2, rows, fb), y.dtype),
            pltpu.VMEM((2, tb, fb), y.dtype),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
        ],
    )
    yp = jnp.pad(y, ((0, 0), (0, t_pad - fp), (0, 0)))
    return call(yp)[:, :fp, :r]


# ---------------- #9 ----------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rows_copy_twin_matches_pallas(dtype):
    xj, xt = _pair(_mags(np.random.default_rng(20), S, T, F), dtype)
    want = np.asarray(time_dma_call(dtype)(xj), np.float32)
    before = pc.rows_copy.launches
    got = pc.rows_copy(xt, H, B)  # a CPU tensor takes the twin
    assert pc.rows_copy.launches == before
    assert got.dtype == xt.dtype and got.shape == (S, B, F)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(pc.rows_copy_plain(xt, H, B).float().numpy(), want)


def test_rows_copy_twin_owns_its_rows():
    x = torch.from_numpy(_mags(np.random.default_rng(21), S, T, F))
    out = pc.rows_copy(x, H, B)
    out.zero_()
    assert bool((x[:, H : H + B] > 0).all())
    assert pc.rows_copy(x, 2, 0).shape == (S, 0, F)


@pytest.mark.parametrize(
    "shape,start,t_out",
    [((S, F), 0, 1), ((1, S, T, F), 0, 1), ((S, T, F), -1, 2), ((S, T, F), 5, -1),
     ((S, T, F), 6, 4)],
)
def test_rows_copy_rejects(shape, start, t_out):
    with pytest.raises(ZenError):
        pc.rows_copy(torch.zeros(shape), start, t_out)


def test_rows_copy_rejects_dtype():
    with pytest.raises(ZenError):
        pc.rows_copy(torch.zeros((S, T, F), dtype=torch.float16), H, B)


# ---------------- #10 ----------------


@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge"])
@pytest.mark.parametrize(
    "kf,bins,r,tb,fb,dtype",
    [(5, 17, 256, 8, 128, jnp.float32),  # three chunks, two lane tiles
     (13, 29, 128, 16, 128, jnp.float32),  # the step's K, rows = 32
     (5, 17, 256, 8, 128, jnp.bfloat16)],
)
def test_segment_copy_twin_matches_pallas(mode, kf, bins, r, tb, fb, dtype):
    """#10 walks the transposed slab [1, bins + kf - 1, R]; the port reads
    the folded rows [R, bins + kf - 1] untransposed, so its twin on y^T
    is held against the walk's output transposed back."""
    y = _mags(np.random.default_rng(22), 1, bins + kf - 1, r)
    yj, yt = _pair(y, dtype)
    want = np.asarray(freqT_dma(yj, kf, tb, fb), np.float32)[0].T
    rows = yt[0].t().contiguous()
    before = pc.segment_copy.launches
    got = pc.segment_copy(rows, kf, mode)
    assert pc.segment_copy.launches == before
    assert got.dtype == rows.dtype and got.shape == rows.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(pc.segment_copy_plain(rows, kf, mode).float().numpy(), want)


def test_segment_copy_keeps_leading_dims():
    x = torch.from_numpy(_mags(np.random.default_rng(23), 2, 3, 65))
    got = pc.segment_copy(x, 13, "wrap")
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize(
    "shape,k,mode",
    [((4, 17), 4, "reflect"),  # even K
     ((4, 17), 0, "wrap"),
     ((4, 17), 5, "valid"),  # the copy keeps the width: no valid border
     ((4, 17), 5, "zero"),
     ((4, 5), 11, "reflect"),  # the reflect reach passes the row
     ((4, 17), pc.SEGMENT_COPY_MAX_TAPS + 2, "wrap")],
)
def test_segment_copy_rejects(shape, k, mode):
    with pytest.raises(ZenError):
        pc.segment_copy(torch.zeros(shape), k, mode)


def test_segment_copy_rejects_dtype():
    with pytest.raises(ZenError):
        pc.segment_copy(torch.zeros((4, 17), dtype=torch.float64), 5, "wrap")


def test_segment_copy_uses_k2_rank_tile():
    """The mirror stages what K2 stages at that K: its rank tile where K2
    takes the rank route, none (the network route's own-type staging)
    where it takes the network."""
    from zen_tpu_torch.ops import median_cuda as mc

    for k in (1, 13, 31, 33, 47, 187, 257):
        tile = pc._check_segment(torch.zeros((1, 600)), k, "wrap")
        if mc.freq_route(k) == "rank":
            assert tile == mc.freq_rank_tile(k)
        else:
            assert mc.freq_route(k) == "network" and tile is None
