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

from zen_tpu_torch import HPRConfig, HPRRealtime, MultiStreamHPR, ZenError  # noqa: E402
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
     ((1, 30, 257), (1, 3, 257), tuple(range(-24, 1)), 0, 0.0)],
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


@pytest.mark.parametrize(
    "rows,f,k,mode",
    [(32, 2049, 47, "reflect"), (2048, 513, 13, "reflect"),
     (37, 4096, 47, "wrap"), (37, 513, 13, "edge"), (37, 2095, 47, "valid"),
     (5, 17, 17, "reflect"), (3, 40, 93, "wrap"), (1, 300, 255, "edge")],
)
def test_freq_kernel_matches_twin(cuda_device, rows, f, k, mode):
    rng = np.random.default_rng(10)
    x = _mags(rng, rows, f, device=cuda_device)
    before = mc.sliding_median_boundary.launches
    got = mc.sliding_median_boundary(x, k, mode)
    torch.cuda.synchronize()
    assert mc.sliding_median_boundary.launches == before + 1
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


def test_unsupported_cuda_input_raises_without_fallback(cuda_device):
    x = torch.ones((2, 9, 33), device=cuda_device)
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    with pytest.raises(ZenError):
        mc.tap_median_time(x, x, tuple(range(-65, 0)), 70)  # K = 65
    with pytest.raises(ZenError):
        mc.sliding_median_boundary(x, 257, "wrap")  # K = 257
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
