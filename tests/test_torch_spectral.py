"""zen_tpu_torch.engine.spectral against zen_tpu.engine.spectral.

Tolerances, each with its reason:
* transforms (analyze, synthesize_spectrum): rel <= 1e-5 of the reference's max
  magnitude — torch.fft and the XLA CPU FFT round differently (~2e-7
  relative at these sizes), nothing else differs;
* medians and masks: bitwise — selection and float32 elementwise math
  in the same order on identical inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.engine import spectral as jsp  # noqa: E402
from zen_tpu.engine.config import HPRConfig as JaxConfig  # noqa: E402
from zen_tpu.engine.config import OUTPUT_PERCUSSIVE  # noqa: E402
from zen_tpu_torch import config_from_fields  # noqa: E402
from zen_tpu_torch.engine import spectral as tsp  # noqa: E402

REL_FFT = 1e-5


def _cfgs(**kw):
    base = dict(fs=8000.0, hop=64, causal=True, median_impl="xla", fft_impl="xla")
    base.update(kw)
    jc = JaxConfig(**base)
    return jc, config_from_fields(**dataclasses.asdict(jc))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("fast", [True, False])
def test_analyze_matches_jax(fast):
    jc, tc = _cfgs(fast_rfft=fast)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 10, jc.nwin)).astype(np.float32)
    want = _np(jsp.analyze(jnp.asarray(frames), jc))
    got = tsp.analyze(torch.from_numpy(frames), tc).numpy()
    assert got.shape == want.shape == (2, 10, tsp.num_bins(tc))
    assert tsp.num_bins(tc) == jsp.num_bins(jc)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=REL_FFT)


@pytest.mark.parametrize("fast", [True, False])
def test_synthesize_matches_jax(fast):
    jc, tc = _cfgs(fast_rfft=fast)
    rng = np.random.default_rng(1)
    bins = tsp.num_bins(tc)
    s = (rng.standard_normal((3, 6, bins)) + 1j * rng.standard_normal((3, 6, bins)))
    s = s.astype(np.complex64)
    if not fast:  # a Hermitian spectrum, as masks of |S| keep it
        s = np.fft.fft(np.fft.ifft(s).real).astype(np.complex64)
    mask = (rng.random((3, 6, bins)) > 0.4).astype(np.float32)
    want = _np(jsp.synthesize(jnp.asarray(s), jnp.asarray(mask), jc))
    got = tsp.synthesize_spectrum(torch.from_numpy(s) * torch.from_numpy(mask), tc).numpy()
    assert got.shape == want.shape == (3, 6, jc.nwin)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=REL_FFT)


def _features(rng, *shape):
    """Magnitude-like features with exact zeros and exact beta ratios."""
    h = rng.random(shape, dtype=np.float32) * np.float32(3)
    p = rng.random(shape, dtype=np.float32) * np.float32(3)
    flat_h, flat_p = h.reshape(-1), p.reshape(-1)
    flat_h[::17] = 0.0
    flat_p[::17] = 0.0
    flat_p[5::23] = flat_h[5::23] * np.float32(2)  # p / h == beta exactly
    flat_h[7::29] = flat_p[7::29] * np.float32(2)
    return h, p


@pytest.mark.parametrize(
    "kw",
    [{}, {"soft_mask": True}, {"soft_mask": True, "beta": 3.7},
     {"soft_mask": True, "beta": 0.5}, {"outputs": OUTPUT_PERCUSSIVE},
     {"beta": 1.3}],
)
def test_compute_masks_bitwise(kw):
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(2)
    h, p = _features(rng, 4, 7, 129)
    want = jsp.compute_masks(jnp.asarray(h), jnp.asarray(p), jc)
    got = tsp.compute_masks(torch.from_numpy(h), torch.from_numpy(p), tc)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("fs,hop", [(1000.0, 8), (8000.0, 64), (44100.0, 1024)])
def test_time_and_freq_filters_bitwise(fs, hop):
    jc, tc = _cfgs(fs=fs, hop=hop)
    h_len = tc.time_history
    rng = np.random.default_rng(3)
    bins = tsp.num_bins(tc)
    hist = rng.random((2, h_len, bins), dtype=np.float32)
    fresh = rng.random((2, 6, bins), dtype=np.float32)
    want = _np(jsp.time_filtered_tail_pair(jnp.asarray(hist), jnp.asarray(fresh), jc))
    got = tsp.time_filtered_tail_pair(torch.from_numpy(hist), torch.from_numpy(fresh), tc)
    np.testing.assert_array_equal(got.numpy(), want)
    feats = np.concatenate([hist, fresh], axis=1)
    want = _np(jsp.time_filtered_tail(jnp.asarray(feats), jc, 3))
    got = tsp.time_filtered_tail(torch.from_numpy(feats), tc, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    want = _np(jsp.freq_filtered(jnp.asarray(fresh), jc))
    got = tsp.freq_filtered(torch.from_numpy(fresh), tc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("median_impl", ["auto", "torch"])
def test_full_spectrum_filters_bitwise(median_impl):
    """fast_rfft=False: the wrap boundary over the full spectrum, with
    'auto' and with 'torch' (which pins the plain reference: on CPU
    tensors both run the wrappers' plain twins)."""
    jc, tc = _cfgs(fast_rfft=False)
    tc = dataclasses.replace(tc, median_impl=median_impl)
    rng = np.random.default_rng(4)
    feats = rng.random((2, 20, tsp.num_bins(tc)), dtype=np.float32)
    want = _np(jsp.freq_filtered(jnp.asarray(feats), jc))
    np.testing.assert_array_equal(tsp.freq_filtered(torch.from_numpy(feats), tc).numpy(), want)
    want = _np(jsp.time_filtered_tail(jnp.asarray(feats), jc, 0))
    got = tsp.time_filtered_tail(torch.from_numpy(feats), tc, 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_median_impl_rejects_cpu_tensors():
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, median_impl="cuda")
    x = torch.ones((1, 4, tsp.num_bins(tc)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsp.freq_filtered(x, tc)


def test_feature_transform_is_magnitude():
    _, tc = _cfgs()
    m = torch.rand(3, 5)
    assert tsp.feature_transform(m, tc) is m
    h, p = torch.rand(2, 3), torch.rand(2, 3)
    assert tsp.finalize_features(h, p, tc) == (h, p)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("border", ["valid", "replicate"])
def test_border_filters_match_jax(border, causal):
    """Both directional medians under the other borders, bitwise on the
    same features: 'valid' zero-pads the forward frequency window and
    zeroes the top bins, 'replicate' clamps; at fs 8000 / hop 256 the
    offline 'valid' time filter is all zeros (lag_row_written)."""
    for hop in (64, 256):
        jc, tc = _cfgs(border=border, causal=causal, hop=hop)
        rng = np.random.default_rng(hop)
        feats = rng.random((2, 12, tsp.num_bins(tc)), dtype=np.float32) + np.float32(1e-3)
        x = torch.from_numpy(feats)
        got_p = tsp.freq_filtered(x, tc).numpy()
        np.testing.assert_array_equal(got_p, _np(jsp.freq_filtered(jnp.asarray(feats), jc)))
        got_h = tsp.time_filtered_tail(x, tc, 3)
        assert got_h.dtype == torch.float32
        want_h = _np(jsp.time_filtered_tail(jnp.asarray(feats), jc, 3))
        np.testing.assert_array_equal(got_h.numpy(), want_h)
        if not tc.lag_row_written:
            assert not got_h.any()
