"""The SSE variant of the port (box means of 1/|S|^2, hps.cu:582-652)
against zen_tpu, on the CPU.

Both packages get the same numpy audio, made from a seed. Tolerances,
each with its reason:
* against the hop-by-hop oracle: its 5e-4 class, all three borders
  (tests/test_engine_parity.py:46-92);
* against zen_tpu's drivers: 5e-5 x max(1, max|ref|) per stem, the
  realtime parity class; the FFTs round differently, and zen_tpu's
  jitted mean multiplies by float32(1/K) where the port divides;
* filtered features and masks given the same |S|, zen_tpu op by op:
  bitwise;
* within the port (blocked vs batched, a toggle vs the flag, a carried
  state): bitwise.
The SSE masks are continuous, so no bin flips between the packages. The
+inf prefill must leave every output finite where zen_tpu's is,
the first hops included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import zen_tpu as J  # noqa: E402
from zen_tpu.drivers import offline as joff  # noqa: E402
from zen_tpu.engine import spectral as jsp  # noqa: E402
from zen_tpu.engine.oracle import oracle_offline_pass, oracle_realtime_stream  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.engine import spectral as tsp  # noqa: E402

ATOL = 5e-5
STEMS = ("harmonic", "percussive", "residual")
XLA = dict(median_impl="xla", fft_impl="xla")
BORDERS = ("wrap", "valid", "replicate")


def _audio(length, seed=0, fs=1000.0):
    """The oracle suite's fixture: a 50 Hz tone, clicks, a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / fs
    sig = (0.7 * np.sin(2 * np.pi * 50 * t) + 0.4 * (rng.random(length) > 0.97)
           + 0.05 * rng.standard_normal(length))
    return sig.astype(np.float32)


def _close(got, want, what="", atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=what)


def _oracle_close(got, want, what, rtol=5e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def _cfgs(**kw):
    jc = J.HPRConfig(use_sse=True, **XLA, **kw)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _realtime_pair(fs, hop, **kw):
    jc, tc = _cfgs(fs=fs, hop=hop, causal=True, **kw)
    jrt = J.HPRRealtime(fs, hop)
    jrt.cfg = jc
    jrt.reset_buffers()
    trt = T.HPRRealtime(fs, hop, device="cpu")
    trt.cfg = tc
    trt.reset_buffers()
    return jrt, trt


@pytest.mark.parametrize("border", BORDERS)
def test_offline_pass_matches_oracle(border):
    """tests/test_engine_parity.py:53-68, the SSE variant: the exact C2C
    path against the hop-by-hop oracle."""
    jc, tc = _cfgs(fs=1000.0, hop=8, causal=False, border=border, fast_rfft=False)
    audio = _audio(101)
    want = oracle_offline_pass(audio, jc)
    got = T.hpr_separate(audio, tc)
    for k in STEMS:
        assert np.isfinite(got[k].numpy()).all(), k
        _oracle_close(got[k].numpy(), want[k], f"{border} {k}")


@pytest.mark.parametrize("border", BORDERS)
def test_realtime_stream_matches_oracle(border):
    """tests/test_engine_parity.py:71-92, the SSE variant, blocks of 5
    hops from a fresh +inf history."""
    jc, tc = _cfgs(fs=1000.0, hop=8, causal=True, border=border, fast_rfft=False)
    audio = _audio(101)
    want = oracle_realtime_stream(audio, jc)
    rt = T.HPRRealtime(1000.0, 8, border=border, use_sse=True, fast_rfft=False, device="cpu")
    assert (rt.cfg.border, rt.cfg.fast_rfft, rt.cfg.time_offsets) == (
        tc.border, tc.fast_rfft, tc.time_offsets)
    got = rt.process_stream(audio, block_hops=5)
    assert np.isfinite(got).all()
    for i, k in enumerate(STEMS):
        _oracle_close(got[i], want[k], f"{border} {k}")


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("block_hops", [1, 5, 13])
def test_process_stream_matches_zen_tpu(block_hops, border, fast):
    """B = 1 and 5 (B < H = 15 at fs 1000 / hop 8) and 13, ragged tails
    (40 hops); the first hops read the +inf prefill in every window."""
    jrt, trt = _realtime_pair(1000.0, 8, border=border, fast_rfft=fast)
    audio = np.random.default_rng(block_hops).standard_normal(8 * 40 - 3).astype(np.float32)
    want = np.asarray(jrt.process_stream(audio, block_hops=block_hops))
    got = trt.process_stream(audio, block_hops=block_hops)
    assert np.isfinite(got).all()
    _close(got, want, f"B={block_hops} {border} fast={fast}")
    assert not got[2].any()  # the residual has no SSE mask: a zero row


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_b_over_history_and_bf16_state_match_zen_tpu(state):
    """fs 8000 / hop 64, B = 20 >= H = 15: the step's [hist ++ fresh]
    concat, the history in the stream state's dtype, the means on float32
    taps."""
    jrt, trt = _realtime_pair(8000.0, 64, stream_state=state)
    audio = np.random.default_rng(7).standard_normal(64 * 50).astype(np.float32)
    _close(trt.process_stream(audio, 20), np.asarray(jrt.process_stream(audio, 20)), state)
    assert trt.state.feat_hist.dtype == (torch.bfloat16 if state == "bf16" else torch.float32)


def test_multistream_matches_single_streams():
    """MultiStreamHPR under SSE: each stream equals its own HPRRealtime
    bitwise, and reset_streams restores the +inf history."""
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((3, 6, 5, 8)).astype(np.float32)
    ms = T.MultiStreamHPR(3, 1000.0, 8, use_sse=True, device="cpu")
    got = torch.cat([ms.process_block(audio[:, j]) for j in range(6)], dim=2).numpy()
    for i in range(3):
        rt = T.HPRRealtime(1000.0, 8, use_sse=True, device="cpu")
        want = rt.process_stream(audio[i].reshape(-1), block_hops=5)
        np.testing.assert_array_equal(got[i], want)
    ms.reset_streams([1])
    assert torch.isinf(ms.state.feat_hist[1]).all() and torch.isfinite(ms.state.feat_hist[0]).all()


def test_filter_features_and_masks_bitwise():
    """Given the same |S| (with exact zeros: inf features), the SSE
    features and masks equal zen_tpu's op by op, bit for bit."""
    for fast in (True, False):
        jc, tc = _cfgs(fs=1000.0, hop=8, causal=False, fast_rfft=fast)
        mag = np.random.default_rng(3).random((2, 23, tsp.num_bins(tc)), dtype=np.float32)
        mag[0, 4, :5] = 0.0
        jh, jp = jsp.filter_features(jnp.asarray(mag), jc)
        # the steps frame_masks composes
        feats = tsp.feature_transform(torch.from_numpy(mag), tc)
        h, p = tsp.time_filtered(feats, tc), tsp.freq_filtered(feats, tc)
        th, tp = tsp.finalize_features(h, p, tc)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        for g, w in zip(tsp.feature_masks(h, p, tc), jsp.compute_masks(jh, jp, jc)):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("border", BORDERS)
def test_hpr_separate_matches_zen_tpu(border):
    jc, tc = _cfgs(fs=1000.0, hop=8, causal=False, border=border)
    audio = _audio(8 * 40 + 5, 2)
    want, got = joff.hpr_separate(audio, jc), T.hpr_separate(audio, tc)
    for k in STEMS:
        _close(got[k], want[k], f"{border} {k}")


@pytest.mark.parametrize("fs,hop_h,hop_p,length", [(1000.0, 16, 8, 97), (1000.0, 16, 8, 700),
                                                   (8000.0, 1024, 64, 6000)])
def test_two_pass_offline_matches_zen_tpu(fs, hop_h, hop_p, length):
    """HPRIOffline under SSE: pass 1's harmonic, pass 2's percussive, and
    the residual, which SSE leaves silent."""
    audio = _audio(length, 5, fs)
    jsep = J.HPRIOffline(fs, hop_h, hop_p, use_sse=True, **XLA)
    tsep = T.HPRIOffline(fs, hop_h, hop_p, use_sse=True, device="cpu")
    for got, want, k in zip(tsep.process(audio), jsep.process(audio), STEMS):
        _close(got, want, k)
    assert not tsep.process(audio)[2].any()


@pytest.mark.parametrize("kw", [{}, {"fast_rfft": False}, {"border": "replicate"}])
def test_blocked_pass_equals_unblocked(kw):
    """The blocked pass's guard frames are all-zero audio, whose feature
    is 1/0 = +inf, the prefill's: overlap-save over 16-frame blocks equals
    the batched pass bitwise, and the two-pass driver's blocked form its
    batched one."""
    _, tc = _cfgs(fs=1000.0, hop=8, causal=False, **kw)
    audio = _audio(8 * 90 + 3, 6)
    batched = T.hpr_separate(audio, tc)
    blocked = T.hpr_separate_blocked(audio, tc, block_frames=16)
    for k in STEMS:
        np.testing.assert_array_equal(blocked[k].numpy(), batched[k].numpy(), err_msg=k)
    sep = T.HPRIOffline(1000.0, 16, 8, use_sse=True, device="cpu", **kw)
    for a, b in zip(sep.process_blocked(audio, 16, 32), sep.process(audio)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_use_sse_filter_equals_use_sse():
    """The reference's toggle (hps.cu:322-332) on both drivers gives the
    flag's config and output. Toggled on a 'valid' stream it turns the
    border to 'wrap' as zen_tpu's toggle does, keeping the full spectrum
    the 'valid' config had already chosen (the flag at construction
    keeps the half spectrum)."""
    audio = _audio(8 * 30, 9)
    a = T.HPRRealtime(1000.0, 8, device="cpu")
    a.use_sse_filter()
    b = T.HPRRealtime(1000.0, 8, use_sse=True, device="cpu")
    assert a.cfg == b.cfg and a.cfg.use_sse
    np.testing.assert_array_equal(a.process_stream(audio, 6), b.process_stream(audio, 6))
    v = T.HPRRealtime(1000.0, 8, border="valid", device="cpu")
    v.use_sse_filter()
    jv = J.HPRRealtime(1000.0, 8, border="valid")
    jv.use_sse_filter()
    assert (v.cfg.border, v.cfg.fast_rfft) == (jv.cfg.border, jv.cfg.fast_rfft) == ("wrap", False)
    s = T.HPRIOffline(1000.0, 16, 8, device="cpu")
    s.use_sse_filter()
    u = T.HPRIOffline(1000.0, 16, 8, use_sse=True, device="cpu")
    for x, y in zip(s.process(audio), u.process(audio)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_state_carried_from_zen_tpu_continues_identically():
    """A zen_tpu SSE stream state, its history still holding +inf
    prefill rows, carried into the port through convert, continues as
    zen_tpu does."""
    rng = np.random.default_rng(10)
    first = rng.standard_normal((2, 6, 8)).astype(np.float32)
    rest = rng.standard_normal((3, 6, 8)).astype(np.float32)
    jrt, _ = _realtime_pair(1000.0, 8)
    for blk in first:
        jrt.process_block(blk)
    hist = np.asarray(jrt.state.feat_hist)
    assert np.isinf(hist).any() and np.isfinite(hist).any()
    trt = T.HPRRealtime(1000.0, 8, device="cpu")
    trt.cfg = T.config_from_fields(**dataclasses.asdict(jrt.cfg))
    trt.state = T.state_from_numpy(*(np.asarray(x) for x in jrt.state), device="cpu", cfg=trt.cfg)
    np.testing.assert_array_equal(trt.state.feat_hist[0].numpy(), hist)
    for blk in rest:
        _close(trt.process_block(blk).numpy(), np.asarray(jrt.process_block(blk)), "carried")
