"""The port's offline drivers against zen_tpu's, on the CPU.

Both packages get the same numpy audio; zen_tpu runs its jnp reference
path (median_impl='xla', fft_impl='xla'). Tolerances, each with its
reason:
* stems: atol = 5e-5 x max(1, max|ref|) per stem, the repo's parity
  class for the batched passes (tests/test_engine_parity.py:271-275);
  torch.fft and the XLA CPU FFT round differently, nothing else differs;
* filtered features and masks: bitwise, given the same |S| (medians are
  selection, masks float32 elementwise math in the same order);
* framing, blocked vs unblocked, strict vs default: bitwise, one package
  and one arithmetic;
* against the hop-by-hop oracle: the oracle suite's 5e-4 class
  (tests/test_engine_parity.py:46-49).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import zen_tpu as J  # noqa: E402
from zen_tpu.drivers import offline as joff  # noqa: E402
from zen_tpu.engine import spectral as jsp  # noqa: E402
from zen_tpu.engine.oracle import oracle_offline_pass  # noqa: E402
from zen_tpu.ops import framing as jfr  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.engine import spectral as tsp  # noqa: E402
from zen_tpu_torch.ops import framing as tfr  # noqa: E402

ATOL = 5e-5
STEMS = ("harmonic", "percussive", "residual")
XLA = dict(median_impl="xla", fft_impl="xla")


def _close(got, want, what="", atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == np.float32, (what, got.dtype)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=what)


def _cfgs(**kw):
    base = dict(fs=1000.0, hop=8, causal=False, **XLA)
    base.update(kw)
    jc = J.HPRConfig(**base)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _separators(fs, hop_h, hop_p, **kw):
    return (J.HPRIOffline(fs, hop_h, hop_p, **XLA, **kw),
            T.HPRIOffline(fs, hop_h, hop_p, **kw, device="cpu"))


def _audio(n, seed, *lead):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(lead + (n,)).astype(np.float32)


def test_framing_matches_zen_tpu():
    x = _audio(61, 0, 2)
    for n_frames in (3, 8, 9):  # audio cut, exact and zero-extended
        want = np.asarray(jfr.frame_signal(jnp.asarray(x), 8, n_frames))
        got = tfr.frame_signal(torch.from_numpy(x), 8, n_frames).numpy()
        np.testing.assert_array_equal(got, want)
    y = _audio(16, 1, 2, 7)
    for advance in (0, 1):
        want = np.asarray(jfr.overlap_add_stream(jnp.asarray(y), 8, advance))
        got = tfr.overlap_add_stream(torch.from_numpy(y), 8, advance).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("soft", [False, True])
def test_hpr_separate_matches_zen_tpu(soft, fast):
    jc, tc = _cfgs(soft_mask=soft, fast_rfft=fast)
    audio = _audio(8 * 40 + 5, 2)
    want = joff.hpr_separate(audio, jc)
    got = T.hpr_separate(audio, tc)
    for k in STEMS:
        _close(got[k], want[k], f"{k} soft={soft} fast={fast}")


@pytest.mark.parametrize("fs,hop", [(1000.0, 8), (8000.0, 64), (1000.0, 128)])
def test_filter_features_and_masks_bitwise(fs, hop):
    """Offline (centered) taps. fs 1000 / hop 128 runs the frequency
    median at K = 257 over 257 bins, past K2's old 255 cap."""
    jc, tc = _cfgs(fs=fs, hop=hop)
    rng = np.random.default_rng(3)
    mag = rng.random((2, 23, tsp.num_bins(tc)), dtype=np.float32)
    jh, jp = jsp.filter_features(jnp.asarray(mag), jc)
    # the steps frame_masks composes
    feats = tsp.feature_transform(torch.from_numpy(mag), tc)
    h, p = tsp.time_filtered(feats, tc), tsp.freq_filtered(feats, tc)
    th, tp = tsp.finalize_features(h, p, tc)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    want = jsp.compute_masks(jh, jp, jc)
    got = tsp.feature_masks(h, p, tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "fs,hop_h,hop_p,length",
    [(1000.0, 16, 8, 97), (1000.0, 16, 8, 128), (1000.0, 16, 8, 129),
     (1000.0, 16, 8, 700), (8000.0, 1024, 64, 6000)],
)
def test_process_matches_zen_tpu(fs, hop_h, hop_p, length):
    """Lengths off, on and past whole hops (zen_tpu buckets them to a
    power of two, the port does not); fs 8000 / hop 1024 runs pass 1's
    frequency median at K = 257 over 2049 bins."""
    jsep, tsep = _separators(fs, hop_h, hop_p)
    audio = _audio(length, 4)
    got = tsep.process(audio)
    for g, w, k in zip(got, jsep.process(audio), STEMS):
        assert g.shape == (length,)
        _close(g, w, f"{k} fs={fs} L={length}")


@pytest.mark.parametrize("border", ["valid", "replicate"])
def test_process_borders_match_zen_tpu(border):
    """HPRIOffline(..., border=) against zen_tpu's on the full C2C
    spectrum. At fs 8000 / hop 256 l_harm is 2, so under 'valid' pass 1
    never writes its lag row and masks against zeros
    (lag_row_written). stream_state is ignored offline, as in zen_tpu."""
    jsep, tsep = _separators(8000.0, 256, 64, border=border)
    assert tsep.cfg_h.lag_row_written == (border != "valid") == jsep.cfg_h.lag_row_written
    audio = _audio(3000, 7)
    got = tsep.process(audio)
    for g, w, k in zip(got, jsep.process(audio), STEMS):
        _close(g, w, f"{k} {border}")
    bf16 = T.HPRIOffline(8000.0, 256, 64, border=border, stream_state="bf16", device="cpu")
    for g, g16 in zip(got, bf16.process(audio)):
        np.testing.assert_array_equal(g16.numpy(), g.numpy())


def test_process_leading_channel_dim():
    jsep, tsep = _separators(1000.0, 32, 8)
    audio = _audio(300, 5, 2)
    got = tsep.process(audio)
    for g, w, k in zip(got, jsep.process(audio), STEMS):
        _close(g, w, k)
    for c in range(2):
        for g1, g in zip(tsep.process(audio[c]), got):
            np.testing.assert_array_equal(g1.numpy(), g[c].numpy())


def test_soft_mask_toggle_matches_zen_tpu():
    jsep, tsep = _separators(1000.0, 16, 8)
    jsep.use_soft_mask()
    tsep.use_soft_mask()
    assert tsep.cfg_h.soft_mask and tsep.cfg_p.soft_mask
    audio = _audio(250, 6)
    for g, w, k in zip(tsep.process(audio), jsep.process(audio), STEMS):
        _close(g, w, k)


def test_strict_ref_silent_residual():
    """strict_ref: pass 2 percussive-only, residual stem silence, and
    harmonic and percussive bitwise equal to the default mode, batched
    and blocked (tests/test_engine_parity.py:186)."""
    audio = _audio(200, 11)
    sep = T.HPRIOffline(1000.0, 16, 8, device="cpu")
    strict = T.HPRIOffline(1000.0, 16, 8, strict_ref=True, device="cpu")
    h, p, r = sep.process(audio)
    hs, ps, rs = strict.process(audio)
    np.testing.assert_array_equal(hs.numpy(), h.numpy())
    np.testing.assert_array_equal(ps.numpy(), p.numpy())
    assert float(r.abs().max()) > 1e-6
    assert not rs.any()
    hb, pb, rb = strict.process_blocked(audio, 16, 32)
    assert not rb.any()
    np.testing.assert_array_equal(pb.numpy(), ps.numpy())


def test_rejects_what_is_not_ported_or_invalid(tmp_path):
    with pytest.raises(T.ZenError, match="divisible"):
        T.HPRIOffline(1000.0, 16, 12, device="cpu")
    sep = T.HPRIOffline(1000.0, 16, 8, device="cpu")
    for ckpt_dir in (None, str(tmp_path)):  # checkpoints are ported: same checks
        with pytest.raises(T.ZenError, match="expects \\[L\\]"):
            sep.process_blocked(np.zeros((2, 64), np.float32), ckpt_dir=ckpt_dir)
    with pytest.raises(T.ZenError, match="lies on"):
        sep.process(torch.zeros(64, device="meta"))
    # the SSE toggle is ported: it gives the configs use_sse=True gives
    sse = T.HPRIOffline(1000.0, 16, 8, use_sse=True, device="cpu")
    sep.use_sse_filter()
    assert (sep.cfg_h, sep.cfg_p) == (sse.cfg_h, sse.cfg_p) and sep.cfg_p.use_sse
    audio = _audio(200, 12)
    for a, b in zip(sep.process(audio), sse.process(audio)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize(
    "kw", [{}, {"causal": True}, {"soft_mask": True}, {"fast_rfft": False},
           {"border": "valid"}, {"border": "replicate"}]
)
def test_blocked_pass_equals_unblocked(kw):
    """Overlap-save over 16-frame blocks == the batched pass, bitwise on
    the CPU (tests/test_engine_parity.py:477 holds zen_tpu's at 1e-4)."""
    _, tc = _cfgs(**kw)
    audio = _audio(8 * 57 + 3, 60)
    want = T.hpr_separate(audio, tc)
    got = T.hpr_separate_blocked(audio, tc, block_frames=16)
    for k in STEMS:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # the flip recount's masks are the batched pass's, frame by frame
    for b, u in zip(toff.blocked_pass_masks(torch.from_numpy(audio), tc, 16),
                    toff.pass_masks(torch.from_numpy(audio), tc).masks):
        if u is None:
            assert b is None
            continue
        np.testing.assert_array_equal(b[: len(u)].numpy(), u.numpy())


def test_process_blocked_equals_process():
    audio = _audio(4000, 61)
    sep = T.HPRIOffline(1000.0, 32, 8, device="cpu")
    want = sep.process(audio)
    got = sep.process_blocked(audio, block_frames_h=16, block_frames_p=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _oracle_audio(length, seed):
    """The oracle suite's fixture (tests/test_engine_parity.py:35)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 1000.0
    sig = (0.7 * np.sin(2 * np.pi * 50 * t) + 0.4 * (rng.random(length) > 0.97)
           + 0.05 * rng.standard_normal(length))
    return sig.astype(np.float32)


def _oracle_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * scale)


@pytest.mark.parametrize("soft", [False, True])
def test_pass_matches_oracle(soft):
    jc, tc = _cfgs(fast_rfft=False, soft_mask=soft)
    audio = _oracle_audio(101, 0)
    want = oracle_offline_pass(audio, jc)
    got = T.hpr_separate(audio, tc)
    for k in STEMS:
        _oracle_close(got[k], want[k])


def test_two_pass_matches_oracle():
    """HPR-I cascade vs the oracle's two passes (hps.cu:128-221)."""
    audio = _oracle_audio(130, 9)
    h, p, r = T.HPRIOffline(1000.0, 16, 8, fast_rfft=False, device="cpu").process(audio)
    jc_h, _ = _cfgs(hop=16, fast_rfft=False)
    pass1 = oracle_offline_pass(audio, jc_h)
    inter = pass1["percussive"] + pass1["residual"]
    jc_p, _ = _cfgs(fast_rfft=False, outputs=J.OUTPUT_PERCUSSIVE | J.OUTPUT_RESIDUAL)
    pass2 = oracle_offline_pass(inter, jc_p)
    _oracle_close(h, pass1["harmonic"])
    _oracle_close(p, pass2["percussive"])
    _oracle_close(r, pass2["residual"])


def test_process_keeps_the_device_of_its_input():
    sep = T.HPRIOffline(1000.0, 16, 8, device="cpu")
    audio = torch.from_numpy(_audio(100, 7)).double()
    outs = sep.process(audio)
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in outs)
