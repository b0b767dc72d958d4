"""The DFT-matmul transform of the port (fft_impl='dft*', ops/fft.py) on
the CPU.

Yardsticks, each with its tolerance:
* the matrices: bitwise equal to zen_tpu's ``_dft_mats`` (both numpy);
* each mode's matmul against a float64 numpy emulation of its rounding
  (bf16 operands, rounded to nearest even, or bf16 hi/lo splits, or
  float32 operands): |got - emulation| <= 1e-5 x (|x| @ |W|) per output,
  room for float32 sums over up to 2 x 513 terms and 300x tighter than
  bf16's own rounding;
* ``dft_f32`` stems against zen_tpu's ``dft_f32``: 2e-5 x scale
  (tests/test_engine_parity.py:237-249);
* ``dft`` and ``dft_bf16`` stems at their classes, 3e-3 and 5e-2 x
  scale, against zen_tpu's run of the same mode and against the port's
  torch.fft stems: soft masks on every sample, hard masks on every
  sample no flipped mask bin feeds. zen_tpu's CPU computes these two
  modes in float32 (benches/quality.py:55-57), so against it the class
  holds the port's rounding alone; bf16 operands move bins near the
  noise floor across the hard-mask threshold, which the flip rule sets
  apart.
"""
import dataclasses
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import zen_tpu as J  # noqa: E402
from zen_tpu.drivers import offline as joff  # noqa: E402
from zen_tpu.engine import spectral as jsp  # noqa: E402
from zen_tpu.ops import fft as jfft  # noqa: E402
from zen_tpu.ops import framing as jframing  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers.offline import pass_masks, pass_stems  # noqa: E402
from zen_tpu_torch.engine import spectral as tsp  # noqa: E402
from zen_tpu_torch.ops import fft as tfft  # noqa: E402

MODES = ("dft_f32", "dft", "dft_bf16")
CLASS = {"dft_f32": 2e-5, "dft": 3e-3, "dft_bf16": 5e-2}
STEMS = ("harmonic", "percussive", "residual")


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _emulate(x: np.ndarray, w: np.ndarray, mode: str) -> np.ndarray:
    """The mode's products, exact in float64, of its rounded operands."""
    if mode == "dft_f32":
        return x.astype(np.float64) @ w.astype(np.float64)
    xh, wh = _bf16(x), _bf16(w)
    if mode == "dft_bf16":
        return xh @ wh
    xl, wl = _bf16(x - xh.astype(np.float32)), _bf16(w - wh.astype(np.float32))
    return xh @ wh + xh @ wl + xl @ wh


def _audio(n, seed, fs=8000.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    sig = (0.7 * np.sin(2 * np.pi * 440 * t) + 0.4 * (rng.random(n) > 0.99)
           + 0.05 * rng.standard_normal(n))
    return sig.astype(np.float32)


@pytest.mark.parametrize("nwin,nfft", [(16, 32), (128, 256), (512, 1024)])
def test_matrices_equal_zen_tpu(nwin, nfft):
    for got, want in zip(tfft._dft_mats(nwin, nfft), jfft._dft_mats(nwin, nfft)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nwin", [16, 128, 512])
def test_matmuls_match_their_rounding_emulated(mode, nwin):
    """Forward on [rows, nwin] frames and inverse on packed spectra,
    each against its emulation; dft_bf16's error against float64 is
    bf16's, dft's and dft_f32's far below it."""
    nfft = 2 * nwin
    rng = np.random.default_rng(nwin)
    x = rng.standard_normal((37, nwin)).astype(np.float32)
    p = rng.standard_normal((37, 2 * (nwin + 1))).astype(np.float32)
    w, wi = tfft._dft_mats(nwin, nfft)
    for inp, mat, got in (
        (x, w, tfft.dft_matmul(torch.from_numpy(x), nwin, nfft, False, mode)),
        (p, wi, tfft.dft_matmul(torch.from_numpy(p), nwin, nfft, True, mode)),
    ):
        assert got.dtype == torch.float32
        emu = _emulate(inp, mat, mode)
        bound = 1e-5 * (np.abs(inp).astype(np.float64) @ np.abs(mat).astype(np.float64))
        assert (np.abs(got.numpy() - emu) <= bound).all(), mode
        exact = inp.astype(np.float64) @ mat.astype(np.float64)
        rel = np.abs(got.numpy() - exact).max() / np.abs(exact).max()
        assert rel < {"dft_f32": 1e-6, "dft": 2e-5, "dft_bf16": 1e-2}[mode], rel
        if mode == "dft_bf16":
            assert rel > 1e-4  # the operands really are rounded to bf16


@pytest.mark.parametrize("mode", MODES)
def test_complex_spectrum_is_the_packed_matmul(mode):
    """analyze() is the forward matmul's re | im halves as complex, and
    synthesize_spectrum() the inverse matmul of the masked spectrum's
    halves."""
    cfg = T.HPRConfig(fs=8000.0, hop=64, causal=True, fft_impl=mode)
    assert tsp.dft_mode(cfg) == mode
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 5, 128))
                              .astype(np.float32))
    s = tsp.analyze(frames, cfg)
    packed = tfft.dft_matmul(tsp._windowed(frames, cfg), 128, 256, False, mode)
    np.testing.assert_array_equal(torch.cat([s.real, s.imag], -1).numpy(), packed.numpy())
    mask = torch.rand(3, 5, 129, generator=torch.Generator().manual_seed(0))
    masked = s * mask
    y = tfft.dft_matmul(torch.cat([masked.real, masked.imag], -1), 128, 256, True, mode)
    np.testing.assert_array_equal(tsp.synthesize_spectrum(masked, cfg).numpy(),
                                  (y * tsp._f32(cfg.synth_scale)).numpy())


def test_tf32_off_holds_the_switch_and_restores_it():
    """dft_f32's TF32 guard sets the process-wide switch off under its
    lock and puts it back as it was, whatever it was."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with tfft._tf32_off():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not tfft._TF32_LOCK.acquire(blocking=False)
            assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("mode", MODES)
def test_full_spectrum_takes_torch_fft(mode):
    """The replicate border runs the exact C2C path, which has no DFT
    form: fft_impl is ignored there, as in zen_tpu (spectral.py:50-51)."""
    audio = _audio(3000, 2)
    cfg = T.HPRConfig(fs=8000.0, hop=64, border="replicate", fft_impl=mode)
    ref = T.HPRConfig(fs=8000.0, hop=64, border="replicate")
    assert tsp.dft_mode(cfg) is None and not cfg.fast_rfft
    got, want = T.hpr_separate(audio, cfg), T.hpr_separate(audio, ref)
    for k in STEMS:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def _scaled_err(got, want, keep=None):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    d = np.abs(got - want) if keep is None else np.abs(got - want)[keep]
    return float(d.max(initial=0.0)) / scale


@pytest.mark.parametrize("block_hops", [1, 20])
def test_dft_f32_stream_matches_zen_tpu(block_hops):
    """The streaming step at fs 8000 / hop 64 (H = 15): B = 1 and B =
    20, against zen_tpu's dft_f32 step (its packed form)."""
    audio = _audio(64 * 50, 3)
    jc = J.HPRConfig(fs=8000.0, hop=64, causal=True, median_impl="xla", fft_impl="dft_f32")
    jr = J.HPRRealtime(8000.0, 64)
    jr.cfg = jc
    jr.reset_buffers()
    tr = T.HPRRealtime(8000.0, 64, fft_impl="dft_f32", device="cpu")
    assert dataclasses.replace(tr.cfg, median_impl="torch") == T.config_from_fields(
        **dataclasses.asdict(jc))
    want = np.asarray(jr.process_stream(audio, block_hops))
    got = tr.process_stream(audio, block_hops)
    for i in range(3):
        assert _scaled_err(got[i], want[i]) <= CLASS["dft_f32"], i


@pytest.mark.parametrize("soft", [False, True])
def test_dft_f32_offline_matches_zen_tpu(soft):
    """hpr_separate (the complex DFT form) and HPRIOffline against
    zen_tpu's dft_f32 (tests/test_engine_parity.py:222's config)."""
    audio = np.random.default_rng(11).standard_normal(6000).astype(np.float32)
    jc = J.HPRConfig(fs=8000.0, hop=64, causal=False, fft_impl="dft_f32", soft_mask=soft)
    tc = T.config_from_fields(**dataclasses.asdict(jc))
    want, got = joff.hpr_separate(audio, jc), T.hpr_separate(audio, tc)
    for k in STEMS:
        assert _scaled_err(got[k].numpy(), want[k]) <= CLASS["dft_f32"], k
    jsep = J.HPRIOffline(8000.0, 1024, 64, fft_impl="dft_f32", soft_mask=soft)
    tsep = T.HPRIOffline(8000.0, 1024, 64, fft_impl="dft_f32", soft_mask=soft, device="cpu")
    for g, w in zip(tsep.process(audio), jsep.process(audio)):
        assert _scaled_err(g.numpy(), w) <= CLASS["dft_f32"]


def _held_pass(audio: np.ndarray, cfg):
    """The port's pass: its stems, and the hard masks (harmonic,
    percussive) [frames, bins] those stems came from."""
    x = torch.from_numpy(audio)
    fm = pass_masks(x, cfg)
    stems = {k: v.numpy() for k, v in pass_stems(fm, cfg, x).items()}
    return stems, (fm.masks[0].numpy(), fm.masks[1].numpy())


def _offline_keep(ma, mb, hop: int, length: int) -> np.ndarray:
    """Output samples no flipped hard-mask bin feeds between two runs'
    masks (harmonic, percussive) (frame t feeds output chunks t - 1 and
    t), as chip_smoke's offline flip rule."""
    flipped = ((ma[0] != mb[0]) | (ma[1] != mb[1])).any(axis=-1)
    return ~np.repeat(flipped[:-1] | flipped[1:], hop)[:length]


@pytest.mark.parametrize("mode", ["dft", "dft_bf16"])
@pytest.mark.parametrize("soft", [False, True])
def test_reduced_precision_offline_within_class_of_torch_fft(mode, soft):
    """The same config's torch.fft stems as yardstick, at fs 8000 / hop
    64 on a tone, clicks and noise."""
    audio = _audio(6000, 4)
    cfg = T.HPRConfig(fs=8000.0, hop=64, fft_impl=mode, soft_mask=soft)
    ref = dataclasses.replace(cfg, fft_impl="torch")
    (got, m_got), (want, m_want) = _held_pass(audio, cfg), _held_pass(audio, ref)
    keep = None if soft else _offline_keep(m_got, m_want, cfg.hop, len(audio))
    if keep is not None:  # bf16 operands flip a bin in most frames here (0.18 held)
        assert keep.mean() > {"dft": 0.9, "dft_bf16": 0.1}[mode], keep.mean()
    for k in STEMS:
        assert _scaled_err(got[k], want[k], keep) <= CLASS[mode], k
    assert any(not np.array_equal(got[k], want[k]) for k in STEMS)  # no fallback to torch.fft


@pytest.mark.parametrize("mode", ["dft", "dft_bf16"])
def test_reduced_precision_stream_within_class_of_torch_fft(mode):
    """The streaming step under soft masks (continuous: every
    sample held), 3 streams of fs 8000 / hop 64 at B = 20."""
    audio = np.stack([_audio(64 * 40, s) for s in range(3)]).reshape(3, 2, 20, 64)
    outs = {}
    for impl in (mode, "torch"):
        ms = T.MultiStreamHPR(3, 8000.0, 64, soft_mask=True, fft_impl=impl, device="cpu")
        outs[impl] = torch.cat([ms.process_block(audio[:, j]) for j in range(2)], dim=2).numpy()
    for i in range(3):
        for e in range(2):
            assert _scaled_err(outs[mode][i, e], outs["torch"][i, e]) <= CLASS[mode], (i, e)


def _zen_tpu_pass(audio: np.ndarray, jc):
    """zen_tpu's offline pass (drivers/offline._pad_and_pass) run
    eagerly from its parts: its stems, and the hard masks (harmonic,
    percussive) [frames, bins] those stems came from."""
    length = audio.shape[-1]
    n = math.ceil(length / jc.hop) + jc.lag
    frames = jframing.frame_signal(jnp.asarray(np.pad(audio, (0, n * jc.hop - length))),
                                   jc.hop, n)
    ys = jsp.separate_frames(frames, jc)
    s = jsp.analyze(frames, jc)
    pm, hm, _ = jsp.compute_masks(*jsp.filter_features(jnp.abs(s), jc), jc)
    stems = {k: np.asarray(jframing.overlap_add_stream(y, jc.hop, advance=1)[:length])
             for k, y in ys.items()}
    return stems, (np.asarray(hm), np.asarray(pm))


@pytest.mark.parametrize("mode", ["dft", "dft_bf16"])
@pytest.mark.parametrize("soft", [False, True])
def test_reduced_precision_offline_within_class_of_zen_tpu(mode, soft):
    """One pass against zen_tpu's pass of the same mode at fs 8000 / hop
    64 on a tone, clicks and noise: soft masks through both packages'
    hpr_separate and HPRIOffline, hard masks under the flip rule on the
    masks of the two runs held."""
    audio = _audio(6000, 5)
    jc = J.HPRConfig(fs=8000.0, hop=64, causal=False, fft_impl=mode, soft_mask=soft)
    tc = T.config_from_fields(**dataclasses.asdict(jc))
    if soft:
        want, got = joff.hpr_separate(audio, jc), T.hpr_separate(audio, tc)
        for k in STEMS:
            assert _scaled_err(got[k].numpy(), want[k]) <= CLASS[mode], k
        jsep = J.HPRIOffline(8000.0, 1024, 64, fft_impl=mode, soft_mask=True)
        tsep = T.HPRIOffline(8000.0, 1024, 64, fft_impl=mode, soft_mask=True, device="cpu")
        for g, w in zip(tsep.process(audio), jsep.process(audio)):
            assert _scaled_err(g.numpy(), w) <= CLASS[mode]
        return
    (got, m_got), (want, m_want) = _held_pass(audio, tc), _zen_tpu_pass(audio, jc)
    keep = _offline_keep(m_got, m_want, tc.hop, len(audio))
    assert keep.mean() > {"dft": 0.9, "dft_bf16": 0.1}[mode], keep.mean()
    for k in STEMS:
        assert _scaled_err(got[k], want[k], keep) <= CLASS[mode], k


@pytest.mark.parametrize("mode", ["dft", "dft_bf16"])
@pytest.mark.parametrize("block_hops", [1, 20])
def test_reduced_precision_stream_within_class_of_zen_tpu(mode, block_hops):
    """HPRRealtime against zen_tpu's HPRRealtime of the same mode under
    soft masks (continuous: every sample held), fs 8000 / hop 64 (H =
    15) at B = 1 and B = 20."""
    audio = _audio(64 * 50, 6)
    jc = J.HPRConfig(fs=8000.0, hop=64, causal=True, median_impl="xla", fft_impl=mode,
                     soft_mask=True)
    jr = J.HPRRealtime(8000.0, 64)
    jr.cfg = jc
    jr.reset_buffers()
    tr = T.HPRRealtime(8000.0, 64, fft_impl=mode, soft_mask=True, device="cpu")
    assert dataclasses.replace(tr.cfg, median_impl="torch") == T.config_from_fields(
        **dataclasses.asdict(jc))
    want = np.asarray(jr.process_stream(audio, block_hops))
    got = tr.process_stream(audio, block_hops)
    for i in range(3):
        assert _scaled_err(got[i], want[i]) <= CLASS[mode], i
