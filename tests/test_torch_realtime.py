"""The port's streaming drivers against zen_tpu's, on the CPU.

Both packages get the same numpy audio; zen_tpu runs its jnp reference
path (median_impl='xla', fft_impl='xla'). Stems agree to
atol = 5e-5 x max(1, max|ref|) per stem — the repo's realtime parity
class (tests/test_engine_parity.py:271-275); the only source of
difference is FFT rounding between torch.fft and the XLA CPU FFT.
Comparisons within the port (multi vs single stream, resets) are
bitwise or at the same class where batch shapes differ.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu as J  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 5e-5
STEMS = ("harmonic", "percussive", "residual")


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    for i in range(got.shape[-2]):
        scale = max(1.0, float(np.abs(want[..., i, :]).max()))
        np.testing.assert_allclose(
            got[..., i, :] / scale, want[..., i, :] / scale, rtol=0, atol=ATOL,
            err_msg=f"{what} stem row {i}",
        )


def _pair(fs, hop, **kw):
    """(zen_tpu HPRRealtime, port HPRRealtime) on one config."""
    jc = J.HPRConfig(fs=fs, hop=hop, causal=True, median_impl="xla",
                     fft_impl="xla", **kw)
    jrt = J.HPRRealtime(fs, hop)
    jrt.cfg = jc
    jrt.reset_buffers()
    trt = T.HPRRealtime(fs, hop, device="cpu")
    trt.cfg = T.config_from_fields(**dataclasses.asdict(jc))
    trt.reset_buffers()
    return jrt, trt


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("block_hops", [1, 5, 13])
def test_process_stream_matches_zen_tpu(block_hops, fast, soft):
    """Block sizes 1 (B < history, per hop), 5 and 13 (ragged: 40 hops
    end in a 1-hop block; at fs 1000/hop 8 the history is 15 frames, so
    both B < H and the exact-size tail run)."""
    rng = np.random.default_rng(block_hops)
    audio = rng.standard_normal(8 * 40 - 3).astype(np.float32)
    jrt, trt = _pair(1000.0, 8, fast_rfft=fast, soft_mask=soft)
    want = np.asarray(jrt.process_stream(audio, block_hops=block_hops))
    got = trt.process_stream(audio, block_hops=block_hops)
    _close(got, want, f"B={block_hops} fast={fast} soft={soft}")


def test_process_stream_b_over_history_matches_zen_tpu():
    """fs 8000 / hop 64: B = 20 >= H = 15 takes the JAX pair route."""
    rng = np.random.default_rng(7)
    audio = rng.standard_normal(64 * 50).astype(np.float32)
    jrt, trt = _pair(8000.0, 64)
    _close(trt.process_stream(audio, 20), np.asarray(jrt.process_stream(audio, 20)))


def test_per_hop_api_matches_zen_tpu():
    rng = np.random.default_rng(8)
    hops = rng.standard_normal((12, 8)).astype(np.float32)
    jrt, trt = _pair(1000.0, 8, outputs=J.OUTPUT_PERCUSSIVE | J.OUTPUT_RESIDUAL)
    for h in hops:
        want = np.asarray(jrt.process_next_hop(h))
        got = trt.process_next_hop(h).numpy()
        _close(got, want)
        for name in ("copy_harmonic", "copy_percussive", "copy_residual"):
            np.testing.assert_allclose(
                getattr(trt, name)(), np.asarray(getattr(jrt, name)()),
                rtol=0, atol=ATOL * max(1.0, float(np.abs(want).max())),
            )
    assert not np.any(trt.copy_harmonic())  # disabled stem: zero row
    assert trt.latency_samples == jrt.latency_samples == 8


def test_warmup_and_toggles():
    rng = np.random.default_rng(9)
    audio = rng.standard_normal(8 * 30).astype(np.float32)
    a = T.HPRRealtime(1000.0, 8, device="cpu")
    a.warmup((1, 4))
    b = T.HPRRealtime(1000.0, 8, device="cpu")
    np.testing.assert_array_equal(a.process_stream(audio, 6), b.process_stream(audio, 6))
    a.use_soft_mask()
    c = T.HPRRealtime(1000.0, 8, soft_mask=True, device="cpu")
    np.testing.assert_array_equal(a.process_stream(audio, 6), c.process_stream(audio, 6))
    a.use_sse_filter()
    d = T.HPRRealtime(1000.0, 8, soft_mask=True, use_sse=True, device="cpu")
    assert a.cfg == d.cfg and a.cfg.use_sse
    np.testing.assert_array_equal(a.process_stream(audio, 6), d.process_stream(audio, 6))


def test_state_carried_from_zen_tpu_continues_identically():
    """Run zen_tpu for 4 blocks, carry its stream state into the port
    (the checkpoint handoff), then continue both on the same audio."""
    rng = np.random.default_rng(10)
    first = rng.standard_normal((4, 6, 8)).astype(np.float32)
    rest = rng.standard_normal((3, 6, 8)).astype(np.float32)
    jrt, _ = _pair(1000.0, 8)
    for blk in first:
        jrt.process_block(blk)
    trt = T.HPRRealtime(1000.0, 8, device="cpu")
    trt.cfg = T.config_from_fields(**dataclasses.asdict(jrt.cfg))
    trt.state = T.state_from_numpy(*(np.asarray(x) for x in jrt.state), device="cpu")
    for blk in rest:
        want = np.asarray(jrt.process_block(blk))
        got = trt.process_block(blk).numpy()
        _close(got, want, "after the state handoff")
    ring, hist, tail = T.state_to_numpy(trt.state)
    assert ring.shape == (1, 16) and tail.shape == (1, 3, 8)
    np.testing.assert_allclose(hist[0], np.asarray(jrt.state.feat_hist),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("border", ["valid", "replicate"])
def test_borders_match_zen_tpu(border):
    """HPRRealtime under the two other borders (full C2C spectrum), in
    ragged blocks of 5 hops at fs 1000 / hop 8 (H = 9 valid, 4
    replicate: B < H and B >= H both run)."""
    rng = np.random.default_rng(20)
    audio = rng.standard_normal(8 * 37 - 2).astype(np.float32)
    jrt, trt = _pair(1000.0, 8, border=border)
    assert not trt.cfg.fast_rfft and trt.cfg.time_offsets == jrt.cfg.time_offsets
    _close(trt.process_stream(audio, 5), np.asarray(jrt.process_stream(audio, 5)), border)


@pytest.mark.parametrize("border", ["wrap", "valid", "replicate"])
def test_hop64_stream_and_fleet_match_zen_tpu(border):
    """44.1 kHz at hop 64: K1 takes 47 taps (H = 91 wrap, 47 valid, 23
    replicate), its network on the card. HPRRealtime in blocks of 8 hops
    (B < H) and a ragged 3-hop tail, and a 4-stream MultiStreamHPR over 3
    blocks of 8, against zen_tpu."""
    rng = np.random.default_rng(64)
    audio = rng.standard_normal(64 * 27).astype(np.float32)
    jrt, trt = _pair(44100.0, 64, border=border)
    assert len(trt.cfg.time_offsets) == 47 and trt.cfg.time_offsets == jrt.cfg.time_offsets
    assert mc.time_route(trt.cfg.time_offsets) == "register"
    _close(trt.process_stream(audio, 8), np.asarray(jrt.process_stream(audio, 8)), border)
    blocks = rng.standard_normal((3, 4, 8, 64)).astype(np.float32)
    jms = J.MultiStreamHPR(4, 44100.0, hop=64, border=border, median_impl="xla",
                           fft_impl="xla")
    tms = T.MultiStreamHPR(4, 44100.0, hop=64, border=border, device="cpu")
    assert tms.cfg.time_offsets == trt.cfg.time_offsets
    for blk in blocks:
        _close(tms.process_block(blk).numpy(), np.asarray(jms.process_block(blk)),
               f"fleet {border}")


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_wide_fleet_b_under_history_matches_zen_tpu(state):
    """256 streams at B = 4 < H = 33 (fs 4000, hop 16): the shape class
    of zen_tpu's #4 route (C >= 256), f32 and bf16 stream state."""
    rng = np.random.default_rng(21)
    kw = dict(outputs=J.OUTPUT_PERCUSSIVE, stream_state=state)
    jms = J.MultiStreamHPR(256, 4000.0, hop=16, median_impl="xla", fft_impl="xla", **kw)
    tms = T.MultiStreamHPR(256, 4000.0, hop=16, **kw, device="cpu")
    want_dtype = torch.bfloat16 if state == "bf16" else torch.float32
    assert tms.state.feat_hist.dtype == want_dtype
    for _ in range(3):
        blk = rng.standard_normal((256, 4, 16)).astype(np.float32)
        got = tms.process_block(blk)
        assert got.dtype == torch.float32
        _close(got.numpy(), np.asarray(jms.process_block(blk)), state)
    assert tms.state.feat_hist.dtype == want_dtype
    # |S| rounds differently in the two FFTs: a feature can land one
    # bf16 step (2**-7 relative at most) or float noise away
    np.testing.assert_allclose(
        tms.state.feat_hist.float().numpy(), np.asarray(jms.state.feat_hist, np.float32),
        rtol=2**-7 if state == "bf16" else 1e-5, atol=1e-6)
    tms.reset_streams([0, 255])
    assert tms.state.feat_hist.dtype == want_dtype and not tms.state.feat_hist[0].any()


def test_bf16_state_carried_from_zen_tpu_continues_identically():
    """A JAX bf16 stream's state, read back as float32 numpy (exact) and
    carried into the port as bf16 through the config, continues as
    zen_tpu's does."""
    rng = np.random.default_rng(22)
    first = rng.standard_normal((3, 20, 64)).astype(np.float32)
    rest = rng.standard_normal((3, 20, 64)).astype(np.float32)
    jrt, _ = _pair(8000.0, 64, stream_state="bf16")
    for blk in first:
        jrt.process_block(blk)
    cfg = T.config_from_fields(**dataclasses.asdict(jrt.cfg))
    trt = T.HPRRealtime(8000.0, 64, stream_state="bf16", device="cpu")
    trt.cfg = cfg
    trt.state = T.state_from_numpy(*(np.asarray(x, np.float32) for x in jrt.state), cfg=cfg,
                                   device="cpu")
    assert trt.state.feat_hist.dtype == torch.bfloat16
    for blk in rest:
        _close(trt.process_block(blk).numpy(), np.asarray(jrt.process_block(blk)), "bf16")
    np.testing.assert_allclose(  # within one bf16 step, as above
        trt.state.feat_hist[0].float().numpy(), np.asarray(jrt.state.feat_hist, np.float32),
        rtol=2**-7, atol=1e-6)


def _fleet_blocks(seed, c=4, b=6, hop=8, n=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, c, b, hop)).astype(np.float32)


@pytest.mark.parametrize("outputs", [J.OUTPUT_ALL, J.OUTPUT_PERCUSSIVE])
def test_multistream_matches_zen_tpu_and_single_streams(outputs):
    """4 streams vs zen_tpu's MultiStreamHPR and vs 4 single streams of
    the port. The percussive-only fleet emits one compact row per
    stream (VERDICT weak #5): its value must equal the full output's
    percussive stem, stream by stream."""
    blocks = _fleet_blocks(11)
    jms = J.MultiStreamHPR(4, 1000.0, hop=8, outputs=outputs,
                           median_impl="xla", fft_impl="xla")
    tms = T.MultiStreamHPR(4, 1000.0, hop=8, outputs=outputs, device="cpu")
    assert tms.stem_rows == jms.stem_rows
    singles = [T.HPRRealtime(1000.0, 8, outputs=outputs, device="cpu") for _ in range(4)]
    for blk in blocks:
        got = tms.process_block(blk).numpy()
        _close(got, np.asarray(jms.process_block(blk)), "vs zen_tpu fleet")
        for s, rt in enumerate(singles):
            full = rt.process_block(blk[s]).numpy()  # [3, B*hop]
            for name, row in tms.stem_rows.items():
                if row is not None:
                    np.testing.assert_array_equal(
                        got[s, row], full[STEMS.index(name)], err_msg=name)
    if outputs == J.OUTPUT_PERCUSSIVE:
        assert got.shape[1] == 1 and tms.stem_rows["percussive"] == 0


def test_multistream_reset_streams_bit_exact():
    """A reset slot reproduces a fresh stream bit-exactly; untouched
    slots continue as if no reset happened (hps.h:296-321)."""
    b1, b2 = _fleet_blocks(12, n=2)
    ctrl = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu")
    ctrl.process_block(b1)
    ctrl2 = ctrl.process_block(b2).numpy()
    ms = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu")
    ms.process_block(b1)
    ms.reset_streams([1, 3])
    out2 = ms.process_block(b2).numpy()
    fresh2 = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu").process_block(b2).numpy()
    np.testing.assert_array_equal(out2[[0, 2]], ctrl2[[0, 2]])
    np.testing.assert_array_equal(out2[[1, 3]], fresh2[[1, 3]])
    assert not np.array_equal(out2[1], ctrl2[1])


@pytest.mark.parametrize(
    "indices,runs",
    [([1, 3], [(1, 2), (3, 4)]), ([2, 0, 1], [(0, 3)]), ([-1, 0, 3, 3], [(0, 1), (3, 4)]),
     ([], []), (range(4), [(0, 4)])],
)
def test_reset_streams_fills_runs_of_slots(indices, runs):
    """reset_streams takes its slots as runs of consecutive ones (filled
    through slices, with no index tensor), duplicates and negative slots
    folded; each run leaves the other slots untouched."""
    from zen_tpu_torch.drivers.realtime import _slot_runs

    assert _slot_runs(indices, 4) == runs
    b1, _ = _fleet_blocks(12, n=2)
    ms = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu")
    ms.process_block(b1)
    kept = [t.clone() for t in ms.state]
    fresh = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu").state
    ms.reset_streams(indices)
    hit = sorted({i % 4 for i in indices})
    rest = [i for i in range(4) if i not in hit]
    for got, was, new in zip(ms.state, kept, fresh):
        assert torch.equal(got[hit], new[hit]) and torch.equal(got[rest], was[rest])


@pytest.mark.parametrize("bad", [[4], [-5], [0, 7]])
def test_reset_streams_refuses_slots_outside_the_fleet(bad):
    ms = T.MultiStreamHPR(4, 1000.0, hop=8, device="cpu")
    with pytest.raises(T.ZenError, match="outside"):
        ms.reset_streams(bad)


def test_multistream_warmup_leaves_state_untouched():
    ms = T.MultiStreamHPR(2, 8000.0, hop=64, device="cpu")
    before = [t.clone() for t in ms.state]
    ms.warmup((4, 20))
    for a, b in zip(before, ms.state):
        assert torch.equal(a, b)
    with pytest.raises(T.ZenError):
        ms.process_block(np.zeros((3, 4, 64), np.float32))


def test_block_step_launch_count_on_cpu_is_zero():
    """CPU tensors run the plain twins: the kernel counters stay put."""
    n_time, n_freq = mc.tap_median_time.launches, mc.sliding_median_boundary.launches
    T.MultiStreamHPR(2, 1000.0, hop=8, device="cpu").process_block(np.ones((2, 3, 8), np.float32))
    assert (mc.tap_median_time.launches, mc.sliding_median_boundary.launches) == (
        n_time, n_freq)


@pytest.mark.parametrize("b", [3, 20])
def test_step_masks_and_advance_state_are_block_steps_halves(b):
    """step_masks reads the state without changing it; advance_state then
    moves ring and history exactly as block_step does, for B < H and
    B >= H (H = 15 at fs 8000 / hop 64). Bitwise."""
    from zen_tpu_torch.drivers import realtime as rt

    cfg = T.HPRConfig(fs=8000.0, hop=64, causal=True)
    rng = np.random.default_rng(13)
    warm, blocks = (torch.from_numpy(rng.standard_normal((2, b, 64)).astype(np.float32))
                    for _ in range(2))
    ref = rt.init_state(cfg, 2, device="cpu")
    rt.block_step(cfg, ref, warm)
    state = rt.StreamState(*(t.clone() for t in ref))
    rt.block_step(cfg, ref, blocks)
    step = rt.step_masks(cfg, state, blocks)
    assert len(step.masks) == 3 and step.feat.shape[:2] == (2, b)
    assert not torch.equal(state.feat_hist, ref.feat_hist)  # state untouched
    rt.advance_state(cfg, state, step)
    assert torch.equal(state.ring, ref.ring)
    assert torch.equal(state.feat_hist, ref.feat_hist)


@pytest.mark.parametrize(
    "make",
    [lambda: T.HPRRealtime(8000.0, 64),
     lambda: T.MultiStreamHPR(2, 8000.0, 64),
     lambda: T.HPRIOffline(8000.0, 256, 64),
     lambda: T.init_state(T.HPRConfig(fs=8000.0, hop=64, causal=True), 2),
     lambda: T.state_from_numpy(np.zeros(8), np.zeros((3, 5)), np.zeros(8))],
    ids=["HPRRealtime", "MultiStreamHPR", "HPRIOffline", "init_state", "state_from_numpy"],
)
def test_entry_points_default_to_the_card(make):
    """The drivers (and the state carried in from zen_tpu) live on the
    card unless device="cpu" is passed: without CUDA the default raises,
    naming device="cpu", and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs for real")
    with pytest.raises(T.ZenError, match='device="cpu"'):
        make()


def _smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
