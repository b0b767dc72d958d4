"""The port's parallel layer (zen_tpu_torch/parallel) against zen_tpu's, on
the CPU.

One counterpart of each test of tests/test_parallel.py: the same seeded
numpy audio goes through the port's sharded drivers on ``make_mesh(...,
device="cpu")`` meshes (the CPU repeated for every shard), the port's
unsharded drivers, and zen_tpu's sharded drivers on its forced 8-device
CPU mesh (tests/conftest.py). zen_tpu runs its jnp reference path
(median_impl='xla', fft_impl='xla'). Classes, each with its reason:
* port sharded against port unsharded: bitwise for the blocked scan
  (the same block body over the same samples); 5e-5 x max(1, max|ref|)
  for dp x sp (the transforms' batches differ);
* port against zen_tpu: the stem class of tests/test_torch_offline.py,
  5e-5 x max(1, max|ref|) (torch.fft against the XLA CPU FFT);
* TP: tests/test_parallel.py's 2e-4 x scale (partial-DFT matmuls
  against an FFT; zen_tpu's psum order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu as J  # noqa: E402
from zen_tpu.errors import ZenError as JZenError  # noqa: E402
from zen_tpu.parallel import mesh as jmesh  # noqa: E402
from zen_tpu.parallel import sharded as jsh  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from zen_tpu_torch.parallel import sharded as tsh  # noqa: E402

FS = 1000.0
HOP = 8
ATOL = 5e-5
TP_RTOL = 2e-4
STEMS = ("harmonic", "percussive", "residual")
XLA = dict(median_impl="xla", fft_impl="xla")


def _cfgs(**kw):
    """(zen_tpu config, the port's) on one set of fields."""
    kw.setdefault("fs", FS)
    kw.setdefault("hop", HOP)
    kw.setdefault("causal", False)
    kw.setdefault("outputs", J.OUTPUT_ALL)
    jc = J.HPRConfig(**kw, **XLA)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _meshes(axes):
    """(zen_tpu's mesh, the port's CPU mesh) of one shape."""
    return jmesh.make_mesh(axes), tmesh.make_mesh(axes, device="cpu")


def multichannel_audio(c=4, length=400, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    tone = np.sin(2 * np.pi * 50 * t)
    out = []
    for _ in range(c):
        clicks = (rng.random(length) > 0.97).astype(np.float32)
        out.append(0.6 * tone + 0.4 * clicks + 0.02 * rng.standard_normal(length))
    return np.stack(out).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=what)


def _tp_close(got, want, what, rtol=TP_RTOL):
    """tests/test_parallel.py's assert_close."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def _equal(got: dict, want: dict, stems=STEMS):
    for k in stems:
        assert torch.equal(got[k], want[k]), k


# ---------------- dp x sp: the batched pass ----------------


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_dp_sp_matches_unsharded(dp, sp):
    jm, tm = _meshes({"dp": dp, "sp": sp})
    audio = multichannel_audio(c=8)
    jc, tc = _cfgs()
    got = tsh.sharded_separate(audio, tc, tm)
    want = toff.hpr_separate(audio, tc)
    ref = jsh.sharded_separate(audio, jc, jm)
    for k in STEMS:
        assert got[k].shape == (8, 400) and got[k].device.type == "cpu"
        _close(got[k], want[k], f"{k} vs the port's hpr_separate")
        _close(got[k], ref[k], f"{k} vs zen_tpu's sharded_separate")


@pytest.mark.parametrize("variant", ["soft", "sse"])
def test_sp_variants_match(variant):
    jm, tm = _meshes({"dp": 2, "sp": 4})
    audio = multichannel_audio(c=2, length=480)
    jc, tc = _cfgs(soft_mask=variant == "soft", use_sse=variant == "sse")
    got = tsh.sharded_separate(audio, tc, tm)
    want = toff.hpr_separate(audio, tc)
    ref = jsh.sharded_separate(audio, jc, jm)
    for k in ("harmonic", "percussive"):
        _close(got[k], want[k], f"{k} vs the port's hpr_separate")
        _close(got[k], ref[k], f"{k} vs zen_tpu's sharded_separate")


def test_sharded_two_pass_matches_hpri_offline():
    jm, tm = _meshes({"dp": 2, "sp": 4})
    audio = multichannel_audio(c=2, length=500)
    jsep = J.HPRIOffline(FS, 16, 8, 2.0, 2.0, **XLA)
    tsep = T.HPRIOffline(FS, 16, 8, 2.0, 2.0, device="cpu")
    got = tsh.sharded_hpri_offline(audio, tsep.cfg_h, tsep.cfg_p, tm)
    want = tsep.process(audio)
    ref = jsh.sharded_hpri_offline(audio, jsep.cfg_h, jsep.cfg_p, jm)
    for name, g, w, r in zip(STEMS, got, want, ref):
        _close(g, w, f"{name} vs the port's process")
        _close(g, r, f"{name} vs zen_tpu's sharded_hpri_offline")


def test_sharded_two_pass_lengths_mask_each_track():
    """``lengths``: a track's stems do not depend on the longer tracks of
    its batch (zen_tpu's corpus relies on it): each row equals the lone
    track's process() within the class, and zen_tpu's run of the same
    batch."""
    jm, tm = _meshes({"dp": 2, "sp": 2})
    a, b = multichannel_audio(c=2, length=500, seed=4)
    batch = np.stack([a, np.where(np.arange(500) < 333, b, 0.0)]).astype(np.float32)
    tsep = T.HPRIOffline(FS, 16, 8, device="cpu")
    jsep = J.HPRIOffline(FS, 16, 8, 2.0, 2.0, **XLA)
    got = tsh.sharded_hpri_offline(batch, tsep.cfg_h, tsep.cfg_p, tm, lengths=[500, 333])
    ref = jsh.sharded_hpri_offline(batch, jsep.cfg_h, jsep.cfg_p, jm, lengths=[500, 333])
    for j, n in enumerate((500, 333)):
        for name, g, w, r in zip(STEMS, got, tsep.process(batch[j, :n]), ref):
            _close(g[j, :n], w, f"row {j} {name} vs the lone track")
            _close(g[j], r[j], f"row {j} {name} vs zen_tpu")


def test_sp_halo_too_small_raises():
    _, tm = _meshes({"dp": 1, "sp": 8})
    audio = multichannel_audio(c=1, length=60)  # tiny: the shards are narrower than the halo
    with pytest.raises(T.ZenError, match="halo"):
        tsh.sharded_separate(audio, _cfgs()[1], tm)
    with pytest.raises(T.ZenError, match="divisible by dp"):
        tsh.sharded_separate(multichannel_audio(c=3), _cfgs()[1],
                             tmesh.make_mesh({"dp": 2, "sp": 1}, device="cpu"))


# ---------------- sp: the blocked scan ----------------


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_sharded_blocked_matches_single_device(sp):
    """Bitwise to the port's unsharded blocked scan at every mesh width
    (the same blocks, the same priming arithmetic); zen_tpu's sharded
    scan within the class."""
    jm, tm = _meshes({"sp": sp})
    rng = np.random.default_rng(3)
    audio = rng.standard_normal(HOP * 280 + 13).astype(np.float32) * 0.3
    jc, tc = _cfgs()
    got = tsh.sharded_separate_blocked(audio, tc, tm, block_frames=32)
    _equal(got, toff.hpr_separate_blocked(audio, tc, block_frames=32))
    ref = jsh.sharded_separate_blocked(audio, jc, jm, block_frames=32)
    for k in STEMS:
        _close(got[k], ref[k], f"{k} vs zen_tpu")


@pytest.mark.parametrize(
    "kw",
    [dict(soft_mask=True), dict(border="replicate"), dict(use_sse=True)],
    ids=["soft", "replicate", "sse"],
)
def test_sharded_blocked_variants(kw):
    jm, tm = _meshes({"sp": 4})
    rng = np.random.default_rng(5)
    audio = rng.standard_normal(HOP * 200).astype(np.float32) * 0.3
    jc, tc = _cfgs(**kw)
    got = tsh.sharded_separate_blocked(audio, tc, tm, block_frames=16)
    _equal(got, toff.hpr_separate_blocked(audio, tc, block_frames=16), ("harmonic", "percussive"))
    ref = jsh.sharded_separate_blocked(audio, jc, jm, block_frames=16)
    for k in ("harmonic", "percussive"):
        _close(got[k], ref[k], f"{k} vs zen_tpu")


def test_sharded_blocked_two_pass_matches_process_blocked():
    jm, tm = _meshes({"sp": 4})
    rng = np.random.default_rng(6)
    audio = rng.standard_normal(3000).astype(np.float32) * 0.3
    tsep = T.HPRIOffline(FS, 16, 8, 2.0, 2.0, device="cpu")
    jsep = J.HPRIOffline(FS, 16, 8, 2.0, 2.0, **XLA)
    got = T.sharded_hpri_blocked(audio, tsep.cfg_h, tsep.cfg_p, tm,
                                 block_frames_h=16, block_frames_p=32)
    want = tsep.process_blocked(audio, 16, 32)
    ref = jsh.sharded_hpri_blocked(audio, jsep.cfg_h, jsep.cfg_p, jm,
                                   block_frames_h=16, block_frames_p=32)
    for name, g, w, r in zip(STEMS, got, want, ref):
        assert torch.equal(g, w), name
        _close(g, r, f"{name} vs zen_tpu")


def test_sharded_blocked_on_dp_sp_mesh():
    """The corpus hands its long tracks its dp x sp mesh: the blocked
    scan shards over sp and leaves dp alone."""
    jm, tm = _meshes({"dp": 2, "sp": 4})
    rng = np.random.default_rng(7)
    audio = rng.standard_normal(2000).astype(np.float32) * 0.3
    jc, tc = _cfgs()
    got = tsh.sharded_separate_blocked(audio, tc, tm, block_frames=16)
    _equal(got, toff.hpr_separate_blocked(audio, tc, block_frames=16))
    ref = jsh.sharded_separate_blocked(audio, jc, jm, block_frames=16)
    for k in STEMS:
        _close(got[k], ref[k], f"{k} vs zen_tpu")


def test_sharded_blocked_checkpointed_resumes_bitwise(tmp_path, monkeypatch):
    """Killed through on_segment after its first segment and called
    again: bitwise to the uninterrupted scan, resumed past the durable
    segment (the priming runs only on a fresh start); zen_tpu's meta
    keys; a corrupt checkpoint restarts from freshly primed tails."""
    _, tm = _meshes({"sp": 4})
    rng = np.random.default_rng(8)
    audio = rng.standard_normal(HOP * 400).astype(np.float32) * 0.3
    tc = _cfgs()[1]
    want = tsh.sharded_separate_blocked(audio, tc, tm, block_frames=16)

    class Killed(Exception):
        pass

    def kill(b, nbl):
        seen.append((b, nbl))
        raise Killed

    seen, ck = [], dict(ckpt_dir=str(tmp_path), tag="t", ckpt_every_blocks=2)
    with pytest.raises(Killed):
        tsh.sharded_separate_blocked_checkpointed(audio, tc, tm, 16, on_segment=kill, **ck)
    assert seen == [(2, 8)]
    from zen_tpu_torch.runtime.checkpoint import load_stream_state

    state, meta = load_stream_state(str(tmp_path / "t.ckpt.npz"), like=torch.zeros(4, 3, HOP))
    assert {k: meta[k] for k in ("bf", "nbl", "n_sp", "length", "next_block")} == {
        "bf": 16, "nbl": 8, "n_sp": 4, "length": len(audio), "next_block": 2}
    primes, real = [], tsh._prime
    monkeypatch.setattr(tsh, "_prime", lambda *a: primes.append(1) or real(*a))
    steps = []
    got = tsh.sharded_separate_blocked_checkpointed(
        audio, tc, tm, 16, on_segment=lambda b, n: steps.append(b), **ck)
    assert steps == [4, 6, 8] and primes == []
    _equal(got, want)
    (tmp_path / "t.ckpt.npz").write_bytes(b"not a checkpoint")
    got = tsh.sharded_separate_blocked_checkpointed(audio, tc, tm, 16, **ck)
    assert len(primes) == 4
    _equal(got, want)


# ---------------- frequency tensor parallelism ----------------


def test_tp_matches_unsharded():
    jm, tm = _meshes({"tp": 8})
    rng = np.random.default_rng(1)
    audio = rng.standard_normal(1600).astype(np.float32)
    # a realistic fs / nfft ratio, so that the frequency halo fits a shard
    jc, tc = _cfgs(fs=8000.0, hop=16, fast_rfft=False)
    got = tsh.tp_separate(audio, tc, tm)
    want = toff.hpr_separate(audio, tc)
    ref = jsh.tp_separate(audio, jc, jm)
    for k in STEMS:
        _tp_close(got[k], want[k], f"{k} vs the port's hpr_separate")
        _tp_close(got[k], ref[k], f"{k} vs zen_tpu's tp_separate")


def test_tp_realistic_nfft_precision():
    """The partial DFT's angles reduced as int32 (k n) mod nfft: parity at
    nfft 2048 (hop 512 at 44.1 kHz), where unreduced angles reach ~6e6
    radians."""
    jm, tm = _meshes({"tp": 4})
    rng = np.random.default_rng(12)
    audio = rng.standard_normal(512 * 40).astype(np.float32) * 0.4
    jc, tc = _cfgs(fs=44100.0, hop=512, fast_rfft=False)
    got = tsh.tp_separate(audio, tc, tm)
    want = toff.hpr_separate(audio, tc)
    ref = jsh.tp_separate(audio, jc, jm)
    for k in STEMS:
        _tp_close(got[k], want[k], f"{k} vs the port's hpr_separate")
        _tp_close(got[k], ref[k], f"{k} vs zen_tpu's tp_separate")


def test_tp_partial_outputs_and_soft_mask():
    """A disabled stem's placeholder has the enabled stems' length, and
    soft masks run: percussive-only and soft-mask configs at zen_tpu's
    tolerance (rtol 1e-4, atol 1e-2)."""
    rng = np.random.default_rng(8)
    audio = rng.standard_normal(800).astype(np.float32)
    jm, tm = _meshes({"tp": 4})
    for kw in (dict(outputs=J.OUTPUT_PERCUSSIVE), dict(soft_mask=True)):
        jc, tc = _cfgs(fs=8000.0, hop=16, **kw)
        got = tsh.tp_separate(audio, tc, tm)
        assert all(got[k].shape == (800,) for k in STEMS)
        for want in (toff.hpr_separate(audio, tc), jsh.tp_separate(audio, jc, jm)):
            np.testing.assert_allclose(_np(got["percussive"]), _np(want["percussive"]),
                                       rtol=1e-4, atol=1e-2)


def test_tp_hpri_offline_matches_unsharded():
    """The two-pass TP cascade (``zen-torch offline --mesh tp=N``) against
    process() with the exact C2C transform, and zen_tpu's cascade."""
    jm, tm = _meshes({"tp": 4})
    rng = np.random.default_rng(3)
    audio = rng.standard_normal(4000).astype(np.float32) * 0.5
    tsep = T.HPRIOffline(8000.0, hop_h=64, hop_p=16, beta_h=2.0, beta_p=2.0,
                         fast_rfft=False, device="cpu")
    jsep = J.HPRIOffline(8000.0, hop_h=64, hop_p=16, beta_h=2.0, beta_p=2.0, **XLA)
    got = T.tp_hpri_offline(audio, tsep.cfg_h, tsep.cfg_p, tm)
    want = tsep.process(audio)
    ref = jsh.tp_hpri_offline(audio, *(dataclasses.replace(c, fast_rfft=False)
                                       for c in (jsep.cfg_h, jsep.cfg_p)), jm)
    for name, g, w, r in zip(STEMS, got, want, ref):
        _tp_close(g, w, f"{name} vs the port's process")
        _tp_close(g, r, f"{name} vs zen_tpu's tp_hpri_offline")


def test_tp_refusals():
    """zen_tpu's refusals: a border other than wrap, a width that does not
    divide nfft, and shards narrower than the frequency halo."""
    tm = tmesh.make_mesh({"tp": 3}, device="cpu")
    audio = np.zeros(800, np.float32)
    with pytest.raises(T.ZenError, match="wrap border"):
        tsh.tp_separate(audio, _cfgs(fs=8000.0, hop=16, border="replicate")[1], tm)
    with pytest.raises(T.ZenError, match="must divide nfft"):
        tsh.tp_separate(audio, _cfgs(fs=8000.0, hop=16)[1], tm)
    with pytest.raises(T.ZenError, match="frequency halo"):
        tsh.tp_separate(audio, _cfgs(fs=1000.0, hop=16)[1],
                        tmesh.make_mesh({"tp": 64}, device="cpu"))


# ---------------- the mesh ----------------


def test_make_mesh_shapes_devices_and_refusals():
    """Axis order is the dict's; the CPU repeats for every shard; an
    explicit list may repeat a device; a wrong count raises zen_tpu's
    message; without CUDA a card mesh raises (no fallback)."""
    m = tmesh.make_mesh({"dp": 2, "sp": 3}, device="cpu")
    assert m.shape == {"dp": 2, "sp": 3} and m.axis_names == ("dp", "sp")
    assert m.devices.shape == (2, 3) and all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.size("tp") == 1 and m.device(dp=1, sp=2) == torch.device("cpu")
    m = tmesh.make_mesh({"tp": 4}, devices=["cpu"] * 4)
    assert m.devices.shape == (4,) and m.first == torch.device("cpu")
    with pytest.raises(T.ZenError, match=r"mesh axes \{'dp': 2, 'sp': 2\} need 4 devices, got 3"):
        tmesh.make_mesh({"dp": 2, "sp": 2}, devices=["cpu"] * 3)
    with pytest.raises(JZenError, match=r"mesh axes \{'dp': 2, 'sp': 2\} need 4 devices, got 3"):
        jmesh.make_mesh({"dp": 2, "sp": 2}, devices=jmesh.jax.devices()[:3])
    if not torch.cuda.is_available():
        with pytest.raises(T.ZenError, match="is_available"):
            tmesh.make_mesh({"dp": 2})


def test_default_mesh_follows_zen_tpu(monkeypatch):
    """default_mesh over one CPU device is dp=1, sp=1 whatever the hint;
    over n devices (zen_tpu's 8 forced CPU devices) the same rule picks
    the same shape in both packages."""
    for hint in (0, 1, 5):
        assert tmesh.default_mesh(hint, device="cpu").shape == {"dp": 1, "sp": 1}
    for hint in (0, 1, 3, 6, 8, 20):
        jm = jmesh.default_mesh(hint)
        with monkeypatch.context() as m:
            m.setattr(tmesh, "visible_devices", lambda device="cuda": 8)
            assert tmesh.default_mesh(hint, device="cpu").shape == dict(
                zip(jm.axis_names, jm.devices.shape)), hint


# ---------------- MultiStreamHPR(mesh=) ----------------


def _fleet_blocks(seed, c=8, n=3, b=5, hop=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((c, b, hop)).astype(np.float32) * 0.5 for _ in range(n)]


@pytest.mark.parametrize("dp", [2, 4])
def test_multistream_mesh_matches_unsharded_and_zen_tpu(dp):
    """8 streams over dp shards: bitwise to the unsharded fleet on the CPU
    (a shard's step is the fleet's on its rows, and the CPU FFT's rows do
    not depend on their batch), in stream order on the first device, and
    within the stem class of zen_tpu's fleet sharded over
    make_mesh({"dp": 4})."""
    tm = tmesh.make_mesh({"dp": dp}, device="cpu")
    ms = T.MultiStreamHPR(8, FS, hop=8, mesh=tm)
    one = T.MultiStreamHPR(8, FS, hop=8, device="cpu")
    jms = J.MultiStreamHPR(8, FS, hop=8, mesh=jmesh.make_mesh({"dp": 4}), **XLA)
    assert len(ms.shards) == dp and ms.stem_rows == one.stem_rows
    ms.warmup((5,))
    for blk in _fleet_blocks(21):
        got = ms.process_block(blk)
        assert got.shape == (8, 3, 40) and got.device == ms.device
        assert torch.equal(got, one.process_block(blk))
        want = np.asarray(jms.process_block(blk))
        for row in range(3):
            _close(got[:, row], want[:, row], f"stem row {row} vs zen_tpu")


def test_multistream_mesh_resets_and_refusals():
    """reset_streams on a sharded fleet: the slots of every shard they
    touch, bitwise to the unsharded fleet's reset; streams that dp does
    not divide raise; a sharded fleet has no single ``state``."""
    tm = tmesh.make_mesh({"dp": 4}, device="cpu")
    ms = T.MultiStreamHPR(8, FS, hop=8, mesh=tm)
    one = T.MultiStreamHPR(8, FS, hop=8, device="cpu")
    b1, b2 = _fleet_blocks(22, n=2)
    ms.process_block(b1)
    one.process_block(b1)
    for fleet in (ms, one):
        fleet.reset_streams([1, 2, 3, -1])
    assert torch.equal(ms.process_block(b2), one.process_block(b2))
    with pytest.raises(T.ZenError, match="divisible by dp"):
        T.MultiStreamHPR(6, FS, hop=8, mesh=tm)
    with pytest.raises(T.ZenError, match="one state per shard"):
        ms.state
    assert T.MultiStreamHPR(8, FS, hop=8, mesh=tmesh.make_mesh({"dp": 1}, device="cpu")).state \
        .ring.shape == (8, 16)
