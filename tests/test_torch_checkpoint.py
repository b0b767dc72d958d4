"""The port's checkpoints (zen_tpu_torch/runtime/checkpoint.py) and the
mid-track checkpointed blocked pass (drivers/offline.py), on the CPU.

Stream states cross between the packages in zen_tpu's .npz layout: a
state zen_tpu saved (f32, and with a bf16 history, which numpy without
ml_dtypes reads as raw |V2 bytes) loads into the port and continues
bitwise equal to the port's uninterrupted run (the counterpart of
tests/test_runtime.py:127); an f32 state the port saved loads in zen_tpu.
A state zen_tpu computed itself continues in the port within the
realtime parity class (5e-5 x max(1, max|ref|), tests/test_engine_parity.py:271-275).
A crash and a resume of the checkpointed pass give stems bitwise equal to
an uninterrupted run and to hpr_separate_blocked (tests/test_runtime.py:492);
a stale config (:545) and a corrupt next_block (:875) restart from zero.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import zen_tpu as J  # noqa: E402
from zen_tpu.drivers import realtime as jrt  # noqa: E402
from zen_tpu.runtime import checkpoint as jck  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers.offline import (  # noqa: E402
    clear_track_checkpoint,
    hpr_separate_blocked,
    hpr_separate_blocked_checkpointed,
)
from zen_tpu_torch.runtime.checkpoint import (  # noqa: E402
    ProgressJournal,
    load_stream_state,
    save_stream_state,
    save_stream_state_durable,
)

FS, HOP = 1000.0, 8
STEMS = ("harmonic", "percussive", "residual")


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return (0.6 * np.sin(2 * np.pi * 60 * t) + 0.4 * (rng.random(n) > 0.96)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _cfgs(**kw):
    jc = J.HPRConfig(fs=FS, hop=HOP, causal=True, median_impl="xla", fft_impl="xla", **kw)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _port_run(cfg, hops, state=None):
    """The port's block_step hop by hop from ``state`` (fresh when None):
    (outputs [n, 3, hop], state)."""
    state = state or T.init_state(cfg, 1, "cpu")
    outs = [T.block_step(cfg, state, h[None, None])[0] for h in hops]
    return torch.stack(outs).numpy(), state


def _jax_state(state, cfg):
    """The port's one-stream state as zen_tpu's StreamState (the bf16
    history cast back exactly)."""
    ring, hist, tail = (t[0].float().numpy() for t in state)
    dtype = jnp.bfloat16 if cfg.stream_state == "bf16" else jnp.float32
    return jrt.StreamState(jnp.asarray(ring), jnp.asarray(hist, dtype), jnp.asarray(tail))


@pytest.mark.parametrize("stream_state", ["f32", "bf16"])
def test_state_saved_by_zen_tpu_continues_bitwise(tmp_path, stream_state):
    _, cfg = _cfgs(stream_state=stream_state)
    hops = torch.from_numpy(_audio(40 * HOP, 1).reshape(40, HOP))
    want, _ = _port_run(cfg, hops)
    _, state = _port_run(cfg, hops[:20])
    jck.save_stream_state(str(tmp_path / "ckpt"), _jax_state(state, cfg), {"hops_done": 20})
    with np.load(tmp_path / "ckpt.npz") as data:
        assert data["leaf_1"].dtype == (np.dtype("V2") if stream_state == "bf16" else np.float32)
        assert data["leaf_0"].shape == (cfg.nwin,)  # zen_tpu's state has no stream axis
    restored, meta = load_stream_state(str(tmp_path / "ckpt"), T.init_state(cfg, 1, "cpu"))
    assert meta == {"hops_done": 20}
    assert restored.feat_hist.dtype == state.feat_hist.dtype
    for a, b in zip(restored, state):
        assert torch.equal(a, b)
    got, _ = _port_run(cfg, hops[20:], restored)
    np.testing.assert_array_equal(got, want[20:])


def test_state_zen_tpu_computed_continues_within_the_parity_class(tmp_path):
    jc, cfg = _cfgs()
    audio = _audio(40 * HOP, 2)
    blocks = jnp.asarray(audio.reshape(40, HOP))
    jstate, jouts = jrt.init_state(jc), []
    for k in range(40):
        jstate, o = jrt.block_step(jc, jstate, blocks[k : k + 1])
        jouts.append(np.asarray(o))
        if k == 19:
            jck.save_stream_state(str(tmp_path / "ckpt"), jstate, {"hops_done": 20})
    restored, _ = load_stream_state(str(tmp_path / "ckpt"), T.init_state(cfg, 1, "cpu"))
    got, _ = _port_run(cfg, torch.from_numpy(audio.reshape(40, HOP))[20:], restored)
    want = np.stack(jouts[20:])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=5e-5)


def test_state_saved_by_the_port_loads_in_zen_tpu(tmp_path):
    jc, cfg = _cfgs()
    _, state = _port_run(cfg, torch.from_numpy(_audio(24 * HOP, 3).reshape(24, HOP)))
    save_stream_state(str(tmp_path / "port"), state, {"hops_done": 24})
    restored, meta = jck.load_stream_state(str(tmp_path / "port"), jrt.init_state(jc))
    assert meta == {"hops_done": 24}
    for a, b in zip(restored, state):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())


@pytest.mark.parametrize("stream_state", ["f32", "bf16"])
def test_multistream_state_roundtrip_keeps_the_stream_axis(tmp_path, stream_state):
    _, cfg = _cfgs(stream_state=stream_state)
    ms = T.MultiStreamHPR(3, FS, HOP, stream_state=stream_state, device="cpu")
    ms.process_block(torch.from_numpy(_audio(3 * 5 * HOP, 4).reshape(3, 5, HOP)))
    save_stream_state_durable(str(tmp_path / "ms"), ms.state, {"c": 3})
    assert not (tmp_path / "ms.npz.tmp").exists()
    with np.load(tmp_path / "ms.npz") as data:
        assert data["leaf_2"].shape == (3, 3, HOP)
    restored, meta = load_stream_state(str(tmp_path / "ms.npz"),
                                       T.init_state(ms.cfg, 3, "cpu"))
    assert meta == {"c": 3}
    for a, b in zip(restored, ms.state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(T.ZenError, match="shape"):
        load_stream_state(str(tmp_path / "ms.npz"), T.init_state(ms.cfg, 2, "cpu"))


def test_progress_journal(tmp_path):
    path = str(tmp_path / "p.jsonl")
    j = ProgressJournal(path)
    assert not j.is_done("a")
    j.mark_done("a", {"samples": 5})
    assert j.is_done("a")
    jck.ProgressJournal(path).mark_done("z")  # zen_tpu's journal: the same file
    with open(path, "a") as fh:
        fh.write('{"id": "b", "sampl')  # a crash mid-append
    j2 = ProgressJournal(path)
    assert j2.is_done("a") and j2.is_done("z") and not j2.is_done("b")
    assert jck.ProgressJournal(path).is_done("a")
    j2.mark_done("c")  # not glued to the torn line
    assert ProgressJournal(path).is_done("c")
    assert json.loads(open(path).read().splitlines()[0]) == {"id": "a", "samples": 5}


class _Crash(Exception):
    pass


def _bomb(at):
    def hook(next_block, n_blocks):
        if next_block >= at:
            raise _Crash
    return hook


def _offline_cfg(**kw):
    return T.HPRConfig(fs=FS, hop=HOP, causal=False, **kw)


def test_midtrack_crash_and_resume_bitwise(tmp_path):
    audio = _audio(900, 11)
    cfg = _offline_cfg()
    want = hpr_separate_blocked(audio, cfg, block_frames=4)
    kw = dict(block_frames=4, ckpt_every_blocks=2, tag="trk")
    crashed = str(tmp_path / "crashed")
    with pytest.raises(_Crash):
        hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=crashed, on_segment=_bomb(4), **kw)
    _, meta = load_stream_state(os.path.join(crashed, "trk.ckpt.npz"), torch.zeros(3, HOP))
    assert meta["next_block"] == 4 and meta["nb"] == 32
    seen = []
    resumed = hpr_separate_blocked_checkpointed(
        audio, cfg, ckpt_dir=crashed, on_segment=lambda b, n: seen.append(b), **kw)
    assert seen[0] == 6 and seen[-1] == 32  # the resume starts after the durable segment
    clean = hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=str(tmp_path / "clean"), **kw)
    for k in STEMS:
        assert resumed[k].dtype == torch.float32 and resumed[k].shape == (900,)
        np.testing.assert_array_equal(resumed[k].numpy(), clean[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(resumed[k].numpy(), want[k].numpy(), err_msg=k)
    clear_track_checkpoint(crashed, "trk")
    assert os.listdir(crashed) == []


@pytest.mark.parametrize("crash_in", ["p1", "p2"])
def test_process_blocked_crash_and_resume_bitwise(tmp_path, crash_in):
    audio = _audio(1500, 12)
    sep = T.HPRIOffline(FS, 32, 8, device="cpu")
    kw = dict(block_frames_h=4, block_frames_p=16, ckpt_every_blocks=2, tag="song")
    want = sep.process_blocked(audio, block_frames_h=4, block_frames_p=16)
    d = str(tmp_path)
    calls = []

    def hook(b, n):
        calls.append(b)
        # pass 1 has 16 blocks of 4 frames; pass 2's crash comes on its first segment
        if (crash_in == "p1" and len(calls) == 2) or (crash_in == "p2" and len(calls) == 9):
            raise _Crash

    with pytest.raises(_Crash):
        sep.process_blocked(audio, ckpt_dir=d, on_segment=hook, **kw)
    assert os.path.exists(os.path.join(d, f"song.{crash_in}.ckpt.npz"))
    got = sep.process_blocked(audio, ckpt_dir=d, **kw)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device == w.device
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_midtrack_checkpoint_rejects_stale_config(tmp_path):
    audio = _audio(600, 13)
    cfg_a, cfg_b = _offline_cfg(), _offline_cfg(beta=3.0)
    kw = dict(block_frames=4, ckpt_every_blocks=2, tag="t")
    d = str(tmp_path)
    with pytest.raises(_Crash):
        hpr_separate_blocked_checkpointed(audio, cfg_a, ckpt_dir=d, on_segment=_bomb(4), **kw)
    second = hpr_separate_blocked_checkpointed(audio, cfg_b, ckpt_dir=d, **kw)
    want = hpr_separate_blocked(audio, cfg_b, block_frames=4)
    for k in STEMS:
        np.testing.assert_array_equal(second[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("fault", ["no next_block", "next_block past the end",
                                   "torn stems file"])
def test_midtrack_checkpoint_corrupt_restarts_clean(tmp_path, fault):
    """A checkpoint whose meta matches but whose next_block is missing or
    out of range, or whose stems file lost its tail, restarts from zero
    with zero tails, never seeding block 0 with a mid-track carry."""
    audio = _audio(900, 14)
    cfg = _offline_cfg()
    d = str(tmp_path)
    kw = dict(block_frames=4, ckpt_every_blocks=2, tag="t")
    want = hpr_separate_blocked(audio, cfg, block_frames=4)
    with pytest.raises(_Crash):
        hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=d, on_segment=_bomb(2), **kw)
    ckpt = os.path.join(d, "t.ckpt.npz")
    state, meta = load_stream_state(ckpt, like=torch.zeros(3, HOP))
    assert meta["next_block"] >= 2 and state.abs().max() > 0  # a mid-track carry
    if fault == "no next_block":
        meta.pop("next_block")
    elif fault == "next_block past the end":
        meta["next_block"] = meta["nb"] + 1
    else:
        with open(os.path.join(d, "t.stems.f32"), "r+b") as fh:
            fh.truncate(1024)
    save_stream_state_durable(ckpt, state, meta)
    out = hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=d, **kw)
    for k in STEMS:
        np.testing.assert_array_equal(out[k].numpy(), want[k].numpy(), err_msg=k)


def test_restart_drops_the_checkpoint_it_no_longer_matches(tmp_path, monkeypatch):
    """A restart (here: the stems file lost its tail) that is killed before
    its first segment leaves no checkpoint claiming the recreated, empty
    stems file: the next run restarts again and is right."""
    from zen_tpu_torch.drivers import offline as toff

    audio = _audio(900, 16)
    cfg = _offline_cfg()
    d = str(tmp_path)
    kw = dict(block_frames=4, ckpt_every_blocks=2, tag="t")
    want = hpr_separate_blocked(audio, cfg, block_frames=4)
    with pytest.raises(_Crash):
        hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=d, on_segment=_bomb(4), **kw)
    with open(os.path.join(d, "t.stems.f32"), "r+b") as fh:
        fh.truncate(1024)

    def killed(*args):
        raise _Crash

    with monkeypatch.context() as m:
        m.setattr(toff, "_block_step", killed)
        with pytest.raises(_Crash):
            hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=d, **kw)
    assert not os.path.exists(os.path.join(d, "t.ckpt.npz"))
    out = hpr_separate_blocked_checkpointed(audio, cfg, ckpt_dir=d, **kw)
    for k in STEMS:
        np.testing.assert_array_equal(out[k].numpy(), want[k].numpy(), err_msg=k)


def test_without_ckpt_dir_is_the_plain_blocked_pass():
    audio = _audio(500, 15)
    cfg = _offline_cfg()
    got = hpr_separate_blocked_checkpointed(audio, cfg, block_frames=8)
    want = hpr_separate_blocked(audio, cfg, block_frames=8)
    for k in STEMS:
        assert torch.equal(got[k], want[k])
    with pytest.raises(T.ZenError, match="expects \\[L\\]"):
        hpr_separate_blocked_checkpointed(np.zeros((2, 64), np.float32), cfg, ckpt_dir="x")
