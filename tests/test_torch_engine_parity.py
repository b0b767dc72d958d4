"""Engine parity of the port: its streaming and offline paths against
the hop-by-hop numpy oracle, both copies of it (the port's
``zen_tpu_torch.engine.oracle`` and zen_tpu's), on the CPU.

The counterpart of tests/test_engine_parity.py, case for case (its line
numbers name each case), with the port's drivers in place of zen_tpu's.
Tolerances are that suite's: the oracle class 5e-4 (rtol, atol 5e-4 x
max(max|ref|, 1e-3), :46-49) unless the case there sets a tighter one
(the real config 5e-5, the long stream 1e-4, the config fuzz 2e-4, each
x max(1, max|ref|)). The port's medians run their plain twins here; the
two oracles agree bitwise (tests/test_torch_oracle.py), so each case
holds the port to both on the same numbers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu as J  # noqa: E402
from zen_tpu.engine import oracle as jor  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.engine import oracle as tor  # noqa: E402

FS, HOP, L = 1000.0, 8, 101
STEMS = ("harmonic", "percussive", "residual")
BORDERS = ("wrap", "valid", "replicate")


def _audio(length=L, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    sig = (0.7 * np.sin(2 * np.pi * 50 * t) + 0.4 * (rng.random(length) > 0.97)
           + 0.05 * rng.standard_normal(length))
    return sig.astype(np.float32)


def _cfgs(**kw):
    """(zen_tpu's config, the port's) with the same fields."""
    kw.setdefault("fs", FS)
    kw.setdefault("hop", HOP)
    kw.setdefault("outputs", J.OUTPUT_ALL)
    kw.setdefault("fast_rfft", False)  # bit-comparable against the C2C oracle
    jc = J.HPRConfig(**kw)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _oracles(kind, audio, jc, tc) -> list:
    """Both oracles' stems for ``kind`` 'offline' or 'stream'."""
    fn = "oracle_offline_pass" if kind == "offline" else "oracle_realtime_stream"
    return [getattr(jor, fn)(audio, jc), getattr(tor, fn)(audio, tc)]


def _oracle_class(got, want, what, rtol=5e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def _scaled(got, want, what, atol):
    want = np.nan_to_num(np.asarray(want), posinf=0, neginf=0)
    got = np.nan_to_num(np.asarray(got)[..., : want.shape[-1]], posinf=0, neginf=0)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=what)


def _hold(got: dict, wants: list, check=_oracle_class, **kw):
    for want, name in zip(wants, ("zen_tpu oracle", "port oracle")):
        for k in STEMS:
            check(got[k], want[k], f"{k} vs the {name}", **kw)


def _stream(tc, audio, block_hops) -> dict:
    """The port's HPRRealtime over ``audio`` with config ``tc``."""
    rt = T.HPRRealtime(tc.fs, tc.hop, tc.beta, device="cpu")
    rt.cfg = tc
    rt.reset_buffers()
    out = rt.process_stream(audio, block_hops=block_hops)
    return dict(zip(STEMS, out))


def _offline(tc, audio) -> dict:
    return {k: v.numpy() for k, v in T.hpr_separate(audio, tc).items()}


# :54 and :71, hard and soft masks at the three borders, offline and streaming
@pytest.mark.parametrize("kind", ["offline", "stream"])
@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("variant", ["hard", "soft"])
def test_paths_match_both_oracles(variant, border, kind):
    jc, tc = _cfgs(causal=kind == "stream", border=border, beta=2.0,
                   soft_mask=variant == "soft")
    audio = _audio()
    got = _offline(tc, audio) if kind == "offline" else _stream(tc, audio, 5)
    _hold(got, _oracles(kind, audio, jc, tc))


def test_stream_block_size_invariance():
    """:95: B hops in one step == B per-hop steps, and each blocking
    against both oracles."""
    audio = _audio(160)
    jc, tc = _cfgs(causal=True)
    wants = _oracles("stream", audio, jc, tc)
    outs = [np.stack(list(_stream(tc, audio, b).values())) for b in (1, 4, 20)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-6, atol=1e-5)
    for out in outs:
        _hold(dict(zip(STEMS, out)), wants)


def test_two_pass_matches_oracle_cascade():
    """:163: HPRIOffline's cascade == the oracle cascade."""
    audio = _audio(130, seed=9)
    sep = T.HPRIOffline(FS, 16, 8, 2.0, 2.0, fast_rfft=False, device="cpu")
    h, p, r = (x.numpy() for x in sep.process(audio))
    jh, th = _cfgs(hop=16, causal=False)
    jp, tp = _cfgs(hop=8, causal=False, outputs=J.OUTPUT_PERCUSSIVE | J.OUTPUT_RESIDUAL)
    for mod, ch, cp in ((jor, jh, jp), (tor, th, tp)):
        pass1 = mod.oracle_offline_pass(audio, ch)
        pass2 = mod.oracle_offline_pass(pass1["percussive"] + pass1["residual"], cp)
        _oracle_class(h, pass1["harmonic"], "harmonic")
        _oracle_class(p, pass2["percussive"], "percussive")
        _oracle_class(r, pass2["residual"], "residual")


def test_realtime_parity_real_config():
    """:253: the headline config (44.1 kHz, hop 1024), 24 hops, at 5e-5."""
    rng = np.random.default_rng(20)
    audio = rng.standard_normal(1024 * 24).astype(np.float32)
    jc, tc = _cfgs(fs=44100.0, hop=1024, causal=True, beta=2.0)
    _hold(_stream(tc, audio, 8), _oracles("stream", audio, jc, tc), _scaled, atol=5e-5)


def test_long_stream_soak_matches_oracle():
    """:277: 500 hops, ragged 37-hop blocks, at 1e-4: state-carry drift
    (OLA tails, feature history, the in-place state) shows here."""
    rng = np.random.default_rng(30)
    audio = rng.standard_normal(8 * 500).astype(np.float32)
    jc, tc = _cfgs(causal=True, beta=2.0)
    _hold(_stream(tc, audio, 37), _oracles("stream", audio, jc, tc), _scaled, atol=1e-4)


def test_split_stream_state_continuity():
    """:377: two process_stream calls with a ragged boundary == one call,
    and the joined stream against both oracles."""
    rng = np.random.default_rng(50)
    audio = rng.standard_normal(8 * 13).astype(np.float32)
    jc, tc = _cfgs(causal=True, beta=2.0)
    whole = np.stack(list(_stream(tc, audio, 4).values()))
    rt = T.HPRRealtime(FS, HOP, 2.0, device="cpu", fast_rfft=False)
    a = rt.process_stream(audio[: 8 * 6], block_hops=4)
    b = rt.process_stream(audio[8 * 6 :], block_hops=4)
    joined = np.concatenate([a, b], axis=1)
    np.testing.assert_allclose(joined, whole, atol=1e-5)
    _hold(dict(zip(STEMS, joined)), _oracles("stream", audio, jc, tc))


def test_copy_reads_return_one_hop():
    """:396: copy_* return the newest hop after a block call, which is
    the oracle's last hop."""
    rng = np.random.default_rng(51)
    block = rng.standard_normal((4, 8)).astype(np.float32)
    rt = T.HPRRealtime(FS, HOP, 2.0, device="cpu", fast_rfft=False)
    outs = rt.process_block(block).numpy()
    jc, tc = _cfgs(causal=True, beta=2.0)
    for i, read in enumerate((rt.copy_harmonic, rt.copy_percussive, rt.copy_residual)):
        assert read().shape == (8,)
        np.testing.assert_array_equal(read(), outs[i, -8:])
    for want in _oracles("stream", block.ravel(), jc, tc):
        for i, k in enumerate(STEMS):
            _oracle_class(outs[i, -8:], want[k][-8:], k)


@pytest.mark.parametrize(
    "fs,hop,border,causal,soft,sse",
    [
        (1000.0, 8, "wrap", False, False, False),
        (1000.0, 8, "wrap", True, True, False),
        (1000.0, 16, "replicate", False, False, False),
        (1000.0, 16, "replicate", True, False, False),
        (2000.0, 8, "valid", False, False, False),
        (2000.0, 8, "valid", True, False, False),
        (1000.0, 8, "wrap", False, False, True),
        (1000.0, 16, "wrap", True, False, True),
        (4000.0, 32, "wrap", False, True, False),
        (8000.0, 64, "replicate", False, True, False),
        (16000.0, 32, "valid", False, False, False),
    ],
)
def test_config_fuzz_matches_oracle(fs, hop, border, causal, soft, sse):
    """:427: the sampled grid over every config axis, at 2e-4."""
    jc, tc = _cfgs(fs=fs, hop=hop, causal=causal, border=border, soft_mask=soft,
                   use_sse=sse)
    audio = np.random.default_rng(int(fs) + hop + len(border)).standard_normal(
        hop * 20).astype(np.float32)
    kind = "stream" if causal else "offline"
    got = _stream(tc, audio, 7) if causal else _offline(tc, audio)
    _hold(got, _oracles(kind, audio, jc, tc), _scaled, atol=2e-4)
