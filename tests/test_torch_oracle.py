"""The port's copy of the hop-by-hop numpy oracle
(zen_tpu_torch/engine/oracle.py) against zen_tpu's
(zen_tpu/engine/oracle.py), on the CPU.

Both are the same numpy code run on the same inputs with configs whose
derived fields are equal, so they must give the same arrays: every
comparison here is ``assert_array_equal``, not a tolerance. Hard, soft
and SSE masks at the three borders, causal and not; the filter alone at
every direction, border and reduction.
"""
import dataclasses

import numpy as np
import pytest

import zen_tpu as J
from zen_tpu.engine import oracle as jor
import zen_tpu_torch as T
from zen_tpu_torch.engine import oracle as tor

FS, HOP, L = 1000.0, 8, 101
BORDERS = ("wrap", "valid", "replicate")
VARIANTS = ("hard", "soft", "sse")


def _audio(length=L, seed=0):
    """zen_tpu's parity fixture: a 50 Hz tone, clicks, a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    sig = (0.7 * np.sin(2 * np.pi * 50 * t) + 0.4 * (rng.random(length) > 0.97)
           + 0.05 * rng.standard_normal(length))
    return sig.astype(np.float32)


def _cfgs(**kw):
    jc = J.HPRConfig(fs=FS, hop=HOP, outputs=J.OUTPUT_ALL, fast_rfft=False, **kw)
    return jc, T.config_from_fields(**dataclasses.asdict(jc))


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_oracle_passes_bitwise(variant, border, causal):
    jc, tc = _cfgs(border=border, causal=causal, beta=2.0,
                   soft_mask=variant == "soft", use_sse=variant == "sse")
    audio = _audio(seed=len(border) + causal)
    _equal(tor.oracle_offline_pass(audio, tc), jor.oracle_offline_pass(audio, jc))
    if causal:
        _equal(tor.oracle_realtime_stream(audio, tc), jor.oracle_realtime_stream(audio, jc))


def test_oracle_two_pass_cascade_bitwise():
    """The oracle cascade the fuzz sweep's twopass mode builds: pass 1's
    percussive + residual into pass 2."""
    audio = _audio(130, seed=9)
    out = {}
    for mod, cfg_mod in ((jor, J), (tor, T)):
        cfg_h = cfg_mod.HPRConfig(fs=FS, hop=16, causal=False, fast_rfft=False)
        cfg_p = cfg_mod.HPRConfig(fs=FS, hop=8, causal=False, fast_rfft=False,
                                  outputs=cfg_mod.OUTPUT_PERCUSSIVE | cfg_mod.OUTPUT_RESIDUAL)
        p1 = mod.oracle_offline_pass(audio, cfg_h)
        out[mod] = {"harmonic": p1["harmonic"],
                    **mod.oracle_offline_pass(p1["percussive"] + p1["residual"], cfg_p)}
    _equal(out[tor], out[jor])


# the box mean ('mean') always pads its borders in the reference, so the
# oracle takes it under 'wrap' and 'replicate' only
@pytest.mark.parametrize("border,op", [(b, "median") for b in BORDERS]
                         + [("wrap", "mean"), ("replicate", "mean")])
@pytest.mark.parametrize("direction", [tor.TIME_CAUSAL, tor.TIME_ANTICAUSAL, tor.FREQUENCY])
def test_np_filter2d_bitwise(direction, border, op):
    x = np.abs(np.random.default_rng(3).standard_normal((14, 33))).astype(np.float32)
    for k in (3, 4, 7):
        np.testing.assert_array_equal(tor.np_filter2d(x, k, direction, border, op),
                                      jor.np_filter2d(x, k, direction, border, op))


def test_oracle_state_machine_bitwise_per_hop():
    """HPROracle hop by hop, its masks and OLA buffers included, at a
    real hop (44.1 kHz, hop 1024), and after reset()."""
    jc, tc = _cfgs(causal=True)
    jc = dataclasses.replace(jc, fs=44100.0, hop=1024)
    tc = dataclasses.replace(tc, fs=44100.0, hop=1024)
    rng = np.random.default_rng(4)
    j, t = jor.HPROracle(jc), tor.HPROracle(tc)
    for n in range(8):
        if n == 5:
            j.reset()
            t.reset()
        hop = rng.standard_normal(1024).astype(np.float32)
        _equal(t.process_next_hop(hop), j.process_next_hop(hop))
        _equal(t.masks, j.masks)
        _equal(t.outs, j.outs)
