"""The plain reference against the port on the CPU at small sizes, and
against the port's hop-by-hop transcription of the reference engine."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import signals
from benchmark.reference import hpr


def _audio(rows: int, n: int, fs: float = 44100.0, seed: int = 11) -> torch.Tensor:
    return signals.mix(rows, n, fs, signals.generator(seed, "cpu"), "cpu")


def _gap(got: torch.Tensor, want: torch.Tensor, mix: torch.Tensor) -> float:
    return float((got - want).norm() / mix.norm())


@pytest.mark.parametrize("stems", [("percussive",), hpr.STEMS])
def test_fleet_steps_match_the_port(stems):
    from zen_tpu_torch import MultiStreamHPR
    from zen_tpu_torch.engine import config as zcfg

    c, b, hop, steps = 3, 16, 256, 6
    chunks = _audio(c, steps * b * hop).view(c, steps * b, hop)
    flags = sum(getattr(zcfg, f"OUTPUT_{s.upper()}") for s in stems)
    sep = MultiStreamHPR(c, 44100.0, hop=hop, beta=2.0, outputs=flags, device="cpu")
    outs = [sep.process_block(chunks[:, n * b : (n + 1) * b]) for n in range(steps)]
    st = hpr.Stage(44100.0, hop, 2.0, True, stems)
    warm = 32
    assert warm >= st.history + 2
    # a step recomputed from the warm hops before it alone: the state is finite
    for n in (2, 4, 5):
        part = chunks[:, n * b - warm : (n + 1) * b]
        ref, mix = hpr.causal_stream(st, part, warm), hpr.mixture(st, part, warm)
        for row, name in enumerate(stems):
            assert _gap(outs[n][:, row], ref[name], mix) < 1e-5
    # from the streams' start, silence before it
    whole = torch.cat(outs, dim=-1)
    lead = torch.nn.functional.pad(chunks, (0, 0, warm, 0))
    ref, mix = hpr.causal_stream(st, lead, warm), hpr.mixture(st, lead, warm)
    for row, name in enumerate(stems):
        assert _gap(whole[:, row], ref[name], mix) < 1e-5


def test_track_matches_the_port():
    from zen_tpu_torch import HPRIOffline

    x = _audio(1, 110_000)[0]
    got = HPRIOffline(44100.0, 4096, 256, 2.5, 2.5, device="cpu").process(x)
    ref = hpr.hpri_offline(44100.0, 4096, 256, 2.5, 2.5, x)
    mix = sum(ref.values())
    for g, name in zip(got, hpr.STEMS):
        assert _gap(g, ref[name], mix) < 1e-5


def test_stages_match_the_hop_by_hop_transcription():
    from zen_tpu_torch.engine.config import OUTPUT_ALL, HPRConfig
    from zen_tpu_torch.engine.oracle import oracle_offline_pass, oracle_realtime_stream

    fs, hop = 8000.0, 64
    x = _audio(1, 40 * hop, fs)[0]
    for causal in (True, False):
        cfg = HPRConfig(fs=fs, hop=hop, beta=2.0, causal=causal, outputs=OUTPUT_ALL)
        st = hpr.Stage(fs, hop, 2.0, causal, hpr.STEMS)
        assert (st.l_harm, st.l_perc, st.lag) == (cfg.l_harm, cfg.l_perc, cfg.lag)
        assert sorted(st.time_taps) == sorted(cfg.time_offsets)
        if causal:
            want = oracle_realtime_stream(x.numpy(), cfg)
            lead = torch.nn.functional.pad(x.view(-1, hop), (0, 0, 1, 0))
            got = hpr.causal_stream(st, lead, 1)
        else:
            want = oracle_offline_pass(x.numpy(), cfg)
            got = hpr.offline_pass(st, x)
        scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
        for name in hpr.STEMS:
            assert float((got[name] - torch.from_numpy(want[name])).abs().max()) < 5e-5 * scale


def test_only_wrap():
    with pytest.raises(ValueError):
        hpr.Stage(44100.0, 256, 2.0, True, hpr.STEMS, "valid")
