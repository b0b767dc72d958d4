"""A run at a small size on the CPU, the harness's look for a card skipped:
sound, it is correct; with the timed path broken underneath, or with the
configuration's control in the program's place, ``correct`` comes out
false. The numbers that the limits hold are read from the check."""
from __future__ import annotations

import pytest
import torch

FLEET, TRACK = "fleet-81920x16", "offline-track240"


def _over(result: dict) -> list:
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", [FLEET, TRACK])
def test_sound_run_is_correct(small, cell):
    result = small(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", [FLEET, TRACK])
def test_control_is_not_correct(small, cell):
    result = small(cell, control=True)
    assert result["correct"] is False and "gap_median" in _over(result), result["checks"]


def test_state_left_unchanged(small, monkeypatch):
    from zen_tpu_torch.drivers import realtime

    monkeypatch.setattr(realtime, "advance_state", lambda cfg, state, step: None)
    assert small(FLEET)["correct"] is False


def _patch_output(monkeypatch, cls, fault):
    original = cls.__dict__["process_block" if cls.__name__ == "MultiStreamHPR" else "process"]

    def broken(self, *args, **kwargs):
        return fault(original(self, *args, **kwargs))

    monkeypatch.setattr(cls, original.__name__, broken)


def _half(out: torch.Tensor) -> torch.Tensor:
    """Half the streams left out: their rows are the mean of the rest."""
    out = out.clone()
    half = out.shape[0] // 2
    out[half:] = out[:half].mean(dim=0, keepdim=True)
    return out


def _altered(out: torch.Tensor) -> torch.Tensor:
    """One hop (256 samples) of every output row altered by its peak."""
    out = out.clone()
    out[..., :256] += out.abs().amax()
    return out


@pytest.mark.parametrize("fault", [_half, _altered], ids=["half_batch", "answer_altered"])
def test_fleet_faults(small, monkeypatch, fault):
    from zen_tpu_torch.drivers.realtime import MultiStreamHPR

    _patch_output(monkeypatch, MultiStreamHPR, fault)
    assert small(FLEET)["correct"] is False


def _track_half(stems):
    """Half the track left out: its second half is the first half's mean."""
    out = []
    for s in stems:
        s = s.clone()
        s[s.shape[-1] // 2 :] = s[: s.shape[-1] // 2].mean()
        out.append(s)
    return tuple(out)


def _track_altered(stems):
    return tuple(_altered(s) for s in stems)


@pytest.mark.parametrize("fault", [_track_half, _track_altered],
                         ids=["half_track", "answer_altered"])
def test_track_faults(small, monkeypatch, fault):
    from zen_tpu_torch.drivers.offline import HPRIOffline

    _patch_output(monkeypatch, HPRIOffline, fault)
    assert small(TRACK)["correct"] is False


def test_traced_run_reads_the_same(small):
    result = small(FLEET, traced=True)
    assert result["correct"] is True
    assert "breakdown" in result and result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"


def test_run_refuses_without_a_card():
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", FLEET, "--seed", "1",
                          "--seconds", "1"], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of each cell's own size on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark import harness

    for cell in (FLEET, TRACK):
        assert harness.execute(cell, 3_200_000_001, 1.0, False)["correct"] is True
