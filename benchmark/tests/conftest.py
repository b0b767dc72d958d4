"""Small cells for the CPU tests: each cell of BENCHMARK.json with its
traffic cut to a size a test run holds, run on the CPU through the same
harness, loops, reference and checks as on the card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "fleet-81920x16": dict(streams=6, check_streams=4, check_steps=3, check_from=12,
                          bank_seconds=0.5),
    "offline-track240": dict(track_seconds=2.5, tracks=2, check_tracks=2, check_from=3),
}


def small_cell(name: str) -> tuple:
    from benchmark import harness

    entry, config, traffic = harness.cell(name)
    return entry, config, {**traffic, **SMALL[name]}


def run_small(name: str, seed: int = 5_000_000_001, seconds: float = 0.3, control=False,
              traced=False) -> dict:
    from benchmark import harness

    return harness.execute(name, seed, seconds, traced, device="cpu",
                           cell_override=small_cell(name), control=control)


@pytest.fixture
def small():
    return run_small
