"""The benchmark's frozen bytes bound against chip_smoke.py's, on the cells'
geometries."""
from __future__ import annotations

import pytest
import torch

from benchmark import roofline
from benchmark.reference import hpr

FLEET = hpr.Stage(44100.0, 256, 2.0, True, ("percussive",))
PASSES = (hpr.Stage(44100.0, 4096, 2.5, False, hpr.STEMS),
          hpr.Stage(44100.0, 256, 2.5, False, ("percussive", "residual")))
TRACK = 240 * 44100


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fleet_bounds(dtype):
    chip_smoke = pytest.importorskip("chip_smoke")
    c, b, f, h = 81920, 16, 513, FLEET.history
    assert sorted(FLEET.time_taps) == sorted(chip_smoke.T256)
    item = torch.empty((), dtype=dtype).element_size()
    want = chip_smoke.time_bound(_meta(c, h, f, dtype=dtype), _meta(c, b, f, dtype=dtype),
                                 chip_smoke.T256, h)
    assert roofline.time_bound((c, h, f), (c, b, f), FLEET.time_taps, h, item) == want
    want = chip_smoke.freq_bound(_meta(c * b, f, dtype=dtype), 13, "reflect")
    assert roofline.freq_bound((c * b, f), FLEET.freq_taps, "reflect", item) == want


def test_track_bounds():
    chip_smoke = pytest.importorskip("chip_smoke")
    frames = (chip_smoke.TRACK_FRAMES_H, chip_smoke.TRACK_FRAMES_P)
    total = 0.0
    for st, t in zip(PASSES, frames):
        assert -(-TRACK // st.hop) + st.lag == t
        x = _meta(t, 2 * st.hop + 1)
        taps = tuple(range(-(len(st.time_taps) // 2), len(st.time_taps) // 2 + 1))
        assert st.time_taps == taps
        want = chip_smoke.time_bound(x, x[:0], taps, 0)
        assert roofline.time_bound(tuple(x.shape), (0, x.shape[1]), st.time_taps, 0, 4) == want
        want_f = chip_smoke.freq_bound(x, st.freq_taps, "reflect")
        assert roofline.freq_bound(tuple(x.shape), st.freq_taps, "reflect", 4) == want_f
        total += want[0] + want_f[0]
    assert total == pytest.approx(202.5, abs=0.5)


def test_valid_and_operations_bound():
    assert roofline.freq_bound((4, 100), 11, "valid", 4)[0] == pytest.approx(
        (400 + 4 * 90) * 4 / roofline.HBM_BYTES_PER_S * 1e6)
    assert roofline.bound(1, 1000, 1, 2**21 + 1)[1] == "operations"
