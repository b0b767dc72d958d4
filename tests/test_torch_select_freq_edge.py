"""K2's select route (csrc/radix_select.cuh) emulated on the CPU
(``rank_emulation.emulate_freq_select``) at the edge border, bitwise to
the plain twin: one border a file, so that the route's cases spread over
the test workers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    _levels,
    _tensor,
    check_freq_select_twin,
    emulate_freq_select,
)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["edge"])
@pytest.mark.parametrize("k,tile", [(13, None), (47, 5), (187, 64), (401, 256)])
def test_freq_select_emulation_matches_twin(k, tile, mode, ties):
    """K2's select route at the edge border: ragged last tiles (517
    outputs a row), the wrapper's tile and forced ones (the other borders:
    test_torch_select_freq_*.py)."""
    check_freq_select_twin(k, tile, mode, ties)


@pytest.mark.parametrize("k,mode", [(13, "valid"), (187, "reflect"), (129, "wrap")])
def test_freq_select_emulation_bf16(k, mode):
    rng = np.random.default_rng(6)
    f_in = 100 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties=False), torch.bfloat16)
    got = emulate_freq_select(x, k, mode)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))
