"""K2's select route (csrc/radix_select.cuh) emulated on the CPU
(``rank_emulation.emulate_freq_select``) at the reflect border, bitwise
to the plain twin: one border a file, so that the route's cases spread
over the test workers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    WRAP_LIMIT,
    _levels,
    _tensor,
    check_freq_select_twin,
    emulate_freq_select,
)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect"])
@pytest.mark.parametrize("k,tile", [(13, None), (47, 5), (187, 64), (401, 256)])
def test_freq_select_emulation_matches_twin(k, tile, mode, ties):
    """K2's select route at the reflect border: ragged last tiles (517
    outputs a row), the wrapper's tile and forced ones (the other borders:
    test_torch_select_freq_*.py)."""
    check_freq_select_twin(k, tile, mode, ties)


@pytest.mark.parametrize("mode", ["wrap", "edge", "reflect"])
@pytest.mark.parametrize("k,f", [(33, 5), (65, 7), (127, 64), (1001, 64), (WRAP_LIMIT, 64)])
def test_freq_select_emulation_stages_the_row_past_f(k, f, mode):
    """K past F (wrap and edge; reflect up to 2F - 1, its reach): a block
    stages the row's F samples, each counted as often as the border
    repeats it in the window (_row_count), up to K2's limit, where a
    window would otherwise stage 2,096,129 positions of 64 samples."""
    if mode == "reflect":
        k = min(k, 2 * f - 1)
    rng = np.random.default_rng(k + f)
    x = _tensor(_levels(rng, (2, f), ties=True), torch.float32)
    tile = mc.freq_select_plan(k, 2, f, mode)[0]
    assert tile + k - 1 > f  # the whole row, weighted
    got = emulate_freq_select(x, k, mode)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))
