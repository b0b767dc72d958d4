"""K2's select route (csrc/radix_select.cuh) emulated on the CPU
(``rank_emulation.emulate_freq_select``) at the valid border, bitwise to
the plain twin: one border a file, so that the route's cases spread over
the test workers.
"""
import pytest

torch = pytest.importorskip("torch")

from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    check_freq_select_twin,
)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["valid"])
@pytest.mark.parametrize("k,tile", [(13, None), (47, 5), (187, 64), (401, 256)])
def test_freq_select_emulation_matches_twin(k, tile, mode, ties):
    """K2's select route at the valid border: ragged last tiles (517
    outputs a row), the wrapper's tile and forced ones (the other borders:
    test_torch_select_freq_*.py)."""
    check_freq_select_twin(k, tile, mode, ties)
