"""K2's shared core from 33 to 63 taps on the CPU (the hop-1024 step's K =
47 among them): its plain version and the kernel's thread mapping
emulated step for step, at each R it is built for, bitwise to the plain
twin and to zen_tpu's Pallas frequency median in interpret mode under
each border (``check_freq_core`` of test_torch_select_network.py, whose
own test takes K up to 31), in a file of their own so that the test
workers share the cases.
"""
import pytest

torch = pytest.importorskip("torch")

from rank_emulation import one_torch_thread  # noqa: E402,F401 (autouse: one torch thread)
from test_torch_select_network import FREQ_MODES, check_freq_core  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402


@pytest.mark.parametrize("mode", FREQ_MODES)
@pytest.mark.parametrize("k", list(range(33, mc.FREQ_NETWORK_MAX_TAPS + 1, 2)))
def test_freq_core_matches_the_twin_and_zen_tpu(k, mode):
    """K2's shared core at 33 to 63 taps, ``check_freq_core``."""
    check_freq_core(k, mode)
