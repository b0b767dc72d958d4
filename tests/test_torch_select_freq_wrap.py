"""K2's select route (csrc/radix_select.cuh) emulated on the CPU
(``rank_emulation.emulate_freq_select``) at the wrap border, bitwise to
the plain twin and zen_tpu's median: one border a file, so that the
route's cases spread over the test workers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    _levels,
    _tensor,
    check_freq_select_twin,
    emulate_freq_select,
)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["wrap"])
@pytest.mark.parametrize("k,tile", [(13, None), (47, 5), (187, 64), (401, 256)])
def test_freq_select_emulation_matches_twin(k, tile, mode, ties):
    """K2's select route at the wrap border: ragged last tiles (517
    outputs a row), the wrapper's tile and forced ones (the other borders:
    test_torch_select_freq_*.py)."""
    check_freq_select_twin(k, tile, mode, ties)


@pytest.mark.parametrize("k,mode", [(65, "wrap"), (187, "reflect"), (241, "edge"), (187, "wrap")])
def test_freq_select_emulation_matches_jax(k, mode):
    """Against zen_tpu's median, K past the row (120) under wrap and edge."""
    rng = np.random.default_rng(3 * k)
    x = _levels(rng, (2, 120), ties=True)
    m = (k - 1) // 2
    boundary = {"edge": "clamp"}.get(mode, mode)
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, boundary))
    got = emulate_freq_select(_tensor(x, torch.float32), k, mode).numpy()
    np.testing.assert_array_equal(got, want)
