"""K2's key store past one block's shared memory, emulated on the CPU
(``rank_emulation.sort_store``: the store's own sort, pass by pass, at
the real chunk and at tiny ones), held bitwise against the plain twin and
zen_tpu's median, at tiny K and at the K past 16,353 the store takes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    one_torch_thread,  # noqa: F401 (autouse)
    PAD_KEY,
    _levels,
    _tensor,
    emulate_freq_rank,
    sort_store,
)


@pytest.mark.parametrize("chunk", [32, 64, 1024])
@pytest.mark.parametrize("n", [32, 256, 4096])
def test_sort_store_orders_every_slice(n, chunk):
    """The store's passes sort any keys, pad keys (equal) included, for a
    slice within one chunk and for one of many chunks."""
    gen = torch.Generator().manual_seed(n + chunk)
    keys = torch.randint(0, 1 << 40, (3, n), generator=gen)
    keys[:, -n // 8 :] = PAD_KEY
    keys[1] = keys[1] % 7  # ties, as equal keys never arise in a kernel
    assert torch.equal(sort_store(keys, chunk), torch.sort(keys, dim=-1).values)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k,chunk", [(13, 32), (187, 64), (401, 256)])
def test_freq_store_emulation_matches_twin(k, chunk, mode, ties):
    """K2 on the key store at a tiny chunk: units of 1024 outputs (1100 a
    row: the second ragged), keys of 2048 slots sorted 32 to 256 at a
    time, so that six to seven stages pass over the slice."""
    rng = np.random.default_rng(k + chunk)
    f_in = 1100 + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(rng, (2, f_in), ties), torch.float32)
    got = emulate_freq_rank(x, k, mode, chunk)
    assert got.shape == (2, 1100)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


@pytest.mark.parametrize("k,mode", [(187, "reflect"), (65, "wrap")])
def test_freq_store_emulation_matches_jax(k, mode):
    rng = np.random.default_rng(31)
    x = _levels(rng, (2, 1100), ties=True)
    m = (k - 1) // 2
    want = np.asarray(jax_sliding_median(jnp.asarray(x), range(-m, m + 1), -1, mode))
    got = emulate_freq_rank(_tensor(x, torch.float32), k, mode, chunk=32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,f_out", [(16_385, 40), (16_387, 9)])
def test_freq_store_emulation_at_its_k(k, f_out, dtype):
    """Past 16,353 taps the wrapper sends K2 to the store on its own
    (freq_rank_store): a few outputs of a pre-padded row at the real chunk,
    32,768 keys over two chunks of 16,384."""
    assert mc.freq_route(k) == "rank" and mc.freq_rank_store(k) == "scratch"
    rng = np.random.default_rng(k)
    x = _tensor(_levels(rng, (1, f_out + k - 1), True), dtype)
    got = emulate_freq_rank(x, k, "valid")
    assert got.dtype == dtype and got.shape == (1, f_out)
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, "valid"))
