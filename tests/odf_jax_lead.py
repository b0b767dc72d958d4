"""A hook for ``python -m zen_tpu_torch.tools.odf_fp_probe --stress N --hook
tests/odf_jax_lead.py:hold_alias``: the lead (ROADMAP Queue 3 item 8) that
the JAX runtime holds the frames' memory while the port's ODF reads it.

JAX on the CPU takes a suitably aligned numpy array without a copy, and
``test_odf_batch_matches_zen_tpu`` hands ``frames`` to zen_tpu's
``odf_batch`` before the port's call on ``torch.from_numpy(frames)``. Here
each call runs zen_tpu's ODF on the fresh frames as the test does and
keeps JAX's view of them alive until the port's call has ended.
``hold_alias.stats`` counts the calls whose view was zero-copy (its
buffer the array's memory) and those that were copied.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:  # as tests/conftest.py
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zen_tpu.apps import btrack as jb  # noqa: E402


def hold_alias(frames: np.ndarray) -> tuple:
    """zen_tpu's ODF of ``frames``, and JAX's view of them, to be held."""
    view = jnp.asarray(frames)
    key = "zero_copy" if view.unsafe_buffer_pointer() == frames.ctypes.data else "copied"
    hold_alias.stats[key] += 1
    return view, np.asarray(jb.odf_batch(frames))


hold_alias.stats = {"zero_copy": 0, "copied": 0}
