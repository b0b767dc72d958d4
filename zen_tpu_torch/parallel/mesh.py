"""A mesh of torch devices (counterpart of ``zen_tpu/parallel/mesh.py``).

zen_tpu is single-controller: one process drives every local chip
through ``jax.shard_map`` over a ``jax.sharding.Mesh``. The port keeps
that model in PyTorch's own idiom: a ``Mesh`` names the device of every
shard, and the sharded drivers (``parallel/sharded.py``) issue each
shard's work from one Python loop, stage by stage, onto that shard's
device. On a host with several cards the shards' kernels then run
concurrently, since nothing in the loop waits on the host.

Axis conventions are zen_tpu's:
  dp - data parallel over independent channels, streams or tracks
  sp - sequence (time-block) parallel with STFT-frame halos
  tp - tensor parallel over frequency bins (bin halos and a sum)

Axis ORDER is load-bearing: the axes dict's insertion order is the
mesh's axis order and the last axis varies fastest over the devices, so
callers put dp first and sp / tp last, and the shards that exchange
halos sit on neighbouring cards.

The multi-host half (zen_tpu's ``_split_dcn`` and ``distributed_init``)
is ROADMAP queue 1 item 9b.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ZenError


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one axis
    per name of ``axis_names`` in that order. Entries may repeat a
    device: shards that share a card run one after another on it."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have (a
        driver that shards over ``sp`` alone runs on a dp x sp mesh, and
        one that shards over dp and sp on an sp-only mesh)."""
        return self.shape.get(axis, 1)

    def device(self, **coords) -> torch.device:
        """The device at ``coords`` (axis name -> index); an axis left
        out is taken at index 0, so the shards of one axis are
        ``device(sp=j)`` and their replicas over the other axes are not
        used; an axis the mesh does not have (``size`` 1) is ignored."""
        return self.devices[tuple(coords.get(name, 0) for name in self.axis_names)]

    @property
    def first(self) -> torch.device:
        """The device the sharded drivers gather their results on."""
        return self.devices.flat[0]


def make_mesh(axes: dict, devices=None, device="cuda") -> Mesh:
    """A Mesh from {'axis': size}, in the dict's order.

    ``devices`` (a list, length the product of the sizes) places the
    shards explicitly and may repeat a device. Without it: on ``device``
    "cuda" the first n visible cards (``torch.cuda.device_count()``); on
    "cpu" n entries of the CPU, which stands in for any number of shards
    as XLA's forced multi-device host platform does for zen_tpu. Too few
    devices raise a ZenError; there is no fallback to fewer shards or to
    the CPU.
    """
    names = tuple(axes.keys())
    sizes = tuple(int(s) for s in axes.values())
    n = math.prod(sizes)
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
        else:
            devices = [dev] * n
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n:
        raise ZenError(f"mesh axes {axes} need {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), names)


def visible_devices(device="cuda") -> int:
    """How many devices a mesh of ``device``'s type can span without
    repeating one: the visible cards, or 1 for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def default_mesh(n_channels_hint: int = 0, device="cuda") -> Mesh:
    """zen_tpu's default over every visible device: the channels over dp
    when the workload has at least as many channels, else everything on
    sp."""
    n = visible_devices(device)
    if n_channels_hint >= n:
        return make_mesh({"dp": n, "sp": 1}, device=device)
    dp = 1
    if n_channels_hint:
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d <= n_channels_hint)
    return make_mesh({"dp": dp, "sp": n // dp}, device=device)
