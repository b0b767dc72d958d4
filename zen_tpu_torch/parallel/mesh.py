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

Several processes (zen_tpu's multi-host run) join one ``torch.distributed``
group through ``distributed_init``; ``make_mesh`` then lays out the global
mesh, each process contributing its own entries, and records the process
that owns each. zen_tpu's ``_split_dcn`` puts the process split on the
leading axes that take it: dp where it can, and otherwise sp or tp, whose
rings then cross processes (``{"dp": 1, "sp": 2}`` over two processes is
one ring, a shard in each). The sharded drivers issue the shards their
process owns and send what crosses a cut edge of a ring through
``parallel/multihost.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
import torch

from ..device import resolve_device
from ..errors import ZenError
from . import multihost

# how long a collective waits for a peer that is alive but never enters it
# (a dead peer's closed sockets fail the collective at once): longer than
# process 0 alone takes on an hours-long track while the others wait
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one axis
    per name of ``axis_names`` in that order. Entries may repeat a
    device: shards that share a card run one after another on it.
    ``processes`` (same shape; all 0 when left out) is the rank of the
    process that owns each entry, and ``process_index`` the rank of the
    process holding this Mesh; a process issues only the shards it owns."""

    devices: np.ndarray
    axis_names: tuple
    processes: np.ndarray | None = None
    process_index: int = 0

    def __post_init__(self):
        if self.processes is None:
            object.__setattr__(self, "processes", np.zeros(self.devices.shape, dtype=np.int64))

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have (a
        driver that shards over ``sp`` alone runs on a dp x sp mesh, and
        one that shards over dp and sp on an sp-only mesh)."""
        return self.shape.get(axis, 1)

    def _index(self, coords: dict) -> tuple:
        return tuple(coords.get(name, 0) for name in self.axis_names)

    def device(self, **coords) -> torch.device:
        """The device at ``coords`` (axis name -> index); an axis left
        out is taken at index 0, so the shards of one axis are
        ``device(sp=j)`` and their replicas over the other axes are not
        used; an axis the mesh does not have (``size`` 1) is ignored."""
        return self.devices[self._index(coords)]

    def owner(self, **coords) -> int:
        """The rank of the process that owns the shard at ``coords``
        (``device``'s reading of them)."""
        return int(self.processes[self._index(coords)])

    def own(self, axis: str) -> list:
        """[(index, device)] for each index along ``axis`` at which this
        process owns an entry, with the device of its first such entry:
        the dp rows a process issues (all of them, at the other axes'
        index 0, in one process)."""
        if axis not in self.axis_names:
            return [(0, self.first)]
        ax = self.axis_names.index(axis)
        devs = np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)
        procs = np.moveaxis(self.processes, ax, 0).reshape(devs.shape)
        return [(i, devs[i][np.flatnonzero(procs[i] == self.process_index)[0]])
                for i in range(devs.shape[0]) if (procs[i] == self.process_index).any()]

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != self.processes.flat[0]).any())

    def local_coords(self) -> dict:
        """The coordinates of this process's first entry: where the
        shards it issues along one axis sit on the others."""
        flat = int(np.flatnonzero(self.processes.ravel() == self.process_index)[0])
        return dict(zip(self.axis_names, map(int, np.unravel_index(flat, self.devices.shape))))

    @property
    def first(self) -> torch.device:
        """This process's first device, where the sharded drivers gather
        their results (the mesh's first device in one process)."""
        return self.device(**self.local_coords())


def _split_dcn(sizes: tuple, n_proc: int) -> tuple:
    """Factor the process count into the LEADING mesh axes: returns
    (dcn_shape, per_host_shape) with elementwise product == sizes and
    prod(dcn_shape) == n_proc. Greedy left-to-right, so dp absorbs the
    cross-host split first and the trailing (halo-exchanging) axes
    stay intact within a host. Raises when the factorization doesn't
    exist. (zen_tpu/parallel/mesh.py's, with its refusal.)"""
    dcn = []
    r = n_proc
    for s in sizes:
        f = math.gcd(r, s)
        dcn.append(f)
        r //= f
    if r != 1:
        raise ZenError(
            f"process count {n_proc} does not factor into mesh axes {sizes}"
        )
    per_host = tuple(s // f for s, f in zip(sizes, dcn))
    return tuple(dcn), per_host


def distributed_init(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, timeout=GROUP_TIMEOUT) -> None:
    """Join the ``torch.distributed`` group of ``num_processes`` processes
    (the gloo backend, rendezvous at ``tcp://coordinator_address``, which
    process 0 serves) as rank ``process_id``. A no-op when the group is
    already initialized or when no arguments are given; a failed
    rendezvous raises (RuntimeError or ValueError), and a collective that
    waits past ``timeout`` raises instead of hanging."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        return
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=timeout)


def _local_devices(n: int, devices, device) -> list:
    """This process's n mesh entries: ``devices``, or the first n visible
    cards, or the CPU n times."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
        else:
            devices = [dev] * n
    return [resolve_device(d) for d in devices]


def _object_grid(items: list, shape: tuple) -> np.ndarray:
    grid = np.empty(len(items), dtype=object)
    grid[:] = items
    return grid.reshape(shape)


def make_mesh(axes: dict, devices=None, device="cuda") -> Mesh:
    """A Mesh from {'axis': size}, in the dict's order.

    ``devices`` (a list, length the product of the sizes) places the
    shards explicitly and may repeat a device. Without it: on ``device``
    "cuda" the first n visible cards (``torch.cuda.device_count()``); on
    "cpu" n entries of the CPU, which stands in for any number of shards
    as XLA's forced multi-device host platform does for zen_tpu. Too few
    devices raise a ZenError; there is no fallback to fewer shards or to
    the CPU.

    Under a process group of N processes (``distributed_init``) the mesh
    is global: every process calls make_mesh alike, and ``devices`` (or
    the default) is this process's n / N entries. ``_split_dcn`` lays the
    processes' blocks out over the leading axes, process p's at
    ``unravel_index(p, dcn)`` as zen_tpu's ``create_hybrid_device_mesh``
    puts them; where dp cannot take the whole split, sp or tp rings cross
    processes. A process count that does not factor into the axes raises
    ``_split_dcn``'s ZenError, and too few entries in a process raise.
    """
    names = tuple(axes.keys())
    sizes = tuple(int(s) for s in axes.values())
    n = math.prod(sizes)
    n_proc, rank = multihost.process_count(), multihost.process_index()
    if n_proc == 1:
        devices = _local_devices(n, devices, device)
        if len(devices) != n:
            raise ZenError(f"mesh axes {axes} need {n} devices, got {len(devices)}")
        return Mesh(_object_grid(devices, sizes), names)
    dcn, per_host = _split_dcn(sizes, n_proc)
    n_local = n // n_proc
    devices = _local_devices(n_local, devices, device)
    if len(devices) != n_local:
        raise ZenError(f"mesh axes {axes} need {n_local} devices in each of {n_proc} "
                       f"processes, got {len(devices)}")
    names_by_proc = multihost.allgather_objects([str(d) for d in devices])
    grid = np.empty(sizes, dtype=object)
    owners = np.empty(sizes, dtype=np.int64)
    for p, dev_names in enumerate(names_by_proc):
        at = np.unravel_index(p, dcn)
        block = tuple(slice(c * s, (c + 1) * s) for c, s in zip(at, per_host))
        # this process's own entries keep their objects; the others' are names
        entries = devices if p == rank else [torch.device(d) for d in dev_names]
        grid[block] = _object_grid(entries, per_host)
        owners[block] = p
    return Mesh(grid, names, owners, rank)


def visible_devices(device="cuda") -> int:
    """How many devices a mesh of ``device``'s type can span without
    repeating one: the visible cards, or 1 for the CPU, summed over the
    processes of the group."""
    dev = resolve_device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return sum(multihost.allgather_objects(local))


def default_mesh(n_channels_hint: int = 0, device="cuda") -> Mesh:
    """zen_tpu's default over every visible device (summed over the
    processes of a group): the channels over dp when the workload has at
    least as many channels, else dp the largest divisor of the device
    count no greater than the hint (1 without one) and the rest on sp."""
    n = visible_devices(device)
    if n_channels_hint >= n:
        return make_mesh({"dp": n, "sp": 1}, device=device)
    dp = 1
    if n_channels_hint:
        dp = max(d for d in range(1, n + 1) if n % d == 0 and d <= n_channels_hint)
    return make_mesh({"dp": dp, "sp": n // dp}, device=device)
