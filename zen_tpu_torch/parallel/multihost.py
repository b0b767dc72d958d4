"""Exchanges across processes (counterpart of the collectives zen_tpu's
``shard_map`` programs and ``jax.experimental.multihost_utils`` calls
make across hosts).

A multi-process run is a ``torch.distributed`` process group, joined by
``parallel/mesh.py``'s ``distributed_init``. Every function here is
issued by every process of the group in the same order (the drivers
build the same shards and batches on each), and is a local no-op in a
single process. An exchange that fails (a peer gone, a timeout) raises
on every process that takes part in it; nothing catches it.

The exchanges travel as CPU tensors over the ``gloo`` backend. This is a
design decision, not a fallback: NCCL refuses the two or three ranks
that share one card in ``tools/multihost_smoke.py`` and chip_smoke's
phase 30, and every exchange here is small beside the work between two
of them. A tensor on the card is staged through pageable memory: the
messages are a few rows of a shard, where a pinned buffer's allocation
would cost more than the copy it speeds up.

What crosses processes, per dp x sp pass of ``parallel/sharded.py``
over a ring that spans them, and per tp pass:

* halos (``ring_shift``): at each cut edge of a ring (two shards of one
  ring, owned by two processes) the pass's three sp halos cross once
  each: ``hop`` samples, ``back`` + ``fwd`` feature rows, and one
  synthesized row a stem, rows x (hop + (back + fwd) x bins + 3 x nwin)
  x 4 bytes; a tp ring's two frequency halos, 2 x fm columns x frames x
  4 bytes a cut edge;
* ordered sums (``ordered_sum``): a tp ring's partial inverse DFTs, one
  [frames, nwin] float32 tensor a shard and stem, sent by its owner to
  every other process of the ring;
* gathers (``allgather``): every finished stem piece to every process
  (``process_allgather(tiled=True)``), the intermediate between the two
  passes of a cascade whose rings are cut, and each segment's stems and
  OLA tails of a checkpointed blocked scan whose ring is cut;
* agreements (``agree``): one integer, e.g. a checkpoint's next block.

Halos and ordered sums go point to point (``isend`` / ``irecv``, every
receive posted before any send, each message tagged by its shard), not
through one ``all_gather`` of the boundary slices: a pass then sends
what its cut edges need, and a process whose rings lie whole inside it
sends nothing. ``traffic`` counts the bytes each kind of exchange sent
from this process and the seconds it waited in them.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..errors import ZenError

KINDS = ("halo", "sum", "gather", "agree")
# {kind: {"calls", "bytes", "seconds"}}: what this process sent and how
# long it waited, per kind of exchange, since the last reset_traffic()
traffic: dict = {}


def reset_traffic() -> None:
    for kind in KINDS:
        traffic[kind] = {"calls": 0, "bytes": 0, "seconds": 0.0}


reset_traffic()


def _count(kind: str, nbytes: int, t0: float) -> None:
    row = traffic[kind]
    row["calls"] += 1
    row["bytes"] += int(nbytes)
    row["seconds"] += time.perf_counter() - t0


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if _group_ready() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _group_ready() else 0


def _staged(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu").contiguous()


def allgather(x: torch.Tensor, kind: str = "gather") -> torch.Tensor:
    """Every process's ``x`` (equal shapes) joined along dim 0 in rank
    order, on ``x``'s device: ``process_allgather(x, tiled=True)``."""
    if process_count() == 1:
        return x
    t0 = time.perf_counter()
    local = _staged(x)
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    out = torch.cat(parts).to(x.device)
    _count(kind, local.nbytes * (process_count() - 1), t0)
    return out


def allgather_objects(obj) -> list:
    """Every process's picklable ``obj``, in rank order."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def leave() -> None:
    """End this process's part in the group once every process is done: a
    barrier, then ``destroy_process_group``. Without it a process that
    exits while a peer (process 0 serves the rendezvous store) still
    talks to it can abort in the group's threads ("terminate called
    without an active exception"). A no-op without a group."""
    if _group_ready():
        dist.barrier()
        dist.destroy_process_group()


def agree(value: int, what: str) -> int:
    """``value``, once every process holds the same; a ZenError naming
    each process's value otherwise, on every process at once (so that
    none goes on into collectives the others never enter)."""
    values = [int(v) for v in allgather(torch.tensor([int(value)], dtype=torch.int64), "agree")]
    if len(set(values)) != 1:
        raise ZenError(f"{what}: disagreement across processes (per process: {values})")
    return int(value)


def _p2p(sends: list, recvs: list, kind: str) -> list:
    """Point-to-point messages: ``sends`` [(rank, tag, tensor)] and
    ``recvs`` [(rank, tag, like)]; every receive is posted before any
    send. The received tensors, each on its ``like``'s device."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    bufs = [torch.empty(like.shape, dtype=like.dtype) for _, _, like in recvs]
    reqs = [dist.irecv(b, int(src), tag=int(tag)) for b, (src, tag, _) in zip(bufs, recvs)]
    staged = [_staged(x) for _, _, x in sends]
    reqs += [dist.isend(x, int(dst), tag=int(tag)) for x, (dst, tag, _) in zip(staged, sends)]
    for r in reqs:
        r.wait()
    _count(kind, sum(x.nbytes for x in staged), t0)
    return [b.to(like.device) for b, (_, _, like) in zip(bufs, recvs)]


def _neighbour(k: int, n: int, step: int, wrap: bool):
    """The shard ``step`` places to the left of shard k in its ring of n
    (k = ring * n + position), or None past an end of an open ring."""
    j = k % n - step
    if 0 <= j < n:
        return k - k % n + j
    return k - k % n + j % n if wrap else None


def ring_shift(xs: list, ks: list, devices: list, owners: np.ndarray, step: int,
               fill: float = 0.0, wrap: bool = False) -> list:
    """Ring halos: shard ks[i]'s tensor xs[i] (equal shapes), and the
    rings' owners [n_rings, n] (the rank holding each shard, a ring's
    shards in ring order; shard k = ring * n + position). Returns, for
    each shard of ``ks``, the tensor of the shard ``step`` places to its
    left (1: from the left, -1: from the right) on devices[i]: moved
    between this process's devices where it owns that shard, received
    over gloo where another process does. Past an open ring's ends, a
    tensor of ``fill`` (``ppermute``'s zeros, or the prefill feature);
    ``wrap`` closes the ring (tp's circular bins)."""
    n = owners.shape[1]
    flat = owners.ravel()
    held = {k: i for i, k in enumerate(ks)}
    out = [None] * len(xs)
    recvs, at = [], []
    for i, k in enumerate(ks):
        src = _neighbour(k, n, step, wrap)
        if src is None:
            out[i] = torch.full_like(xs[i], fill)
        elif src in held:
            out[i] = xs[held[src]].to(devices[i], non_blocking=True)
        else:
            recvs.append((flat[src], k, xs[i]))
            at.append(i)
    sends = []
    for i, k in enumerate(ks):
        dst = _neighbour(k, n, -step, wrap)
        if dst is not None and dst not in held:
            sends.append((flat[dst], dst, xs[i]))
    for i, y in zip(at, _p2p(sends, recvs, "halo")):
        out[i] = y
    return out


def ordered_sum(xs: list, ks: list, owners: np.ndarray, device: torch.device) -> torch.Tensor:
    """The sum over every shard of one ring of its tensor (equal shapes),
    this process holding shards ks (xs[i] shard ks[i]'s), in ring order
    on ``device``: x_0 + x_1 + ... left to right, so that the bits equal
    one process's sum of the same tensors. A process sends each of its
    tensors to every other process of the ring and receives the rest; not
    ``all_reduce``, whose order of addition is gloo's own."""
    n = owners.shape[1]
    ring = ks[0] // n
    me = process_index()
    row = owners[ring]
    held = dict(zip(ks, xs))
    peers = sorted({int(p) for p in row} - {me})
    sends = [(p, k, x) for p in peers for k, x in held.items()]
    remote = [ring * n + j for j in range(n) if ring * n + j not in held]
    recvs = [(row[k - ring * n], k, xs[0]) for k in remote]
    held.update(zip(remote, _p2p(sends, recvs, "sum")))
    parts = [held[ring * n + j] for j in range(n)]
    y = parts[0].to(device, non_blocking=True)
    for other in parts[1:]:
        y = y + other.to(device, non_blocking=True)
    return y
