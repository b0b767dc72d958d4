"""Exchanges across processes (counterpart of the
``jax.experimental.multihost_utils`` calls zen_tpu makes).

A multi-process run is a ``torch.distributed`` process group, joined by
``parallel/mesh.py``'s ``distributed_init``. Every function here is
issued by every process of the group in the same order (the corpus reads
the same tracks and builds the same batches on each), and is a local
no-op in a single process.

The exchanges travel as CPU tensors over the ``gloo`` backend. This is a
design decision, not a fallback: what zen_tpu sends across processes is
the finished stems of each process's dp rows, bound for process 0's
writer (``process_allgather(tiled=True)``), and one checkpoint integer a
segment; neither is on the card's critical path. NCCL would also refuse
the two or three ranks that share one card in ``tools/multihost_smoke.py``
and chip_smoke's phase 30. Halos never cross processes: ``make_mesh``
keeps every sp and tp ring inside one process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..errors import ZenError


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if _group_ready() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _group_ready() else 0


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) joined along dim 0 in rank
    order, on ``x``'s device: ``process_allgather(x, tiled=True)``."""
    if process_count() == 1:
        return x
    local = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return torch.cat(parts).to(x.device)


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
    values = [int(v) for v in allgather(torch.tensor([int(value)], dtype=torch.int64))]
    if len(set(values)) != 1:
        raise ZenError(f"{what}: disagreement across processes (per process: {values})")
    return int(value)
