"""Checkpoint and resume (counterpart of ``zen_tpu/runtime/checkpoint.py``).

The streaming step is a function of an explicit state (input ring,
feature history, OLA tails), so that state is the checkpoint: saved, a
stream resumes bit-exactly. Per-track progress of long runs goes to an
append-only journal.

The file is zen_tpu's ``.npz``: ``leaf_<i>`` in field order (ring,
feat_hist, ola_tail for a ``StreamState``; ``leaf_0`` for a lone tensor)
and ``_meta``, the metadata as JSON bytes. A one-stream state of the port
is written without its leading stream axis, as zen_tpu writes its
single-stream state; a state of C > 1 streams keeps the axis
([C, nwin], [C, H, bins], [C, 3, hop]). A bfloat16 leaf is written as
zen_tpu writes one, two raw bytes an element (numpy dtype ``|V2``), and
read back from those bits: no ``ml_dtypes`` is needed on either side.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..drivers.realtime import StreamState
from ..errors import ZenError


def _leaves(state) -> list:
    return [state] if isinstance(state, torch.Tensor) else list(state)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if x.dtype == np.dtype("V2"):  # bfloat16 bits: the high half of a float32
        x = (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    t = torch.from_numpy(np.array(x))
    if t.ndim == like.ndim - 1 and like.shape[0] == 1:  # a one-stream state
        t = t[None]
    if t.shape != like.shape:
        raise ZenError(f"checkpoint leaf of shape {tuple(t.shape)} where the state "
                       f"has {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _pack_state(state, meta: dict | None) -> dict:
    leaves = _leaves(state)
    one_stream = isinstance(state, StreamState) and state.ring.shape[0] == 1
    arrays = {f"leaf_{i}": _to_numpy(t[0] if one_stream else t) for i, t in enumerate(leaves)}
    arrays["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    return arrays


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_stream_state(path: str, state, meta: dict | None = None) -> None:
    """Save a ``StreamState`` (or a tensor, or a tuple of tensors) and
    metadata to ``path`` (``.npz`` appended when missing)."""
    np.savez(path, **_pack_state(state, meta))


def save_stream_state_durable(path: str, state, meta: dict | None = None) -> None:
    """``save_stream_state`` that a crash cannot tear: write a temporary
    file, fsync it, rename it over the old one and fsync the directory.
    A kill at any point leaves the previous checkpoint or this one."""
    final = _npz(path)
    tmp = final + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **_pack_state(state, meta))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    dfd = os.open(os.path.dirname(final) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_stream_state(path: str, like):
    """Restore what ``save_stream_state`` (the port's or zen_tpu's) wrote:
    ``like`` (e.g. ``init_state(cfg, 1, device)``, or a tensor) gives the
    structure, shapes, dtypes and device. Returns (state, meta)."""
    with np.load(_npz(path)) as data:
        restored = [_from_numpy(data[f"leaf_{i}"], t) for i, t in enumerate(_leaves(like))]
        meta = json.loads(bytes(data["_meta"].tobytes()).decode() or "{}")
    if isinstance(like, torch.Tensor):
        return restored[0], meta
    return type(like)(*restored), meta


class ProgressJournal:
    """Append-only journal of completed work items (track ids) for
    resumable runs: one fsynced JSON line per item, zen_tpu's format."""

    def __init__(self, path: str):
        self.path = path
        self._done = set()
        # a torn last line gets its newline before the next item, which
        # would otherwise be glued to it and lost
        self._torn = False
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    self._torn = not line.endswith("\n")
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._done.add(json.loads(line)["id"])
                    except (json.JSONDecodeError, KeyError):
                        # a crash mid-append leaves at most one torn last
                        # line, whose item was not durably done
                        continue

    def is_done(self, item_id: str) -> bool:
        return item_id in self._done

    def mark_done(self, item_id: str, info: dict | None = None) -> None:
        with open(self.path, "a") as fh:
            fh.write("\n" * self._torn + json.dumps({"id": item_id, **(info or {})}) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._torn = False
        self._done.add(item_id)
