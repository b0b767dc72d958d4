"""Carry configuration and stream state across from the JAX package.

This system has no weights: what a checkpoint holds, and what moves
between the two packages, is the stream state (input ring, feature
history, OLA tails) and the configuration. Both cross as plain Python
values and numpy arrays, so nothing here imports jax:

    cfg = config_from_fields(**dataclasses.asdict(jax_cfg))
    state = state_from_numpy(*map(np.asarray, jax_state), cfg=cfg)
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .drivers.realtime import StreamState, hist_dtype
from .engine.config import HPRConfig

MEDIAN_IMPL_FROM_JAX = {"xla": "torch", "pallas": "cuda"}
FFT_IMPL_FROM_JAX = {"xla": "torch"}


def config_from_fields(**fields) -> HPRConfig:
    """HPRConfig from the JAX package's config fields, with its backend
    names mapped: median_impl 'xla' -> 'torch' (the plain reference,
    which takes CPU tensors only), 'pallas' -> 'cuda'; fft_impl 'xla' ->
    'torch'; the 'dft*' transform names pass through as they are."""
    fields = dict(fields)
    if "median_impl" in fields:
        fields["median_impl"] = MEDIAN_IMPL_FROM_JAX.get(
            fields["median_impl"], fields["median_impl"]
        )
    if "fft_impl" in fields:
        fields["fft_impl"] = FFT_IMPL_FROM_JAX.get(fields["fft_impl"], fields["fft_impl"])
    return HPRConfig(**fields)


def state_from_numpy(
    ring, feat_hist, ola_tail, device="cuda", cfg: HPRConfig | None = None
) -> StreamState:
    """StreamState on ``device`` from numpy arrays, with or without the
    leading stream axis (the JAX single-stream state has none). The card
    by default, as the drivers; the CPU only when ``device="cpu"``.

    The feature history takes ``cfg``'s stream state dtype (bfloat16
    under 'bf16'; float32 without a cfg); ring and tails are float32. A
    JAX bf16 history read back as float32 numpy converts exactly, and so
    does an SSE history's +inf prefill."""
    device = resolve_device(device)
    dtype = hist_dtype(cfg) if cfg is not None else torch.float32
    ring, feat_hist, ola_tail = (
        np.array(x, np.float32) for x in (ring, feat_hist, ola_tail)
    )
    if ring.ndim == 1:
        ring, feat_hist, ola_tail = ring[None], feat_hist[None], ola_tail[None]
    return StreamState(
        torch.from_numpy(ring).to(device),
        torch.from_numpy(feat_hist).to(device=device, dtype=dtype),
        torch.from_numpy(ola_tail).to(device),
    )


def state_to_numpy(state: StreamState) -> tuple:
    """(ring, feat_hist, ola_tail) as host numpy arrays, stream axis first."""
    return tuple(t.detach().cpu().numpy() for t in state)
