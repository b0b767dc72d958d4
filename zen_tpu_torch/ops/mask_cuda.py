"""The hand-written mask-and-apply kernel and its plain PyTorch twin.

``mask_apply`` forms the hard masks (hps.h:100-113) of the filtered
features h (K1's output) and p (K2's output) and applies them to the
spectrum s in one pass (``csrc/mask_apply.cu``): for each live stem it
writes s * mask into the buffer the inverse transform reads, and no mask
tensor is ever stored. It replaces no TPU kernel: the JAX engine leaves
masks and the masked spectrum to XLA, which fuses them.

The conventions are ``median_cuda.py``'s: a CPU tensor takes the
``_plain`` twin (``hard_masks``, then s * mask a stem), a CUDA tensor
the kernel (contiguous operands on one device, the launch's error code
checked, no fallback); the wrapper raises on anything the kernel does
not take. The kernel launches on the current stream, never
synchronizes and allocates nothing: the wrapper allocates the output.
``launches`` counts the kernel's launches and ``routes`` every call by
route, ``kernel`` or ``plain``.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ..errors import ZenError
from . import _build
from .median_cuda import _launch, _sm_count

# a stem's index, as engine.spectral.STEMS orders them, is its code in the kernel
HARMONIC, PERCUSSIVE, RESIDUAL = 0, 1, 2
PAIR = 2  # elements a lane of the kernel takes a step


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v))


def hard_masks(h: torch.Tensor, p: torch.Tensor, beta: float, eps: float,
               output_harmonic: bool = True, output_percussive: bool = True) -> tuple:
    """(pm, hm, rm) float32 hard masks of h and p: (x / (y + eps)) >=
    beta, the harmonic mask against beta - eps so ties go percussive
    (hps.cu:540); residual 1 - (hm + pm) with a disabled stem's mask
    taken as 0 (hps.cu:562-567). Constants are float32 scalars."""
    eps, beta = _f32(eps), _f32(beta)
    pm = (p / (h + eps) >= beta).to(torch.float32)
    hm = (h / (p + eps) >= beta - eps).to(torch.float32)
    hm_eff = hm if output_harmonic else torch.zeros_like(hm)
    pm_eff = pm if output_percussive else torch.zeros_like(pm)
    return pm, hm, 1.0 - (hm_eff + pm_eff)


def _check(s: torch.Tensor, h: torch.Tensor, p: torch.Tensor, stems: tuple, dim: int) -> None:
    if s.dtype != torch.complex64 or h.dtype != torch.float32 or p.dtype != torch.float32:
        raise ZenError("mask_apply takes complex64 s and float32 h and p, got "
                       f"{s.dtype}, {h.dtype}, {p.dtype}")
    if s.shape != h.shape or s.shape != p.shape or s.dim() < 1:
        raise ZenError("mask_apply takes s, h and p of one shape, got "
                       f"{tuple(s.shape)}, {tuple(h.shape)}, {tuple(p.shape)}")
    if not stems or len(set(stems)) != len(stems) or not set(stems) <= {HARMONIC, PERCUSSIVE,
                                                                         RESIDUAL}:
        raise ZenError(f"mask_apply takes one or more distinct stems of (0, 1, 2), got {stems}")
    if not 0 <= dim < s.dim():
        raise ZenError(f"mask_apply's stem axis {dim} outside [0, {s.dim()})")


def mask_apply_plain(s: torch.Tensor, h: torch.Tensor, p: torch.Tensor, beta: float,
                     eps: float, stems: tuple, output_harmonic: bool = True,
                     output_percussive: bool = True, dim: int = 0) -> torch.Tensor:
    """Plain twin of ``mask_apply``: ``hard_masks``, then s * mask of
    each stem, stacked along ``dim``."""
    stems = tuple(stems)
    _check(s, h, p, stems, dim)
    pm, hm, rm = hard_masks(h, p, beta, eps, output_harmonic, output_percussive)
    by_stem = (hm, pm, rm)
    return torch.stack([s * by_stem[i] for i in stems], dim=dim)


_COUNT_LOCK = threading.Lock()


def _count(route: str) -> None:
    with _COUNT_LOCK:
        if route == "kernel":
            mask_apply.launches += 1
        mask_apply.routes[route] += 1


def mask_layout(shape: tuple, n_stems: int, dim: int) -> tuple:
    """(outer, inner, stride) of the output with the stem axis at ``dim``
    of ``shape``: input element o * inner + r goes, for stem slot l, to
    (o * n_stems + l) * stride + r. Stem rows of one o (``dim`` 0 or a
    leading size of 1) start on a pair of elements; otherwise the output
    is the contiguous [..., L, ...]."""
    outer = math.prod(shape[:dim])
    inner = math.prod(shape[dim:])
    stride = inner if outer > 1 or n_stems == 1 else -(-inner // PAIR) * PAIR
    return outer, inner, stride


def mask_apply(s: torch.Tensor, h: torch.Tensor, p: torch.Tensor, beta: float, eps: float,
               stems: tuple, output_harmonic: bool = True, output_percussive: bool = True,
               dim: int = 0) -> torch.Tensor:
    """The masked spectra of ``stems`` (indices into (harmonic,
    percussive, residual)) of s [..., bins] complex64 under the hard masks
    of h and p (float32, s's shape), stacked along a new axis at ``dim``:
    shape s.shape[:dim] + (len(stems),) + s.shape[dim:], bit for bit the
    twin's on the card. Each stem's slice is contiguous; at ``dim`` 0 the
    stems' rows may lie one element apart (``mask_layout``)."""
    stems = tuple(stems)
    _check(s, h, p, stems, dim)
    if not s.is_cuda:
        _count("plain")
        return mask_apply_plain(s, h, p, beta, eps, stems, output_harmonic,
                                output_percussive, dim)
    for x in (h, p):
        if x.device != s.device:
            raise ZenError("mask_apply's operands lie on different devices")
    if not (s.is_contiguous() and h.is_contiguous() and p.is_contiguous()):
        raise ZenError("mask_apply's kernel takes contiguous tensors")
    n_stems, shape = len(stems), tuple(s.shape)
    outer, inner, stride = mask_layout(shape, n_stems, dim)
    buf = torch.empty(outer * n_stems * stride, dtype=torch.complex64, device=s.device)
    out = buf.view(outer, n_stems, stride)[..., :inner].view(
        shape[:dim] + (n_stems,) + shape[dim:])
    n = s.numel()
    if n == 0:
        return out
    if n_stems == 1:  # one stem: element i goes to i
        inner = stride = n
    # a lane of the pair kernel loads 8 bytes of h and p and 16 of s, and
    # stores 16 a stem; a pair never straddles two o
    pairs = (h.data_ptr() % 8 == p.data_ptr() % 8 == 0
             and s.data_ptr() % 16 == buf.data_ptr() % 16 == 0
             and (inner % PAIR == 0 or inner == n))
    need = {i for i in stems if i != RESIDUAL}
    if RESIDUAL in stems:
        need |= {i for i, on in ((HARMONIC, output_harmonic), (PERCUSSIVE, output_percussive))
                 if on}
    beta32, eps32 = np.float32(beta), np.float32(eps)
    err = _launch(
        s,
        _build.library().zen_mask_apply,
        h.data_ptr(), p.data_ptr(), s.data_ptr(), buf.data_ptr(),
        n, inner, stride, n_stems,
        sum(i << (2 * l) for l, i in enumerate(stems)),
        int(HARMONIC in need), int(PERCUSSIVE in need),
        int(output_harmonic), int(output_percussive),
        float(eps32), float(beta32), float(beta32 - eps32),
        int(pairs), _sm_count(s.device),
    )
    _build.check(err, "mask_apply")
    _count("kernel")
    return out


mask_apply.launches = 0
mask_apply.routes = dict.fromkeys(("kernel", "plain"), 0)
