"""How two runs of one offline pass are held against each other.

Bitwise where both ran the same arithmetic on one device type. Where
they did not (cuFFT's bits for a row can depend on the batch's row
count, so two shardings of one pass can round a spectrum apart), by the
flip rule of PERF.md section 2: a hard-mask bin whose ratio sits within
float noise of beta may flip, at most ``FLIP_SHARE`` of all bins, and
every output sample that no flipped frame feeds agrees within
``STEM_ATOL`` x max(1, max|ref|) of its row.
"""
from __future__ import annotations

import torch

from ..engine.spectral import STEMS
from ..errors import ZenError

STEM_ATOL = 5e-5  # the realtime parity class, tests/test_engine_parity.py:271-275
FLIP_SHARE = 1e-5


def bitwise(got: dict, want: dict) -> bool:
    return all(torch.equal(got[k], want[k]) for k in STEMS)


def flip_rule(got: dict, want: dict, masks_got, masks_want, hop: int,
              atol: float = STEM_ATOL, what: str = "") -> dict:
    """Hold one offline pass's stems {name: [C, L]} against a reference
    run's under the flip rule, each run's (harmonic, percussive) masks
    [C, frames, bins] given (frame t feeds output chunks t - 1 and t);
    raises ZenError where the rule fails. Returns the flips, their
    share, the samples excluded and the worst error over scale."""
    n = min(masks_got[0].shape[-2], masks_want[0].shape[-2])
    differ = torch.zeros_like(masks_got[0][..., :n, :], dtype=torch.bool, device="cpu")
    for a, b in zip(masks_got[:2], masks_want[:2]):
        differ |= a[..., :n, :].cpu() != b[..., :n, :].cpu()
    flips = int(differ.sum())
    share = flips / differ.numel()
    if share > FLIP_SHARE:
        raise ZenError(f"{what}: hard-mask flips {flips} ({share:.3g} of bins)")
    flipped = differ.any(dim=-1)
    excluded = flipped[..., :-1] | flipped[..., 1:]  # chunk k = frames k and k + 1
    length = want[STEMS[0]].shape[-1]
    keep = ~excluded.repeat_interleave(hop, dim=-1)[..., :length]
    worst = 0.0
    for name in STEMS:
        g, w = got[name].cpu(), want[name].cpu()
        if not bool(torch.isfinite(g).all()):
            raise ZenError(f"{what} {name}: non-finite samples")
        scale = w.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
        err = float(torch.where(keep, (g - w).abs() / scale, 0.0).max())
        if err > atol:
            raise ZenError(f"{what} {name}: max |diff|/scale {err:.3g} > {atol}")
        worst = max(worst, err)
    return {"flips": flips, "share": share, "excluded": int((~keep).sum()), "rel_err": worst}
