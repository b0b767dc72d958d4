"""Framing and overlap-add assembly on PyTorch (counterpart of
``zen_tpu/ops/framing.py``).

The reference keeps an nwin input ring and rotating nwin-length OLA
output buffers (hps.cu:435-453). Over a whole signal those state
machines reduce to closed forms: with a zero-prefilled ring, the ring at
hop n holds frame n of concat(zeros(hop), audio), and the OLA chunk at
hop n is y[n][:hop] + y[n-1][hop:] with y[n] that hop's scaled iFFT.
Both are reshapes, slices and one add here, with no per-frame loop.
"""
from __future__ import annotations

import torch

from ..runtime.profiling import span


def frame_signal(audio: torch.Tensor, hop: int, n_frames: int) -> torch.Tensor:
    """[..., L] -> [..., n_frames, 2*hop] frames of the reference's input
    ring: frame n = concat(zeros(hop), audio)[n*hop : n*hop + 2*hop],
    zero past the end of ``audio``. Span ``zen.frame``."""
    with span("zen.frame", audio):
        lead = audio.shape[:-1]
        need = (n_frames + 1) * hop
        padded = audio.new_zeros(lead + (need,))
        body = min(audio.shape[-1], need - hop)
        padded[..., hop : hop + body] = audio[..., :body]
        # frame n = two adjacent hop blocks n and n + 1
        blocks = padded.view(lead + (n_frames + 1, hop))
        return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)


def overlap_add_stream(y: torch.Tensor, hop: int, advance: int) -> torch.Tensor:
    """Output stream from per-frame scaled iFFT chunks y [..., T, 2*hop]:
    chunk k = y[k + advance][:hop] + y[k + advance - 1][hop:].

    advance=1 (offline): the lag-column read (hps.cu:501-521) and the
    lag-chunk shift (hps.cu:171-178) compose to one frame of advance;
    returns (T - 1) * hop samples. advance=0 (causal): chunk n at hop n,
    with y[-1] = 0 from the zeroed OLA buffer; returns T * hop samples.
    Its callers open the span ``zen.ola`` over it and their own share of
    the overlap-add.
    """
    if advance not in (0, 1):
        raise ValueError(f"advance must be 0 or 1, got {advance}")
    if advance == 0:
        zero = y.new_zeros(y.shape[:-2] + (1, y.shape[-1]))
        y = torch.cat([zero, y], dim=-2)
    out = y[..., 1:, :hop] + y[..., :-1, hop:]
    return out.reshape(out.shape[:-2] + (-1,))
