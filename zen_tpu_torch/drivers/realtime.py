"""Streaming causal HPR on PyTorch (counterpart of
``zen_tpu/drivers/realtime.py``).

The per-hop state machine of the reference (libzen/hps.cu:282-427) is
carried explicitly, with a leading stream dim C:

    ring       [C, nwin]        input ring        (hps.h:182, hps.cu:452)
    feat_hist  [C, H, bins]     trailing feature frames, H =
                                config.time_history; float32, or
                                bfloat16 under stream_state='bf16'
    ola_tail   [C, 3, hop]      second halves of the previous frame's
                                scaled iFFTs (the OLA carry)

``block_step`` processes B hops of C streams per call and updates the
state tensors IN PLACE, where the JAX step donates its state buffers:
the state is allocated once (``init_state``) and never reallocated.
B = 1 gives exact per-hop streaming. A step opens the span ``zen.step``
over its phases (``runtime/profiling.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..engine.config import OUTPUT_ALL, HPRConfig
from ..engine.spectral import (
    STEMS,
    analyze_features,
    feature_masks,
    freq_filtered,
    num_bins,
    prefill_value,
    synthesize,
    time_filtered_tail_pair,
)
from ..device import resolve_device
from ..errors import ZenError
from ..runtime.profiling import span


class StreamState(NamedTuple):
    ring: torch.Tensor  # [C, nwin]
    feat_hist: torch.Tensor  # [C, H, bins]
    ola_tail: torch.Tensor  # [C, 3, hop]


def hist_dtype(cfg: HPRConfig) -> torch.dtype:
    """dtype of the carried feature history (``cfg.stream_state``)."""
    return torch.bfloat16 if cfg.stream_state == "bf16" else torch.float32


def init_state(cfg: HPRConfig, n_streams: int = 1, device="cuda") -> StreamState:
    """Zeroed state == the reference's reset_buffers (hps.h:296-321);
    the feature history holds the feature of a zero frame (+inf under
    SSE, ``prefill_value``). On the card
    unless ``device="cpu"`` is passed (``resolve_device``)."""
    device = resolve_device(device)
    return StreamState(
        ring=torch.zeros((n_streams, cfg.nwin), device=device),
        feat_hist=torch.full(
            (n_streams, cfg.time_history, num_bins(cfg)),
            prefill_value(cfg),
            dtype=hist_dtype(cfg),
            device=device,
        ),
        ola_tail=torch.zeros((n_streams, 3, cfg.hop), device=device),
    )


@functools.lru_cache(maxsize=16)
def _rows(rows: tuple, device: torch.device):
    """An index of the stem rows ``rows`` that keeps the host from
    waiting on the card: a slice where they are one run, else an index
    tensor on ``device``, made once. A Python list as an index of a CUDA
    tensor is copied from pageable host memory on every use, and that
    copy synchronizes the host with the card."""
    if rows == tuple(range(rows[0], rows[-1] + 1)):
        return slice(rows[0], rows[-1] + 1)
    return torch.tensor(rows, device=device)


def enabled_stems(cfg: HPRConfig) -> tuple:
    """Indices into STEMS of the stems the block step emits — the
    cfg's output flags. (An enabled residual under soft or SSE masks
    has no mask definition and yields a zero row, the reference's
    unwritten-buffer behavior, hps.cu:562-567.)"""
    return tuple(
        i for i, name in enumerate(STEMS) if getattr(cfg, f"output_{name}")
    )


class StepSpectra(NamedTuple):
    samples: torch.Tensor  # [C, nwin + B*hop] ring ++ block
    spectra: torch.Tensor  # [C, B, bins] complex
    feat: torch.Tensor  # [C, B, bins] filter input, in the history's dtype
    masks: tuple  # (harmonic, percussive, residual) [C, B, bins]; the
    # residual is None under soft and SSE masks


def step_masks(
    cfg: HPRConfig, state: StreamState, blocks: torch.Tensor
) -> StepSpectra:
    """The analysis half of ``block_step``: framing over ring ++ block,
    window + FFT, both median filters and the masks of B hops of C
    streams. Reads ``state`` and leaves it as it is."""
    if not cfg.causal:
        raise ZenError("streaming drivers are causal-only")
    c, b, hop = blocks.shape
    with span("zen.frame", blocks):
        # frames i = samples[(i+1)*hop : (i+3)*hop] over ring ++ block
        samples = torch.cat([state.ring, blocks.reshape(c, b * hop)], dim=1)
        hops = samples.view(c, b + 2, hop)
        frames = torch.cat([hops[:, 1 : b + 1], hops[:, 2:]], dim=-1)

    # spectra [C, B, bins]. stream_state='bf16' carries the history in
    # half precision; the fresh features are quantized to match, so every
    # tap of both filters sees one precision. The medians run on that
    # dtype and return float32; the SSE means sum float32 taps
    # (zen_tpu/drivers/realtime.py:153). Masks and synthesis are float32
    # either way.
    s, feat = analyze_features(frames, cfg, state.feat_hist.dtype)
    h_rows = time_filtered_tail_pair(state.feat_hist, feat, cfg)
    p_rows = freq_filtered(feat, cfg)
    pm, hm, rm = feature_masks(h_rows, p_rows, cfg)
    return StepSpectra(samples, s, feat, (hm, pm, rm))


def advance_state(cfg: HPRConfig, state: StreamState, step: StepSpectra) -> None:
    """Move the input ring and the feature history past the step's
    block, in place. The next history is the fresh rows' tail when
    B >= H and concat(hist, fresh)[-H:] when B < H. Span ``zen.advance``."""
    b, h_len = step.feat.shape[1], cfg.time_history
    with span("zen.advance", state.ring):
        if b >= h_len:
            state.feat_hist.copy_(step.feat[:, b - h_len :])
        else:
            state.feat_hist.copy_(torch.cat([state.feat_hist[:, b:], step.feat], dim=1))
        state.ring.copy_(step.samples[:, -cfg.nwin :])


def block_step(
    cfg: HPRConfig, state: StreamState, blocks: torch.Tensor
) -> torch.Tensor:
    """Process B hops of C streams: blocks [C, B, hop] -> outs
    [C, E, B*hop], one row per ENABLED stem (harmonic/percussive/
    residual order filtered to enabled); ``state`` is updated in place.

    Equivalent to B successive process_next_hop calls of the reference
    causal engine (hps.cu:429-486) per stream, i.e. to
    zen_tpu.drivers.realtime._block_step_body. One code path serves
    every B: the JAX step branches on B >= H (realtime.py:141-147) only
    because its TPU kernels for the two forms tile differently, while
    K1 reads [hist ++ fresh] through two pointers for any B
    (``step_masks``); ``advance_state`` carries both history updates.
    """
    c, b, hop = blocks.shape
    with span("zen.step", blocks):
        step = step_masks(cfg, state, blocks)

        # only enabled stems are synthesized and emitted (compact rows);
        # the enabled stems with a mask go through one batched inverse
        masks = step.masks
        en = enabled_stems(cfg)
        live = [i for i in en if masks[i] is not None]
        if live:
            with span("zen.synth", blocks):
                live_masks = torch.stack([masks[i] for i in live], dim=1)
                y = synthesize(step.spectra.unsqueeze(1), live_masks, cfg)  # [C, L, B, nwin]
        with span("zen.ola", blocks):
            if live:
                tails = _rows(tuple(live), blocks.device)
                prev_tails = torch.cat(
                    [state.ola_tail[:, tails, None], y[:, :, :-1, hop:]], dim=2
                )
                chunk = (y[..., :hop] + prev_tails).reshape(c, len(live), b * hop)
                state.ola_tail[:, tails] = y[:, :, -1, hop:]
            if live and len(live) == len(en):
                outs = chunk
            else:  # enabled residual under soft or SSE masks: a zero row
                outs = torch.zeros((c, len(en), b * hop), device=blocks.device)
                if live:
                    outs[:, _rows(tuple(en.index(i) for i in live), blocks.device)] = chunk

        advance_state(cfg, state, step)
    return outs


def _as_blocks(x, hop: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device).reshape(-1, hop)


class HPRRealtime:
    """Streaming causal HPR, API-compatible with the reference
    HPRRealtime pimpl class (libzen/libzen/hps.h:74-118).

    process_next_hop(hop_samples) processes one hop; copy_harmonic /
    copy_percussive / copy_residual return that hop's stems. For
    throughput use process_block(block[B, hop]) — one step for B hops —
    or process_stream(). Step outputs stay on ``device`` (the card unless
    ``device="cpu"`` is passed); the copy_* reads and process_stream
    return host numpy arrays. Further keywords
    (border, stream_state, soft_mask, fast_rfft, median_impl, ...) go to
    HPRConfig.
    """

    def __init__(
        self,
        fs: float,
        hop: int = 256,
        beta: float = 2.0,
        outputs: int = 0,
        device="cuda",
        **cfg_kw,
    ):
        self.device = resolve_device(device)
        self.cfg = HPRConfig(
            fs=fs,
            hop=hop,
            beta=beta,
            causal=True,
            outputs=outputs or OUTPUT_ALL,
            **cfg_kw,
        )
        self.reset_buffers()

    # -- toggles (hps.cu:322-332) --
    def use_sse_filter(self):
        self._reconfig(use_sse=True)

    def use_soft_mask(self):
        self._reconfig(soft_mask=True)

    def _reconfig(self, **kw):
        self.cfg = dataclasses.replace(self.cfg, **kw)
        self.reset_buffers()

    def reset_buffers(self):
        self.state = init_state(self.cfg, 1, self.device)
        self._last = torch.zeros((3, self.cfg.hop), device=self.device)

    @property
    def latency_samples(self) -> int:
        """Inherent stream latency: the OLA emits each stem hop one hop
        after its input hop arrives (the reference's causal path has the
        same structural latency; 'causal' means zero lookahead)."""
        return self.cfg.hop

    def warmup(self, block_sizes=(1,)):
        """Run the step once per block size (building the CUDA kernels
        and cuFFT plans on first use) and reset — analog of warmup()
        (hps.cu:392-409), which hides first-dispatch latency."""
        for b in block_sizes:
            self.process_block(torch.zeros((b, self.cfg.hop)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset_buffers()

    def _expand(self, outs: torch.Tensor) -> torch.Tensor:
        """Compact step rows [E, n] -> the reference's 3-row (h, p, r)
        form, zeros for disabled stems."""
        en = enabled_stems(self.cfg)
        if len(en) == 3:
            return outs
        full = torch.zeros((3, outs.shape[-1]), device=outs.device)
        full[_rows(en, outs.device)] = outs
        return full

    def process_block(self, block) -> torch.Tensor:
        """block: [B, hop] or [B*hop] -> outs [3, B*hop] (h, p, r) on
        ``device``."""
        blocks = _as_blocks(block, self.cfg.hop, self.device)[None]
        self._last = self._expand(block_step(self.cfg, self.state, blocks)[0])
        return self._last

    def process_next_hop(self, hop_samples) -> torch.Tensor:
        return self.process_block(hop_samples)

    def process_stream(self, audio, block_hops: int = 64) -> np.ndarray:
        """Stream a whole [L] signal through the causal engine in blocks
        of ``block_hops`` hops, zero-padding the last hop. Returns
        [3, ceil(L/hop)*hop] on the host.

        A ragged final block is processed at its exact size — padding
        it with zero hops would advance the stream state past hops that
        were never part of the signal, corrupting any later call."""
        audio = torch.as_tensor(np.asarray(audio, np.float32))
        hop = self.cfg.hop
        n_hops = -(-audio.numel() // hop)
        padded = torch.zeros(n_hops * hop)
        padded[: audio.numel()] = audio
        blocks = padded.to(self.device).reshape(n_hops, hop)
        outs = [
            self.process_block(blocks[start : start + block_hops])
            for start in range(0, n_hops, block_hops)
        ]
        return torch.cat(outs, dim=1).cpu().numpy()

    # -- per-hop output reads (hps.cu:342-363): always the NEWEST hop --
    def copy_harmonic(self) -> np.ndarray:
        return self._last[0, -self.cfg.hop :].cpu().numpy()

    def copy_percussive(self) -> np.ndarray:
        return self._last[1, -self.cfg.hop :].cpu().numpy()

    def copy_residual(self) -> np.ndarray:
        return self._last[2, -self.cfg.hop :].cpu().numpy()


class MultiStreamHPR:
    """C independent causal HPR streams in one step — the BASELINE
    'batched multi-channel fakert' configuration (64 streams x
    44.1 kHz), up to the wide fleets of ``zen stream --streams 512``.
    The stream dim is an explicit batch dim on ``device`` (the card
    unless ``device="cpu"`` is passed). With a ``mesh``
    (``parallel/mesh.py``) the streams are split over its ``dp_axis``
    instead: each shard holds the state of its C/dp streams on its own
    device and runs ``block_step`` on its slice of every block, with no
    communication; ``device`` is then the first shard's device, where
    ``process_block`` gathers the rows. Over several processes each holds
    and steps the shards of the dp rows it owns entries of, with no
    collective, as zen_tpu's dp-sharded state; ``slots`` names the global
    stream slots of its rows. Further keywords (border, stream_state,
    ...) go to HPRConfig."""

    def __init__(
        self,
        n_streams: int,
        fs: float,
        hop: int = 256,
        beta: float = 2.0,
        outputs: int = 0,
        device="cuda",
        mesh=None,
        dp_axis: str = "dp",
        **cfg_kw,
    ):
        self.cfg = HPRConfig(
            fs=fs,
            hop=hop,
            beta=beta,
            causal=True,
            outputs=outputs or OUTPUT_ALL,
            **cfg_kw,
        )
        self.n_streams = n_streams
        if mesh is None:
            n_dp, rows = 1, [(0, resolve_device(device))]
        else:
            n_dp, rows = mesh.size(dp_axis), mesh.own(dp_axis)
        if n_streams % n_dp:
            raise ZenError(f"streams ({n_streams}) not divisible by dp ({n_dp})")
        per = n_streams // n_dp
        # (first stream, device, state) of each shard this process holds
        self.shards = [(i * per, dev, init_state(self.cfg, per, dev)) for i, dev in rows]
        self.device = self.shards[0][1]
        # the global stream slots of process_block's rows, in order
        self.slots = range(self.shards[0][0], self.shards[-1][0] + per)

    @property
    def state(self) -> StreamState:
        """The fleet's state, where it has one shard."""
        if len(self.shards) != 1:
            raise ZenError("a fleet sharded over dp holds one state per shard (.shards)")
        return self.shards[0][2]

    def warmup(self, block_sizes=(16,)):
        """Run the step for the given block sizes on a scratch copy of
        each shard's state (building kernels and cuFFT plans on first
        use); the streams' own state is not advanced."""
        for _, dev, state in self.shards:
            scratch = StreamState(*(t.clone() for t in state))
            for b in block_sizes:
                block_step(
                    self.cfg,
                    scratch,
                    torch.zeros((state.ring.shape[0], b, self.cfg.hop), device=dev),
                )
        for _, dev, _ in self.shards:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @property
    def stem_rows(self) -> dict:
        """Stem name -> row in process_block's output (None when the
        stem is disabled): the step emits COMPACT rows, one per enabled
        stem."""
        en = enabled_stems(self.cfg)
        return {
            name: (en.index(i) if i in en else None)
            for i, name in enumerate(STEMS)
        }

    def process_block(self, blocks) -> torch.Tensor:
        """blocks: [C, B, hop] (every stream, as on every process) -> outs
        [C', E, B*hop] on ``device``, one row per ENABLED stem (row order
        per ``stem_rows``), for the streams of ``slots`` in order (C' = C
        in one process)."""
        blocks = torch.as_tensor(blocks, dtype=torch.float32)
        if blocks.ndim != 3 or blocks.shape[0] != self.n_streams:
            raise ZenError(
                f"blocks must be [{self.n_streams}, B, hop], got {tuple(blocks.shape)}"
            )
        if len(self.slots) == self.n_streams and len(self.shards) == 1:
            return block_step(self.cfg, self.shards[0][2], blocks.to(self.device))
        # every shard's step is enqueued before any result is gathered
        outs = [block_step(self.cfg, state, blocks[lo : lo + state.ring.shape[0]]
                           .to(dev, non_blocking=True))
                for lo, dev, state in self.shards]
        return torch.cat([o.to(self.device, non_blocking=True) for o in outs])

    def reset_streams(self, indices):
        """Reset the given (global) stream slots to pristine state in
        place, those of ``slots`` on this process, leaving all other slots
        untouched — the serving move when a slot
        is recycled for a new client mid-flight. A reset slot reproduces
        a fresh stream bit-exactly. The slots are filled run by run
        through slices, so nothing is copied from the host and the call
        does not wait on the card (an index tensor built from a Python
        list would be a pageable host-to-device copy, which does)."""
        for lo, hi in _slot_runs(indices, self.n_streams):
            for first, _, state in self.shards:
                a, b = max(lo, first) - first, min(hi, first + state.ring.shape[0]) - first
                if a < b:
                    state.ring[a:b] = 0.0
                    state.feat_hist[a:b] = prefill_value(self.cfg)
                    state.ola_tail[a:b] = 0.0


def _slot_runs(indices, n_streams: int) -> list:
    """The distinct stream slots of ``indices`` (negative ones count from
    the end) as ascending half-open runs [lo, hi) of consecutive slots."""
    slots = set()
    for i in indices:
        i = int(i)
        if not -n_streams <= i < n_streams:
            raise ZenError(f"stream slot {i} outside [0, {n_streams})")
        slots.add(i % n_streams)
    runs = []
    for i in sorted(slots):
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return [tuple(r) for r in runs]
