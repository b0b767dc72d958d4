"""A fleet of causal streams served in lockstep: ``MultiStreamHPR.process_block``.

Traffic keys: ``streams`` (C), ``block_hops`` (B, hops of every stream a
step), ``bank_seconds`` (distinct audio a stream, read in a cycle),
``check_streams`` and ``check_steps`` (how many streams and steps the
check compares, drawn from the seed; the first two steps and the
window's last are always among the steps), ``check_from`` (the steps
are drawn below it).

Set-up makes every stream's audio on the card from the seed, a bank
[C, P + B, hop] whose last B hops repeat its first, so step n's block
is the view bank[:, p : p + B] with p = n B mod P: no copy, no upload.
The outputs stay on the card; the check holds its streams' rows of
its steps' outputs.

Stream audio is silence before step 0 and the state is finite: output
hop n depends on input hops n - H - 2 .. n alone (the ring, H history
frames, one OLA tail). So the reference recomputes a step from the
``warm`` hops before it, with silence before the stream's start, and
what it compares covers the state carried across steps.
"""
from __future__ import annotations

import math
import random
import time

import torch

from benchmark import roofline, signals
from benchmark.reference import hpr


class Loop:
    latency = "stream_step_ms"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 control: bool = False):
        from zen_tpu_torch.drivers.realtime import MultiStreamHPR
        from zen_tpu_torch.engine import config as zcfg

        s = {**config["settings"], **(config["control"] if control else {})}
        self.settings, self.device = s, device
        self.stage = hpr.Stage(s["fs"], s["hop"], s["beta"], True, tuple(s["stems"]), s["border"])
        self.hop, self.c, self.b = s["hop"], traffic["streams"], traffic["block_hops"]
        self.period = math.ceil(traffic["bank_seconds"] * s["fs"] / self.hop)
        t0 = time.perf_counter()
        audio = signals.mix(self.c, self.period * self.hop, s["fs"],
                            signals.generator(seed, device), device)
        audio = audio.view(self.c, self.period, self.hop)
        self.bank = torch.cat([audio, audio[:, : self.b]], dim=1)
        del audio
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        flags = sum(getattr(zcfg, f"OUTPUT_{name.upper()}") for name in s["stems"])
        self.sep = MultiStreamHPR(self.c, s["fs"], hop=self.hop, beta=s["beta"], outputs=flags,
                                  device=device, border=s["border"],
                                  stream_state=s["stream_state"])
        self.sep.warmup((self.b,))
        self.setup_parts = {"bank_s": t1 - t0, "program_s": time.perf_counter() - t1}
        rng = random.Random(seed)
        self.check_streams = sorted(rng.sample(range(self.c), min(self.c, traffic["check_streams"])))
        self.rows = torch.tensor(self.check_streams, device=device)
        pool = range(2, max(3, traffic["check_from"]))
        drawn = rng.sample(pool, min(len(pool), traffic["check_steps"]))
        self.check_steps = {0, 1, *drawn}
        self.kept, self.last = {}, None
        self.work = {"stream_samples": self.c * self.b * self.hop}
        self.median_bound_us = self._median_bound_us(s)

    def _median_bound_us(self, s: dict) -> float:
        """K1 over the history ++ the fresh rows, K2 over the fresh rows'
        half spectra (reflect: the full spectrum's wrap)."""
        bins, h = 2 * self.hop + 1, self.stage.history
        item = 2 if s["stream_state"] == "bf16" else 4
        k1 = roofline.time_bound((self.c, h, bins), (self.c, self.b, bins),
                                 self.stage.time_taps, h, item)[0]
        k2 = roofline.freq_bound((self.c * self.b, bins), self.stage.freq_taps, "reflect", item)[0]
        return k1 + k2

    def block(self, i: int) -> torch.Tensor:
        p = (i * self.b) % self.period
        return self.bank[:, p : p + self.b]

    def call(self, i: int) -> torch.Tensor:
        return self.sep.process_block(self.block(i))

    def keep(self, i: int, out: torch.Tensor) -> None:
        rows = out.index_select(0, self.rows)  # the compared streams' rows alone
        if i in self.check_steps:
            self.kept[i] = rows
        self.last = (i, rows)

    def release(self) -> None:
        del self.sep

    def _chunks(self, steps: list) -> torch.Tensor:
        """[steps x streams, warm + B, hop]: each compared stream's audio
        over the warm hops before a step and the step's own, silence
        before the stream's start."""
        warm = self.warm
        hops = torch.tensor([[n * self.b - warm + j for j in range(warm + self.b)] for n in steps],
                            device=self.device)
        idx = torch.remainder(hops, self.period)[:, None, :].expand(-1, len(self.rows), -1)
        rows = self.rows[None, :, None].expand(len(steps), -1, hops.shape[1])
        chunks = self.bank[rows, idx]
        return torch.where((hops >= 0)[:, None, :, None], chunks, 0.0).flatten(0, 1)

    @property
    def warm(self) -> int:
        return math.ceil((self.stage.history + 3) / self.b) * self.b

    def check(self) -> dict:
        """The stem gap of every compared (stream, step): |got - ref| / |mix|
        over the step's samples, as its median and its worst."""
        kept = dict(self.kept)
        kept[self.last[0]] = self.last[1]
        steps = sorted(kept)
        chunks = self._chunks(steps)
        ref = hpr.causal_stream(self.stage, chunks, self.warm)
        mix = hpr.mixture(self.stage, chunks, self.warm).norm(dim=-1)
        del chunks
        gaps = []
        for row, name in enumerate(self.settings["stems"]):
            got = torch.stack([kept[n][:, row] for n in steps]).flatten(0, 1).float()
            gaps.append((got - ref[name]).norm(dim=-1) / mix)
        gap = torch.stack(gaps).amax(dim=0).cpu()
        gap = torch.where(torch.isfinite(gap), gap, torch.inf)
        return {"gap_median": float(gap.median()), "gap_worst": float(gap.max())}
