"""Whole tracks through the two-pass HPR-I: ``HPRIOffline.process``.

Traffic keys: ``track_seconds``, ``tracks`` (distinct tracks in the
bank, taken in turn), ``check_tracks`` (calls the check compares: the
first, and others drawn from the seed below ``check_from``),
``check_segment_s`` (the stretch of a stem that is one compared answer).

Set-up makes the bank of tracks on the card from the seed and warms the
entry on the first, as many calls at once as the mix's ``in_flight``;
each call separates one track that already lies on the card, and its
stems stay there.
"""
from __future__ import annotations

import math
import random
import time

import torch

from benchmark import roofline, signals
from benchmark.reference import hpr


class Loop:
    latency = "offline_track_ms"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 control: bool = False):
        from zen_tpu_torch.drivers.offline import HPRIOffline

        s = {**config["settings"], **(config["control"] if control else {})}
        self.settings, self.device = s, device
        self.length = round(traffic["track_seconds"] * s["fs"])
        t0 = time.perf_counter()
        self.bank = signals.mix(traffic["tracks"], self.length, s["fs"],
                                signals.generator(seed, device), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        program = {k: s[k] for k in ("border", "fft_impl") if k in s}
        self.sep = HPRIOffline(s["fs"], s["hop_h"], s["hop_p"], s["beta_h"], s["beta_p"],
                               device=device, **program)
        # as many calls as the window keeps on the card at once, their
        # stems held, so that the window allocates nothing new
        warm = [self.sep.process(self.bank[0]) for _ in range(int(traffic.get("in_flight", 1)))]
        del warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_parts = {"bank_s": t1 - t0, "program_s": time.perf_counter() - t1}
        rng = random.Random(seed)
        pool = range(1, max(2, traffic["check_from"]))
        self.check_calls = {0, *rng.sample(pool, min(len(pool), traffic["check_tracks"] - 1))}
        self.kept = {}
        self.segment = round(traffic["check_segment_s"] * s["fs"])
        self.work = {"offline_audio_s": self.length / s["fs"]}
        self.median_bound_us = self._median_bound_us(s)

    def _median_bound_us(self, s: dict) -> float:
        """Each pass: K1 over all of its frames (the centred window reaches
        every row) and K2 over their half spectra (reflect)."""
        total = 0.0
        for hop, beta in ((s["hop_h"], s["beta_h"]), (s["hop_p"], s["beta_p"])):
            st = hpr.Stage(s["fs"], hop, beta, False, hpr.STEMS, s["border"])
            frames = math.ceil(self.length / st.hop) + st.lag
            shape = (frames, 2 * st.hop + 1)
            total += roofline.time_bound(shape, (0, shape[1]), st.time_taps, 0, 4)[0]
            total += roofline.freq_bound(shape, st.freq_taps, "reflect", 4)[0]
        return total

    def call(self, i: int):
        return self.sep.process(self.bank[i % self.bank.shape[0]])

    def keep(self, i: int, out) -> None:
        if i in self.check_calls:
            self.kept[i] = out

    def release(self) -> None:
        del self.sep

    def _segments(self, x: torch.Tensor) -> torch.Tensor:
        """The norm of each segment of x [L] (the last one short)."""
        pad = -x.shape[-1] % self.segment
        return torch.nn.functional.pad(x, (0, pad)).view(-1, self.segment).norm(dim=-1)

    def check(self) -> dict:
        """The stem gap of every segment of every stem of the compared
        tracks, |got - ref| / |mix| over the segment (mix: the reference's
        three stems summed), as its median and its worst."""
        s, gaps = self.settings, []
        for i, stems in sorted(self.kept.items()):
            ref = hpr.hpri_offline(s["fs"], s["hop_h"], s["hop_p"], s["beta_h"], s["beta_p"],
                                   self.bank[i % self.bank.shape[0]])
            mix = self._segments(sum(ref.values()))
            for got, name in zip(stems, hpr.STEMS):
                gaps.append(self._segments(got - ref[name]) / mix)
            del ref
        gap = torch.cat(gaps).cpu()
        gap = torch.where(torch.isfinite(gap), gap, torch.inf)
        return {"gap_median": float(gap.median()), "gap_worst": float(gap.max())}
