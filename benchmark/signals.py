"""Seeded test audio, made on the device in a few large calls.

Each row is a recording-like mix: two harmonic tones (f0 and 2 f0, f0
drawn per row from 110-440 Hz, random phases), decaying noise bursts
every 0.5 s from a per-row onset (400 samples, time constant 60
samples), and a white noise floor at 0.01 (-40 dBFS), which keeps every
bin of a frame above FFT round-off. The same signal as the port's
4-minute track bench (tones, bursts every 0.5 s, the 0.01 floor), drawn
per row so that rows differ.
"""
from __future__ import annotations

import math

import torch

BURST_PERIOD_S = 0.5
BURST_LEN = 400
BURST_DECAY = 60.0
NOISE_FLOOR = 0.01


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on ``device``, seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


CHUNK_ELEMS = 1 << 26  # samples made at once (float64 temporaries of 512 MB)


def mix(rows: int, n: int, fs: float, gen: torch.Generator, device) -> torch.Tensor:
    """[rows, n] float32 audio on ``device`` from ``gen``, made in chunks of rows."""
    per = max(1, CHUNK_ELEMS // n)
    return torch.cat([_mix(min(per, rows - lo), n, fs, gen, device) for lo in range(0, rows, per)])


def _mix(rows: int, n: int, fs: float, gen: torch.Generator, device) -> torch.Tensor:
    params = torch.rand((rows, 4), generator=gen, device=device, dtype=torch.float64)
    f0 = 110.0 * 4.0 ** params[:, :1]  # 110-440 Hz
    phase = 2 * math.pi * params[:, 1:3]
    onset = (params[:, 3:] * BURST_PERIOD_S * fs).floor()
    t = torch.arange(n, device=device, dtype=torch.float64)[None]
    w = 2 * math.pi * f0 / fs * t
    out = (0.5 * torch.sin(w + phase[:, :1]) + 0.3 * torch.sin(2 * w + phase[:, 1:])).float()
    del w
    since = torch.remainder(t - onset, round(BURST_PERIOD_S * fs))
    env = torch.where(since < BURST_LEN, torch.exp(-since / BURST_DECAY), 0.0).float()
    del since, t
    noise = torch.randn((2, rows, n), generator=gen, device=device)
    out += noise[0] * env + NOISE_FLOOR * noise[1]
    return out
