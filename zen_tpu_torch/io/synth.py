"""Synthetic harmonic+percussive test mixtures with ground truth.

A copy of ``zen_tpu/io/synth.py`` (numpy only): the port imports nothing
of the JAX package, and the quality instrument
(``zen_tpu_torch/benches/quality.py``) must build the very mixtures its
floors were calibrated on. Change both copies together or neither.

The reference repository's sample audio ships as git-lfs pointers, so
a fresh checkout has nothing to separate. This generator produces the
textbook HPSS decomposition (Fitzgerald 2010) deterministically:

  harmonic   — a sustained chord (optionally sawtooth-rich, with slow
               vibrato): horizontal ridges in the STFT
  percussive — short exponentially-decaying noise bursts on a beat
               grid: vertical ridges

In zen_tpu it serves `zen synth` (CLI), the demo walkthroughs in
README.md, and the quality gates (tests/test_quality.py).
"""
from __future__ import annotations

import numpy as np


def synth_mixture(
    fs: float = 44100.0,
    seconds: float = 4.0,
    chord: tuple = ((220.0, 0.5), (330.0, 0.35), (440.0, 0.25)),
    bpm: float = 120.0,
    hits_per_beat: int = 1,
    burst_ms: float = 20.0,
    burst_decay_ms: float = 4.0,
    burst_gain: float = 0.8,
    sawtooth: bool = False,
    vibrato_cents: float = 0.0,
    seed: int = 42,
):
    """Returns (harmonic, percussive, mixture) float32 arrays [L]."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)

    harm = np.zeros(n, np.float64)
    for f0, amp in chord:
        if vibrato_cents:
            dev = 2.0 ** (
                vibrato_cents / 1200.0 * np.sin(2 * np.pi * 0.8 * t)
            )
            phase = np.cumsum(2 * np.pi * f0 * dev / fs)
        else:
            phase = 2 * np.pi * f0 * t
        if sawtooth:
            for k in range(1, 9):
                harm += amp * np.sin(k * phase) / k
        else:
            harm += amp * np.sin(phase)

    perc = np.zeros(n, np.float64)
    period = int(fs * 60.0 / (bpm * max(1, hits_per_beat)))
    if period < 1:
        raise ValueError(
            f"bpm*hits_per_beat = {bpm * hits_per_beat:.0f} exceeds the "
            f"sample rate ({fs:.0f} Hz): zero samples per hit"
        )
    burst = int(burst_ms * 1e-3 * fs)
    env = np.exp(-np.arange(burst) / (burst_decay_ms * 1e-3 * fs))
    for s in range(0, n - burst, period):
        perc[s : s + burst] += burst_gain * env * rng.standard_normal(burst)

    harm = harm.astype(np.float32)
    perc = perc.astype(np.float32)
    return harm, perc, harm + perc


def make_quality_mixture(fs: float = 22050.0, dur: float = 2.0, seed: int = 42):
    """The quality-gate mixture (tests/test_quality.py, benches/
    quality.py): sustained sine chord + decaying noise bursts every
    0.25 s. Returns (harm, perc, mix) float32 [L]."""
    n = int(fs * dur)
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    harm = sum(
        a * np.sin(2 * np.pi * f0 * t)
        for f0, a in ((220.0, 0.5), (330.0, 0.35), (440.0, 0.25))
    ).astype(np.float32)
    perc = np.zeros(n, np.float32)
    period, burst = int(0.25 * fs), int(0.02 * fs)
    env = np.exp(-np.arange(burst) / (0.004 * fs)).astype(np.float32)
    for s in range(0, n - burst, period):
        perc[s : s + burst] += 0.8 * env * rng.standard_normal(burst).astype(
            np.float32
        )
    return harm, perc, harm + perc


def make_hard_mixture(fs: float = 22050.0, dur: float = 2.0, seed: int = 7):
    """Richer signals where HPSS quality actually differentiates
    (VERDICT r1 weak #8): inharmonic piano-like partials with vibrato
    and decay (stretched, frequency-modulated horizontal structure),
    tempo-drifting percussive bursts (accelerando 100->160 bpm, so
    burst positions never align with a fixed grid), and a sustained
    cymbal-like wash (bandpassed decaying noise — neither horizontal
    nor vertical energy). Returns (harm, perc, cym, mix).

    Canonical construction shared by tests/test_quality.py (the gates)
    and benches/quality.py (the per-round trend artifact): changing it
    invalidates the trend line AND trips the calibrated test floors —
    which is the point."""
    n = int(fs * dur)
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)

    f0, B = 185.0, 0.0008  # inharmonicity: f_m = m f0 sqrt(1 + B m^2)
    vib = 1.0 + 0.004 * np.sin(2 * np.pi * 5.0 * t)
    harm = np.zeros(n)
    for m in range(1, 9):
        fm = f0 * m * np.sqrt(1 + B * m * m)
        phase = 2 * np.pi * np.cumsum(fm * vib) / fs
        harm += (0.5 / m) * np.sin(phase) * np.exp(-t / 1.6)
    harm = harm.astype(np.float32)

    perc = np.zeros(n, np.float32)
    burst = int(0.02 * fs)
    env = np.exp(-np.arange(burst) / (0.004 * fs)).astype(np.float32)
    bpm, pos = 100.0, 0.0
    while pos < dur - 0.05:
        s = int(pos * fs)
        perc[s : s + burst] += 0.8 * env * rng.standard_normal(
            burst
        ).astype(np.float32)
        bpm += 6.0
        pos += 60.0 / bpm

    wn = rng.standard_normal(n)
    spec = np.fft.rfft(wn)
    freqs = np.fft.rfftfreq(n, 1 / fs)
    cym = np.fft.irfft(
        spec * ((freqs > 3000) & (freqs < 9000)), n
    ).astype(np.float32)
    cym *= np.exp(-t / 1.2).astype(np.float32)
    cym *= 0.25 / max(np.abs(cym).max(), 1e-9)
    return harm, perc, cym, (harm + perc + cym).astype(np.float32)


def si_snr(ref, est) -> float:
    """Standard scale-invariant SDR (Le Roux et al. 2019): project the
    ESTIMATE onto the reference; 10log10(||s_t||^2/||e||^2) with
    s_t = (<est,ref>/||ref||^2) ref."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    a = np.dot(est, ref) / max(np.dot(ref, ref), 1e-30)
    s_t = a * ref
    e = est - s_t
    return 10 * np.log10(
        max(np.dot(s_t, s_t), 1e-30) / max(np.dot(e, e), 1e-30)
    )
