"""Seconds of audio of every track completed in the window over the window's
wall time."""
from benchmark.stats import rate


def read(run):
    return rate(run.work.get("offline_audio_s"), run.window_s)
