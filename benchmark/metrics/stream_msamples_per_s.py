"""Samples of every stream in every step completed in the window, in millions,
over the window's wall time."""
from benchmark.stats import rate


def read(run):
    value = rate(run.work.get("stream_samples"), run.window_s)
    return None if value is None else value / 1e6
