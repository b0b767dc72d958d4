"""The 95th percentile over every track of the window of the time from the call
of ``process`` to its stems complete on the card: the host's clock from the
call to the return of the wait for it (the mix's ``in_flight`` tracks on the
card at once, so the wait covers the track ahead of it too)."""
from benchmark.stats import percentile


def read(run):
    return percentile(run.latencies_ms.get("offline_track_ms", []), 95)
