"""The 95th percentile over every step of the window of the time from the call
of ``process_block`` to its outputs complete on the card: the host's clock
from the call to the return of a synchronize."""
from benchmark.stats import percentile


def read(run):
    return percentile(run.latencies_ms.get("stream_step_ms", []), 95)
