"""µs a unit between the CUDA events that bound the program's span
``zen.advance`` (the streaming state moved past the step: the history and
the ring), from the traced slice (``benchmark/spans.py``)."""
from benchmark.spans import span_us

read = span_us("zen.advance")
