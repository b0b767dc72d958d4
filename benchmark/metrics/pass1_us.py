"""µs a track between the CUDA events that bound the program's span
``zen.pass1`` (the first, large-hop pass of ``HPRIOffline.process``), from
the traced slice (``benchmark/spans.py``)."""
from benchmark.spans import span_us

read = span_us("zen.pass1")
