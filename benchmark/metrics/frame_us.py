"""µs a unit between the CUDA events that bound the program's span
``zen.frame`` (the framing: the step's ring ++ block and frame cats, each
pass's ``frame_signal``), from the traced slice (``benchmark/spans.py``); a
track's two passes together."""
from benchmark.spans import span_us

read = span_us("zen.frame")
