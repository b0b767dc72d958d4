"""µs a unit between the CUDA events that bound the program's span
``zen.analyze`` (the window, the transform, |S| and the feature), from the
traced slice (``benchmark/spans.py``); a track's two passes together."""
from benchmark.spans import span_us

read = span_us("zen.analyze")
