"""µs a unit between the CUDA events that bound the program's span ``zen.k2``
(the frequency-direction median, as float32), from the traced slice
(``benchmark/spans.py``); a track's two passes together."""
from benchmark.spans import span_us

read = span_us("zen.k2")
