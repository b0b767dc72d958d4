"""µs a unit between the CUDA events that bound the program's span ``zen.ola``
(the overlap-add: the carried tails, the chunk sums, the cut to length),
from the traced slice (``benchmark/spans.py``); a track's two passes
together."""
from benchmark.spans import span_us

read = span_us("zen.ola")
