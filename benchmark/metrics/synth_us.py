"""µs a unit between the CUDA events that bound the program's span
``zen.synth`` (the masked inverse transforms, with the stack of the step's
live masks), from the traced slice (``benchmark/spans.py``); a track's two
passes together."""
from benchmark.spans import span_us

read = span_us("zen.synth")
