"""Device µs per unit of work in every other kernel: the medians (the median class of
``benchmark/tracing.py``), from the traced slice."""
from benchmark.tracing import class_us

read = class_us("median")
