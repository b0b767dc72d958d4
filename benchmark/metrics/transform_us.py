"""Device µs per unit of work in cuFFT's kernels (the transform class of
``benchmark/tracing.py``), from the traced slice."""
from benchmark.tracing import class_us

read = class_us("transform")
