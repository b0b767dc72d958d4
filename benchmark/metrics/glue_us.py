"""Device µs per unit of work in ATen's kernels and the copies (the glue class of
``benchmark/tracing.py``), from the traced slice."""
from benchmark.tracing import class_us

read = class_us("glue")
