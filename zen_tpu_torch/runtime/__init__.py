"""Host runtime of the port: tracing and timing (``profiling``)."""
