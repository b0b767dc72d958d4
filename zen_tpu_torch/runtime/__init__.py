"""Host runtime of the port: the native codec and ring library
(``native``), checkpoints and the progress journal (``checkpoint``), the
live ring-buffer service (``stream``), the corpus's prefetching reader and
ordered writer (``loader``), and tracing and timing (``profiling``)."""
