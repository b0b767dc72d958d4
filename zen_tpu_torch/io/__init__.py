"""Host-side I/O of the port: audio files over the native codecs
(``audio``) and synthetic test mixtures (``synth``)."""
