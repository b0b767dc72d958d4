"""Host-side signal helpers of the port (no audio codecs yet)."""
