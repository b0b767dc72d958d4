"""Command-line tools of the port (counterparts of ``scripts/``):

* ``fuzz_parity``: random configs against the port's numpy oracle and
  its own unsharded, unblocked and single-stream drivers;
* ``feed_wav_realtime``: a wav file through ``LiveStream`` at wall-clock
  rate;
* ``ab_reference``: the port's strict-ref stems against another
  binary's stem files, by gain-fitted SNR;
* ``parity``: how two runs of a pass are held against each other.

Each runs as ``python -m zen_tpu_torch.tools.<name>``, on the card unless
``--device cpu`` is given.
"""
