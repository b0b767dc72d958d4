"""The port's measurement instruments (counterparts of ``benches/``):

* ``hbm_pattern``: each median stage of the 512-stream step beside a
  copy with its access pattern (``ops/probe_cuda.py``);
* ``serving_bound``: the streaming block step split into its legs, in
  device time and in wall time;
* ``step_walls``: the streaming steps' host walls and device times, of
  this checkout's package or another's, for a comparison of two trees
  in one call;
* ``quality``: SI-SNR of the stems on synthetic mixtures, and the
  precision ladder's rungs against the float32 stream;
* ``headline``: ``bench.py``'s headline metric and rows, device-timed;
* ``kernels``: size sweeps of the transforms, each median route and the
  block step (``benches/kernels.py``);
* ``soak``: stream-hours through the step, finiteness and drift checked
  on the device;
* ``scaling``: samples/s against shard count, and the one-card streams
  curve;
* ``io_codec``: the native codecs' host throughput.

All but ``step_walls`` run as ``python -m zen_tpu_torch.benches.<name>``
(``--device cpu`` on a machine without a card) and from
``chip_smoke.py`` in-process; ``step_walls`` runs as a file, on the card.
"""

import json
from pathlib import Path

import torch

ARTIFACT_DIR = Path(__file__).resolve().parents[2] / "build" / "zen_tpu_torch"


def platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def describe_device(device: torch.device) -> dict:
    """What a result names as the device it ran on: the chip contract's
    keys, platform 'gpu' or 'cpu', the card's name, the device count."""
    on_card = device.type == "cuda"
    return {"platform": platform(device), "kind": device_kind(device),
            "count": torch.cuda.device_count() if on_card else 1}


class CallCounter:
    """Counts the calls of the functions it wraps, by key: an instrument
    reports them (timing windows included, whose lengths can vary), so
    that a caller can count the kernel launches of a run from its shapes."""

    def __init__(self):
        self.calls = {}

    def wrap(self, key: str, fn):
        self.calls.setdefault(key, 0)

        def call(*args):
            self.calls[key] += 1
            return fn(*args)

        return call


def write_artifact(result: dict, out, default_name: str) -> Path:
    """``result`` as indented JSON at ``out``, or under ARTIFACT_DIR
    (ignored by git) by default; returns the path."""
    path = Path(out) if out else ARTIFACT_DIR / default_name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return path
