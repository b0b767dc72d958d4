"""The port's measurement instruments (counterparts of ``benches/``):

* ``hbm_pattern``: each median stage of the 512-stream step beside a
  copy with its access pattern (``ops/probe_cuda.py``);
* ``serving_bound``: the streaming block step split into its legs, in
  device time and in wall time;
* ``step_walls``: the streaming steps' host walls and device times, of
  this checkout's package or another's, for a comparison of two trees
  in one call;
* ``quality``: SI-SNR of the stems on synthetic mixtures, and the
  precision ladder's rungs against the float32 stream.

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


def write_artifact(result: dict, out, default_name: str) -> Path:
    """``result`` as indented JSON at ``out``, or under ARTIFACT_DIR
    (ignored by git) by default; returns the path."""
    path = Path(out) if out else ARTIFACT_DIR / default_name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return path
