"""Run one cell of the port's benchmark once, on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Refuses to run without a CUDA card, or with
fewer cards than the cell asks for (exit 2, no result). Prints the card's
name and power limit, how steady the window was and where the set-up's
seconds went, and as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; last in it ``checks``, each number compared
with its limit, which also close standard error. Exits 3, with no
result, when jax, jaxlib, flax or zen_tpu was loaded.

Every cache the run writes lies at a fixed path inside the checkout,
under ``build/``: the port's kernels in ``build/zen_tpu_torch/`` (built
on a checkout's first run), PyTorch's and CUDA's kernel caches and
Python's compiled modules in ``build/bench_cache/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX behind a library."""
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
        (CACHE / sub).mkdir(parents=True, exist_ok=True)  # torch makes no parents
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # Python's compiled modules too: where the environment turns bytecode
    # off (PYTHONDONTWRITEBYTECODE) every run would compile torch's
    # sources anew, seconds that swing from run to run
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(CACHE / "pycache")
    # the checkout's root in place of this file's folder, whose module
    # names would shadow others
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "nvidia-smi: no reading"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from benchmark import harness

    entry = harness.cell(args.workload)[0]
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {entry['name']} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_start=T_START)
    print(f"card: {_card()}", flush=True)  # read after the run: not in its set-up
    print(f"window: {json.dumps(result.pop('window'))}", flush=True)
    classes = result.pop("trace_classes", None)
    if classes:
        for name, cls in sorted(classes.items(), key=lambda kv: kv[1]):
            print(f"class {cls}: {name}", flush=True)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}, which the port must never load", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
