"""A cell, a configuration, a traffic loop and a metric added as new files,
with entries in BENCHMARK.json, are found by name in a copy of the
benchmark: no file that is there is edited."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TONE_LOOP = '''
import torch


class Loop:
    latency = "tone_ms"

    def __init__(self, config, traffic, seed, device, control=False):
        g = torch.Generator().manual_seed(seed)
        self.x = torch.randn((traffic["rows"], config["settings"]["n"]), generator=g)
        self.work = {"tone_rows": traffic["rows"]}
        self.median_bound_us = None
        self.setup_parts = {}
        self.kept = None

    def call(self, i):
        return torch.fft.rfft(self.x).abs()

    def keep(self, i, out):
        self.kept = out

    def release(self):
        del self.x

    def check(self):
        return {"gap_median": float(self.kept.isnan().sum())}
'''

ROWS_METRIC = '''
def read(run):
    total = run.work.get("tone_rows")
    return None if total is None else total / run.window_s
'''


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def _add(dst: Path) -> list:
    """New files and entries only; returns the files that were there."""
    before = sorted(p.relative_to(dst) for p in dst.rglob("*") if p.is_file())
    b = dst / "benchmark"
    (b / "loops" / "tone.py").write_text(TONE_LOOP)
    (b / "metrics" / "tone_rows_per_s.py").write_text(ROWS_METRIC)
    (b / "configs" / "tone-4096.json").write_text(json.dumps(
        {"name": "tone-4096", "settings": {"n": 4096}, "limits": {"gap_median": 0.0}}))
    (b / "traffic" / "closed-rows8.json").write_text(json.dumps({"loop": "tone", "rows": 8}))
    fleet = json.loads((b / "configs" / "fleet-hop256.json").read_text())
    fleet["name"] = "fleet-hop512"
    fleet["settings"]["hop"] = 512
    (b / "configs" / "fleet-hop512.json").write_text(json.dumps(fleet))
    (b / "traffic" / "closed-3x4.json").write_text(json.dumps(
        {"loop": "fleet", "streams": 3, "block_hops": 4, "bank_seconds": 0.4,
         "check_streams": 3, "check_steps": 2, "check_from": 6}))
    man = json.loads((dst / "BENCHMARK.json").read_text())
    man["workloads"] += [
        {"name": "tone-rows8", "config": "tone-4096", "traffic": "closed-rows8", "chips": 1,
         "why": "a test cell"},
        {"name": "fleet-3x4-hop512", "config": "fleet-hop512", "traffic": "closed-3x4",
         "chips": 1, "why": "a test cell"}]
    man["end_to_end"].append({"name": "tone_rows_per_s", "unit": "rows/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock", "workloads": ["tone-rows8"]})
    man["end_to_end"][0]["workloads"].append("fleet-3x4-hop512")
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    return before


def _execute(dst: Path, workload: str) -> dict:
    script = textwrap.dedent(f"""
        import json, sys
        from benchmark import harness
        assert harness.__file__.startswith({str(dst)!r})
        r = harness.execute({workload!r}, 7, 0.2, False, device="cpu")
        print(json.dumps(r))
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(dst), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", script], cwd=dst, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_found_by_name(tmp_path):
    dst = _copy(tmp_path)
    before = _add(dst)
    for rel in before:
        if rel.name != "BENCHMARK.json":
            assert (dst / rel).read_bytes() == (ROOT / rel).read_bytes()
    tone = _execute(dst, "tone-rows8")
    assert tone["correct"] is True
    assert set(tone["metrics"]) == {"tone_rows_per_s", "setup_s"}
    assert tone["metrics"]["tone_rows_per_s"]["unit"] == "rows/s"
    fleet = _execute(dst, "fleet-3x4-hop512")
    assert fleet["correct"] is True, fleet["checks"]
    assert set(fleet["metrics"]) == {"stream_msamples_per_s", "setup_s"}
