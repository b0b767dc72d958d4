"""Kernel microbenchmark sweep of the port (counterpart of
``benches/kernels.py``, the google-benchmark analog).

    python -m zen_tpu_torch.benches.kernels [--csv out.csv] [--quick] [--device cuda]

Size sweeps 2^5..2^14 over the hot ops, each ``_NOMEM`` (device-resident;
on the card ``runtime.profiling.device_ms``, the card's time) and, at a
few sizes, ``_MEM`` (a fresh host buffer uploaded, the op, the result read
back: host wall per call), with a ``Complexity()`` fit per op (the
least-squares exponent of time against size):

  fft_roundtrip         torch.fft rfft then irfft over [t, n] rows
  rfft_<impl>, irfft_<impl>
                        the spectral engine's transforms at nfft 1024 ..
                        8192 and 32 .. 2048 frames: torch.fft and the
                        DFT-matmul modes dft, dft_bf16, dft_f32
  fft_c2c_fwd/bwd       complex 4096-point transforms over 1024 rows
  median_freq_<route>   K2 over [t, f] rows, reflect border, at the HPR
                        K (13, 47, 187): each route that takes K by name
                        (network, rank), the plain twin, and
                        torch.kthvalue over a padded unfold (the library)
  median_time_<route>   K1's one-input form over [t, 513] rows, zero
                        border, at the paths' K (3, 11, 47, 93): each
                        route that takes K by name (register up to 63
                        taps, rank at any K), the plain twin, kthvalue
                        over gathered taps
  hpr_block_step        block_step at hop 256, 1024, 4096, 32-hop blocks

The JAX sweep's TPU-only network variants (``cse`` / ``taps``) and its
layout grid (``--serving``) are the port's routes instead: each is timed
by name through ``median_cuda._time_launch`` / ``_freq_launch``, which
count no launch; the block-step and ``_MEM`` rows go through the
wrappers, which do. The plain twins synchronize the host (their tap index is uploaded from a list), so their rows are host
wall on the card too, and say so in the ``timer`` column. On the CPU
(``--device cpu``, for tests) every row is host wall, the kernel
routes are not run, and the sweep runs at a test scale (``SCALE``). ``--csv`` writes ``name,ms`` (the JAX CSV's columns)
plus ``timer`` and ``device``; the full result goes to ``--out``
(default ``build/zen_tpu_torch/kernels.json``), with ``calls``: the calls
of each row that went through a counting wrapper (the block steps and
the ``_MEM`` medians), so a caller can count its launches.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import CallCounter, describe_device, write_artifact
from .headline import stream_chain, stream_config
from ..device import resolve_device
from ..ops import fft as zfft
from ..ops import median_cuda as mc
from ..runtime.profiling import device_ms, steady_state_ms

HPR_KS = (13, 47, 187)  # the engine's frequency K (hop 256, 1024, 4096 at 44.1 kHz)
TIME_KS = (3, 11, 47, 93)  # its time K (hop 1024, 256, 64, 32)
TIME_F = 513
DFT_IMPLS = ("torch",) + zfft.DFT_MODES
# the sweep's scale by device type: elements an FFT call covers (rows =
# elems / n; twice a frequency median's, F up to elems / 2, T up to
# elems / 256 for the time median; transforms up to nfft elems / 4 and
# elems / 512 frames), and the block-step rows' hops. The CPU's is a
# test scale: its rows are host wall, which measures nothing of the card
SCALE = {"cuda": (1 << 22, (256, 1024, 4096)), "cpu": (2048, (256,))}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.kernels")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--quick", action="store_true", help="fewer sizes and shorter windows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="artifact path (default under build/)")
    return ap.parse_args(argv)


def fit_complexity(points) -> float:
    """google-benchmark Complexity() analog: least-squares exponent of
    time against size over (n, ms) points."""
    pts = [(n, ms) for n, ms in points if ms > 0]
    if len(pts) < 3:
        return float("nan")
    b, _ = np.polyfit(np.log([p[0] for p in pts]), np.log([p[1] for p in pts]), 1)
    return float(b)


class Sweep:
    """Times rows on one device and keeps them in order."""

    def __init__(self, dev: torch.device, quick: bool, log=print):
        self.dev = dev
        self.on_card = dev.type == "cuda"
        self.iters, self.repeats = (10, 3) if quick else (20, 5)
        self.rows = []
        self.counter = CallCounter()  # calls through the counted wrappers
        self.routes = CallCounter()  # launches by route name, which no wrapper counts
        self.log = log
        self.rng = np.random.default_rng(0)

    def randn(self, *shape) -> torch.Tensor:
        return torch.from_numpy(self.rng.standard_normal(shape).astype(np.float32)).to(self.dev)

    def report(self, name: str, ms: float, timer: str) -> float:
        self.rows.append({"name": name, "ms": ms, "timer": timer})
        self.log(f"{name:<56s} {ms:10.4f} ms ({timer})")
        return ms

    def nomem(self, name: str, fn, example=None, syncs: bool = False) -> float:
        """Device ms per call of ``fn`` on the card (host wall where the
        call synchronizes the host, and on the CPU)."""
        if self.on_card and not syncs:
            return self.report(name, device_ms(fn, example, iters=self.iters,
                                               repeats=self.repeats), "device")
        return self.report(name, steady_state_ms(fn, example, iters=max(3, self.iters // 2),
                                                 warmup=2), "wall")

    def mem(self, name: str, fn, shape, iters: int = 10) -> float:
        """Host wall per call: a fresh host buffer uploaded, ``fn``, the
        result read back."""
        pool = [self.rng.standard_normal(shape).astype(np.float32) for _ in range(iters)]
        fn(torch.from_numpy(pool[0]).to(self.dev)).cpu()
        t0 = time.perf_counter()
        for x in pool:
            fn(torch.from_numpy(x).to(self.dev)).cpu()
        return self.report(name, (time.perf_counter() - t0) / iters * 1e3, "wall")


def sweep_fft(s: Sweep, quick: bool, elems: int) -> dict:
    pts = []
    for p in ((7, 10, 13) if quick else range(5, 15)):
        n = 1 << p
        t = max(1, elems // n)
        x = s.randn(t, n)
        ms = s.nomem(f"fft_roundtrip_NOMEM/{n}x{t}",
                     lambda v, n=n: torch.fft.irfft(torch.fft.rfft(v, dim=-1), n=n, dim=-1), x)
        pts.append((n, ms / t))
        if p in (8, 10, 11, 14):
            s.mem(f"fft_roundtrip_MEM/{n}x{t}",
                  lambda v, n=n: torch.fft.irfft(torch.fft.rfft(v, dim=-1), n=n, dim=-1), (t, n))
    t = max(1, elems // 4096)
    xz = torch.complex(s.randn(t, 4096), s.randn(t, 4096))
    s.nomem(f"fft_c2c_fwd_NOMEM/4096x{t}", lambda v: torch.fft.fft(v, dim=-1), xz)
    s.nomem(f"fft_c2c_bwd_NOMEM/4096x{t}", lambda v: torch.fft.ifft(v, dim=-1), xz)
    return {"fft_roundtrip": fit_complexity(pts)}


def sweep_transforms(s: Sweep, quick: bool, elems: int) -> None:
    """The engine's transforms by implementation: forward rfft of
    [frames, nwin] frames, and the inverse's first nwin samples (nfft up
    to elems / 4, frames up to elems / 512, the scale's caps)."""
    for nfft in ((1024, 4096) if quick else (1024, 2048, 4096, 8192)):
        if nfft > max(1024, elems // 4):
            continue
        nwin = nfft // 2
        for frames in ((32, 2048) if quick else (32, 256, 2048)):
            if frames > max(32, elems // 512):
                continue
            x = s.randn(frames, nwin)
            spec = zfft.rfft_forward(x, nfft)
            for impl in DFT_IMPLS:
                if impl == "torch":
                    fwd = lambda _, x=x, nfft=nfft: zfft.rfft_forward(x, nfft)  # noqa: E731
                    inv = lambda _, sp=spec, nfft=nfft, nwin=nwin: (  # noqa: E731
                        zfft.irfft(sp, nfft)[..., :nwin])
                else:
                    fwd = lambda _, x=x, nfft=nfft, m=impl: (  # noqa: E731
                        zfft.rfft_forward_dft(x, nfft, m))
                    inv = lambda _, sp=spec, nfft=nfft, nwin=nwin, m=impl: (  # noqa: E731
                        zfft.irfft_head_dft(sp, nfft, nwin, m))
                s.nomem(f"rfft_{impl}_NOMEM/n{nfft}_T{frames}", fwd, x)
                s.nomem(f"irfft_{impl}_NOMEM/n{nfft}_T{frames}", inv, x)


def _freq_library(x: torch.Tensor, k: int) -> torch.Tensor:
    m = k // 2
    return F.pad(x[None], (m, m), mode="reflect")[0].unfold(-1, k, 1).kthvalue(m + 1, -1).values


def _time_library(x: torch.Tensor, k: int) -> torch.Tensor:
    h = k // 2
    return F.pad(x, (0, 0, h, h)).unfold(-2, k, 1).kthvalue(h + 1, -1).values


def _freq_routes(k: int) -> list:
    return (["network"] if k <= mc.FREQ_NETWORK_MAX_TAPS else []) + ["rank"]


def _time_routes(offsets: tuple) -> list:
    return (["register"] if len(offsets) <= mc.REGISTER_TAPS
            else ["warp"] if mc.time_warp_slots(len(offsets)) else []) + ["rank"]


def _mem_point(ps: list) -> int:
    """The sweep point of a median's _MEM row: 2^11, or the largest point
    below it that the scale keeps."""
    return max((p for p in ps if p <= 11), default=None)


def sweep_medians(s: Sweep, quick: bool, elems: int) -> dict:
    fits = {}
    for k in HPR_KS:
        pts = {}
        # odd bin counts, like nfft / 2 + 1
        ps = [p for p in (range(7, 15, 2) if quick else range(5, 15))
              if k < (1 << p) + 1 <= max(129, elems // 2)]
        for p in ps:
            f = (1 << p) + 1
            t = max(8, min(4096, elems // 2 // f))
            x = s.randn(t, f).abs()
            shape = f"K{k}_{t}x{f}"
            if s.on_card:
                for route in _freq_routes(k):
                    name = f"median_freq_{route}_NOMEM/{shape}"
                    ms = s.nomem(name, s.routes.wrap(
                        name, lambda _, x=x, k=k, r=route: mc._freq_launch(x, k, "reflect", r)),
                        x)
                    pts.setdefault(route, []).append((f, ms / t))
            s.nomem(f"median_freq_plain_NOMEM/{shape}",
                    lambda _, x=x, k=k: mc.sliding_median_boundary_plain(x, k, "reflect"), x,
                    syncs=True)
            s.nomem(f"median_freq_library_NOMEM/{shape}", lambda _, x=x, k=k: _freq_library(x, k),
                    x)
            if p == _mem_point(ps):
                name = f"median_freq_MEM/{shape}"
                s.mem(name, s.counter.wrap(name, lambda v, k=k: mc.sliding_median_boundary(
                    v.abs(), k, "reflect")), (t, f))
        for route, rp in pts.items():
            fits[f"median_freq_{route}_K{k}"] = fit_complexity(rp)
    for k in TIME_KS:
        offsets = tuple(range(-(k // 2), k // 2 + 1))
        pts = {}
        ps = [p for p in ((8, 11, 14) if quick else range(5, 15))
              if 1 << p <= max(256, elems // 256)]
        for p in ps:
            t = 1 << p
            x = s.randn(t, TIME_F).abs()
            shape = f"K{k}_{t}x{TIME_F}"
            if s.on_card:
                for route in _time_routes(offsets):
                    name = f"median_time_{route}_NOMEM/{shape}"
                    ms = s.nomem(name, s.routes.wrap(
                        name, lambda _, x=x, o=offsets, r=route: mc._time_launch(
                            x, x[:0], o, 0, 0.0, r)), x)
                    pts.setdefault(route, []).append((t, ms))
            s.nomem(f"median_time_plain_NOMEM/{shape}",
                    lambda _, x=x, o=offsets: mc.tap_median_time_plain(x, x[:0], o, 0), x,
                    syncs=True)
            s.nomem(f"median_time_library_NOMEM/{shape}", lambda _, x=x, k=k: _time_library(x, k),
                    x)
            if p == _mem_point(ps):
                name = f"median_time_MEM/{shape}"
                s.mem(name, s.counter.wrap(name, lambda v, o=offsets: mc.tap_median_time(
                    v.abs(), v[:0], o, 0)), (t, TIME_F))
        for route, rp in pts.items():
            fits[f"median_time_{route}_K{k}"] = fit_complexity(rp)
    return fits


def sweep_block_step(s: Sweep, hops) -> None:
    for hop in hops:
        cfg = stream_config(44100.0, hop)
        fn, example = stream_chain(cfg, 1, 32, s.dev, seed=0)
        name = f"hpr_block_step_NOMEM/hop{hop}x32"
        s.nomem(name, s.counter.wrap(name, fn), example)


def run(args: argparse.Namespace, log=print) -> dict:
    dev = resolve_device(args.device)
    s = Sweep(dev, args.quick, log)
    log(f"device: {describe_device(dev)}")
    elems, hops = SCALE[dev.type]
    fits = sweep_fft(s, args.quick, elems)
    sweep_transforms(s, args.quick, elems)
    fits.update(sweep_medians(s, args.quick, elems))
    sweep_block_step(s, hops)
    for name, b in fits.items():
        log(f"complexity fit {name}: t ~ n^{b:.2f}")
    return {"device": describe_device(dev), "quick": args.quick, "rows": s.rows,
            "complexity": fits, "calls": s.counter.calls, "route_calls": s.routes.calls}


def write_csv(path, result: dict) -> None:
    kind = result["device"]["kind"]
    with open(path, "w") as fh:
        fh.write("name,ms,timer,device\n")
        for row in result["rows"]:
            fh.write(f"{row['name']},{row['ms']},{row['timer']},{kind}\n")


def main(argv=None) -> dict:
    args = parse(argv)
    result = run(args)
    if args.csv:
        write_csv(args.csv, result)
        print(f"wrote {args.csv}")
    path = write_artifact(result, args.out, "kernels.json")
    print(f"wrote {path}", file=sys.stderr)
    print(json.dumps({"metric": "kernels_sweep", "rows": len(result["rows"]),
                      "device": result["device"]}))
    return result


if __name__ == "__main__":
    main()
