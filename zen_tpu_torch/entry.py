"""The port's flagship entry points (counterpart of
``__graft_entry__.py``): the flagship step, and a dry run of every
sharded path over a mesh.

``entry(device="cuda")`` gives the flagship step as ``(fn,
example_args)``: the causal streaming block step at the hop-1024 sweet
spot (44.1 kHz, every stem, 32 hops a call). ``fn(state, block)`` is
``drivers.realtime.block_step`` over an explicit ``StreamState``, which
it updates in place (zen_tpu's step donates its state), and returns
``(state, outs [3, 32 * 1024])`` as zen_tpu's ``_block_step_body`` does.

``dryrun_multichip(n, device="cuda")`` runs the sharded two-pass
pipeline over every dp x sp factorization of n on tiny shapes, the
three-axis mesh when n % 8 == 0, frequency TP at the largest valid
width, ``MultiStreamHPR`` over a dp mesh, and the sp blocked scan with
and without mid-track checkpoints. Its mesh repeats ``device`` n times
(on one card, virtual shards that run one after another). The stems of every factorization are held
against the first one's: bitwise on the CPU (and wherever they are
bitwise); on the card, where cuFFT's bits depend on a batch's row count,
otherwise under the flip rule (``tools/parity.py``), pass by pass. The
summary line says which rule held each. Both run on the card unless
``device="cpu"`` is passed, and never fall back to the CPU.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .benches import ARTIFACT_DIR
from .device import resolve_device
from .drivers.realtime import MultiStreamHPR, block_step, init_state
from .engine.config import OUTPUT_ALL, OUTPUT_PERCUSSIVE, OUTPUT_RESIDUAL, HPRConfig
from .engine.spectral import STEMS
from .errors import ZenError
from .parallel.mesh import make_mesh
from .parallel.sharded import (
    sharded_hpri_offline,
    sharded_pass_masks,
    sharded_separate_blocked,
    sharded_separate_blocked_checkpointed,
    tp_separate,
)
from .tools.parity import bitwise, flip_rule

ENTRY_FS, ENTRY_HOP, ENTRY_BLOCK_HOPS = 44100.0, 1024, 32


def entry_config() -> HPRConfig:
    return HPRConfig(fs=ENTRY_FS, hop=ENTRY_HOP, beta=2.0, causal=True, outputs=OUTPUT_ALL)


def entry(device="cuda"):
    """(fn, example_args) of the flagship step (module note), on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    cfg = entry_config()

    def fn(state, block):
        outs = block_step(cfg, state, block.reshape(1, -1, cfg.hop))
        return state, outs[0]

    state = init_state(cfg, 1, dev)
    block = torch.zeros((ENTRY_BLOCK_HOPS, cfg.hop), device=dev)
    return fn, (state, block)


def _factorizations(n: int) -> list:
    """Every (dp, sp) with dp a power of two dividing n, as zen_tpu's."""
    out, dp = [], 1
    while dp <= n:
        if n % dp == 0:
            out.append((dp, n // dp))
        dp *= 2
    return out


def _hold_cascade(audio, cfgs: tuple, mesh, ref_mesh, what: str) -> dict:
    """The flip rule pass by pass between the cascades on ``mesh`` and
    ``ref_mesh``: pass 1 on ``audio``, pass 2 on the reference's
    intermediate on both sides (pass-1 flips do not cascade)."""
    worst = {"flips": 0, "share": 0.0, "excluded": 0, "rel_err": 0.0}
    for cfg in cfgs:
        got, m_got = sharded_pass_masks(audio, cfg, mesh)
        want, m_want = sharded_pass_masks(audio, cfg, ref_mesh)
        st = flip_rule(got, want, m_got, m_want, cfg.hop, what=f"{what} hop {cfg.hop}")
        worst = {k: max(worst[k], st[k]) for k in worst}
        audio = want["percussive"] + want["residual"]
    return worst


def dryrun_configs() -> tuple:
    """(pass 1, pass 2, TP, stream) configs of the dry run: zen_tpu's tiny
    shapes (fs 1000, hops 16 and 8; fs 8000, hop 16)."""
    common = dict(fs=1000.0, beta=2.0, causal=False)
    return (HPRConfig(hop=16, outputs=OUTPUT_ALL, **common),
            HPRConfig(hop=8, outputs=OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL, **common),
            HPRConfig(fs=8000.0, hop=16, causal=False, outputs=OUTPUT_ALL),
            HPRConfig(fs=8000.0, hop=16, causal=True, outputs=OUTPUT_ALL))


def dryrun_tp_width(n_devices: int) -> int:
    """The largest power-of-two TP width up to n that divides the TP
    config's nfft and leaves each shard the fm-bin halo."""
    cfg_tp = dryrun_configs()[2]
    fm = max(1, cfg_tp.freq_filter_len // 2)
    n_tp = 1
    while (n_tp * 2 <= n_devices and cfg_tp.nfft % (n_tp * 2) == 0
           and cfg_tp.nfft // (n_tp * 2) >= fm):
        n_tp *= 2
    return n_tp


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """The sharded dry run (module note); returns its summary line, which
    it also prints. Raises on any disagreement."""
    dev = resolve_device(device)
    devs = [dev] * n_devices
    on_card = dev.type == "cuda"

    def mesh_of(axes):
        size = int(np.prod(list(axes.values())))
        return make_mesh(axes, devices=devs[:size])

    cfg_h, cfg_p, cfg_tp, cfg_stream = dryrun_configs()
    hop_p = cfg_p.hop
    factorizations = _factorizations(n_devices)
    max_sp = max(sp for _, sp in factorizations)
    # every sp shard longer than the halo, at a channel count every dp divides
    length = hop_p * (cfg_p.stft_width + 2) * max_sp * 2
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        rng.standard_normal((n_devices, length)).astype(np.float32)).to(devs[0])
    ref, ref_mesh, rules = None, None, []
    for dp, sp in factorizations:
        mesh = mesh_of({"dp": dp, "sp": sp})
        got = dict(zip(STEMS, sharded_hpri_offline(audio, cfg_h, cfg_p, mesh)))
        for k, v in got.items():
            if v.shape != audio.shape or not bool(torch.isfinite(v).all()):
                raise ZenError(f"dryrun dp={dp} sp={sp} {k}: stems {tuple(v.shape)}")
        if ref is None:
            ref, ref_mesh = got, mesh
            continue
        if bitwise(got, ref):
            rules.append("bitwise")
        elif not on_card:
            raise ZenError(f"dryrun dp={dp} sp={sp}: stems differ from dp={factorizations[0][0]} "
                           f"sp={factorizations[0][1]} on the CPU")
        else:
            st = _hold_cascade(audio, (cfg_h, cfg_p), mesh, ref_mesh, f"dryrun dp={dp} sp={sp}")
            rules.append(f"flip rule ({st['flips']} flips, {st['rel_err']:.3g} x scale)")

    combined = ""
    if n_devices % 8 == 0:
        # the combined mesh: dp x sp with a tp axis beside them
        mesh3 = mesh_of({"dp": 2, "sp": 2, "tp": n_devices // 4})
        got = dict(zip(STEMS, sharded_hpri_offline(audio[:2], cfg_h, cfg_p, mesh3)))
        sub = {k: v[:2] for k, v in ref.items()}
        if bitwise(got, sub):
            rule = "bitwise"
        elif not on_card:
            raise ZenError("dryrun combined dp x sp x tp mesh: stems differ on the CPU")
        else:
            st = _hold_cascade(audio[:2], (cfg_h, cfg_p), mesh3, ref_mesh, "dryrun combined")
            rule = f"flip rule ({st['flips']} flips)"
        tp3 = tp_separate(audio[0][:800], cfg_tp, mesh3)
        _finite(tp3, "dryrun combined tp")
        combined = f" + combined dp=2 x sp=2 x tp={n_devices // 4} mesh ({rule})"

    # frequency TP at the largest power-of-two width that divides nfft and
    # leaves each shard the fm-bin halo
    n_tp = dryrun_tp_width(n_devices)
    _finite(tp_separate(audio[0][:800], cfg_tp, mesh_of({"tp": n_tp})), f"dryrun tp={n_tp}")

    # the serving path over a pure dp mesh: state and blocks split on streams
    ms = MultiStreamHPR(2 * n_devices, fs=cfg_stream.fs, hop=cfg_stream.hop,
                        mesh=mesh_of({"dp": n_devices}))
    blocks = torch.from_numpy(
        rng.standard_normal((2 * n_devices, 4, 16)).astype(np.float32)).to(devs[0])
    outs = [ms.process_block(blocks) for _ in range(2)]  # the second carries the state
    for o in outs:
        if o.shape != (2 * n_devices, 3, 4 * 16) or not bool(torch.isfinite(o).all()):
            raise ZenError(f"dryrun stream dp={n_devices}: outputs {tuple(o.shape)}")

    # the long-track path: the sp blocked scan, and its checkpointed form
    sp_mesh = mesh_of({"sp": n_devices})
    blk = sharded_separate_blocked(audio[0], cfg_h, sp_mesh, block_frames=8)
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ARTIFACT_DIR) as ckdir:
        blk_ck = sharded_separate_blocked_checkpointed(
            audio[0], cfg_h, sp_mesh, block_frames=8, ckpt_dir=ckdir, ckpt_every_blocks=2)
    if not bitwise(blk, blk_ck):
        raise ZenError("dryrun: the checkpointed sp blocked scan differs from the plain one")

    virtual = " (virtual: one device repeated)" if n_devices > 1 else ""
    line = (f"dryrun_multichip ok on {n_devices} shards of {dev}{virtual}: dp x sp sweep "
            f"{factorizations} against {factorizations[0]}: "
            f"{', '.join(rules) or 'one factorization'}{combined} + tp={n_tp} + stream "
            f"dp={n_devices} + blocked sp={n_devices} (+ checkpointed, bitwise), stems "
            f"{tuple(ref['harmonic'].shape)}")
    print(line, flush=True)
    return line


def _finite(stems: dict, what: str) -> None:
    for k, v in stems.items():
        if not bool(torch.isfinite(v).all()):
            raise ZenError(f"{what} {k}: non-finite samples")
