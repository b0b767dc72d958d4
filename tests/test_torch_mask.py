"""The mask-and-apply seam on the CPU: ``engine.spectral.masked_spectra``
and ``ops/mask_cuda.py``'s plain twin, which CPU tensors take.

The twin (and the seam over it) must equal S times the hard masks,
stem by stem and bitwise, for every subset of the stems a hard-mask
config enables, at 513 and 8,193 bins, with ties at beta and at beta -
eps, h = p = 0 and a disabled harmonic or percussive stem under the
residual. The reference is ``parent_masks``, the engine's hard-mask
expression written out here on its own (not ``mask_cuda.hard_masks``,
which the twin calls), and it and the port's ``compute_masks`` are held
bitwise to zen_tpu's ``compute_masks`` on the same edge cases. The soft
and SSE masks keep the tensor path; the masks the step and the passes
hand the instruments are the filtered features' own. The kernel is held
to the same expression on the card (``tests/test_torch_cuda.py``), which
imports ``mask_inputs`` and ``parent_masked`` from here; so this module
imports neither jax nor zen_tpu, and the one test against zen_tpu imports
it inside.
"""
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.drivers import realtime as rt  # noqa: E402
from zen_tpu_torch.engine import spectral as tsp  # noqa: E402
from zen_tpu_torch.engine.config import (  # noqa: E402
    EPS,
    OUTPUT_ALL,
    OUTPUT_HARMONIC,
    OUTPUT_PERCUSSIVE,
    OUTPUT_RESIDUAL,
)
from zen_tpu_torch.ops import mask_cuda as mk  # noqa: E402
from zen_tpu_torch.ops.framing import frame_signal  # noqa: E402

HARD = [
    dict(outputs=OUTPUT_ALL),
    dict(outputs=OUTPUT_PERCUSSIVE),  # the fleet's
    dict(outputs=OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL),  # offline pass 2
    dict(outputs=OUTPUT_HARMONIC | OUTPUT_RESIDUAL),  # residual, percussive off
    dict(outputs=OUTPUT_RESIDUAL),
    dict(outputs=OUTPUT_ALL, beta=1.3),
    dict(outputs=OUTPUT_ALL, beta=0.5),  # both masks on: a residual of -1
]


def mask_inputs(rng, shape, beta: float, device="cpu"):
    """(s complex64, h, p float32) of ``shape``: ties at exactly beta
    (p = beta * (h + eps)) and at beta - eps for the harmonic (h = (beta
    - eps) * (p + eps)), h = p = 0, and spectra with zeros of either sign."""
    n = int(np.prod(shape))
    h = rng.random(n, dtype=np.float32) * np.float32(3)
    p = rng.random(n, dtype=np.float32) * np.float32(3)
    eps, b = np.float32(EPS), np.float32(beta)
    p[3::11] = b * (h[3::11] + eps)
    h[5::13] = (b - eps) * (p[5::13] + eps)
    h[::17] = 0.0
    p[::17] = 0.0
    s = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    s.real[::7] = -0.0
    s.imag[2::9] = 0.0
    s[4::19] = -0.0 - 0.0j
    return tuple(torch.from_numpy(x.reshape(shape)).to(device) for x in (s, h, p))


def parent_masks(h, p, beta: float, output_harmonic: bool = True,
                 output_percussive: bool = True) -> tuple:
    """(pm, hm, rm) float32 hard masks, as the engine's tensor path forms
    them: (x / (y + eps)) >= beta, the harmonic mask against beta - eps,
    the residual 1 - (hm + pm) with a disabled stem's mask taken as 0;
    float32 constants."""
    eps, b = torch.tensor(np.float32(EPS)), torch.tensor(np.float32(beta))
    pm = (p / (h + eps) >= b).to(torch.float32)
    hm = (h / (p + eps) >= b - eps).to(torch.float32)
    hm_eff = hm if output_harmonic else torch.zeros_like(hm)
    pm_eff = pm if output_percussive else torch.zeros_like(pm)
    return pm, hm, 1.0 - (hm_eff + pm_eff)


def parent_masked(s, h, p, beta: float, stems, output_harmonic: bool = True,
                  output_percussive: bool = True, dim: int = 0):
    """S * mask of each of ``stems`` (indices into harmonic, percussive,
    residual) under ``parent_masks``, stacked along ``dim``."""
    pm, hm, rm = parent_masks(h, p, beta, output_harmonic, output_percussive)
    by_stem = (hm, pm, rm)
    return torch.stack([s * by_stem[i] for i in stems], dim=dim)


def _reference_masks(h, p, cfg) -> tuple:
    """(pm, hm, rm) of the filtered features h and p: ``parent_masks``
    for hard masks, the port's soft and SSE masks (which the seam leaves
    on the tensor path) otherwise."""
    if cfg.use_sse or cfg.soft_mask:
        return tsp.compute_masks(*tsp.finalize_features(h, p, cfg), cfg)
    return parent_masks(h, p, cfg.beta, cfg.output_harmonic, cfg.output_percussive)


def _cfg(**kw):
    return T.HPRConfig(fs=8000.0, hop=64, causal=True, **kw)


def _subsets(cfg):
    live = tsp.live_stems(cfg)
    return [c for r in range(1, len(live) + 1) for c in itertools.combinations(live, r)]


def _bits(x):
    return torch.view_as_real(x.contiguous()).view(torch.int32)


@pytest.mark.parametrize("shape", [(3, 5, 513), (2, 3, 8193)], ids=["bins513", "bins8193"])
@pytest.mark.parametrize("kw", HARD, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_seam_equals_s_times_compute_masks(kw, shape):
    cfg = _cfg(**kw)
    s, h, p = mask_inputs(np.random.default_rng(1), shape, cfg.beta)
    masks = parent_masks(h, p, cfg.beta, cfg.output_harmonic, cfg.output_percussive)
    by_stem = (masks[1], masks[0], masks[2])
    for stems in _subsets(cfg):
        for dim in range(len(shape)):
            got = tsp.masked_spectra(s, h, p, cfg, stems, dim)
            assert got.shape == shape[:dim] + (len(stems),) + shape[dim:]
            for row, i in enumerate(stems):
                assert torch.equal(_bits(got.select(dim, row)), _bits(s * by_stem[i])), (
                    stems, dim, i)


@pytest.mark.parametrize("shape", [(3, 5, 513), (2, 3, 8193)], ids=["bins513", "bins8193"])
@pytest.mark.parametrize("kw", HARD, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_hard_masks_match_zen_tpu_on_the_edge_cases(kw, shape):
    """The port's compute_masks (``mask_cuda.hard_masks``, which the twin
    runs) and ``parent_masks`` bitwise to zen_tpu's compute_masks on the
    inputs with ties at beta and beta - eps and h = p = 0."""
    J = pytest.importorskip("zen_tpu")
    jnp = pytest.importorskip("jax.numpy")
    from zen_tpu.engine import spectral as jsp

    jc = J.HPRConfig(fs=8000.0, hop=64, causal=True, **kw)
    cfg = _cfg(**kw)
    _, h, p = mask_inputs(np.random.default_rng(1), shape, cfg.beta)
    want = jsp.compute_masks(jnp.asarray(h.numpy()), jnp.asarray(p.numpy()), jc)
    got = tsp.compute_masks(h, p, cfg)
    ref = parent_masks(h, p, cfg.beta, cfg.output_harmonic, cfg.output_percussive)
    for name, g, r, w in zip(("pm", "hm", "rm"), got, ref, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32), err_msg=name)
        np.testing.assert_array_equal(r.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32), err_msg=name)


def test_ties_and_zeros_land_as_compute_masks_puts_them():
    """The inputs hold each edge case: a percussive tie at
    beta goes percussive, a harmonic one at beta - eps harmonic, and
    h = p = 0 only to the residual."""
    cfg = _cfg()
    s, h, p = mask_inputs(np.random.default_rng(2), (1, 4, 513), cfg.beta)
    pm, hm, rm = (m.reshape(-1) for m in tsp.compute_masks(h, p, cfg))
    flat = torch.arange(pm.numel())
    tie_p = (flat % 11 == 3) & (flat % 17 != 0) & (flat % 13 != 5)
    zero = flat % 17 == 0
    assert bool(pm[tie_p].all()) and not bool(hm[tie_p].any())
    assert not bool(pm[zero].any()) and not bool(hm[zero].any()) and bool((rm[zero] == 1).all())
    tie_h = (flat % 13 == 5) & (flat % 17 != 0) & (flat % 11 != 3)
    assert bool(hm[tie_h].any())


@pytest.mark.parametrize("kw", HARD[:4], ids=["all", "p", "p-r", "h-r"])
def test_stream_layout_is_the_parents_batched_product(kw):
    """At the streaming step's stem axis (1) the seam gives, bit for bit,
    what the step multiplied before: S[:, None] * the stacked live masks."""
    cfg = _cfg(**kw)
    s, h, p = mask_inputs(np.random.default_rng(3), (4, 16, 513), cfg.beta)
    live = tsp.live_stems(cfg)
    pm, hm, rm = parent_masks(h, p, cfg.beta, cfg.output_harmonic, cfg.output_percussive)
    masks = (hm, pm, rm)
    want = s.unsqueeze(1) * torch.stack([masks[i] for i in live], dim=1)
    got = tsp.masked_spectra(s, h, p, cfg, live, 1)
    assert got.is_contiguous() and torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kw", [{"soft_mask": True}, {"use_sse": True}],
                         ids=["soft", "sse"])
def test_soft_and_sse_masks_keep_the_tensor_path(kw):
    cfg = _cfg(**kw)
    s, h, p = mask_inputs(np.random.default_rng(4), (2, 3, 513), 2.0)
    h, p = h + 1.0, p + 1.0  # SSE's means are finite
    live = tsp.live_stems(cfg)
    assert live == (0, 1)
    before = dict(mk.mask_apply.routes)
    got = tsp.masked_spectra(s, h, p, cfg, live, 0)
    assert mk.mask_apply.routes == before
    masks = tsp.stem_masks(h, p, cfg)
    for row, i in enumerate(live):
        assert torch.equal(got[row], s * masks[i])


def _stream(streams=3, hops=4, seed=5, **kw):
    cfg = _cfg(**kw)
    rng = np.random.default_rng(seed)
    blocks = torch.from_numpy(rng.standard_normal((streams, hops, cfg.hop)).astype(np.float32))
    state = rt.init_state(cfg, streams, "cpu")
    state.ring.copy_(torch.from_numpy(rng.standard_normal(state.ring.shape).astype(np.float32)))
    return cfg, state, blocks


@pytest.mark.parametrize("kw,calls", [({}, 1), ({"outputs": OUTPUT_PERCUSSIVE}, 1),
                                      ({"soft_mask": True}, 0), ({"use_sse": True}, 0)],
                         ids=["all", "percussive", "soft", "sse"])
def test_one_twin_call_a_step_and_a_pass(kw, calls):
    """A hard-mask step takes the seam's twin once, a two-pass track once
    a pass; soft and SSE masks never; the kernel's count stays put on the
    CPU."""
    cfg, state, blocks = _stream(**kw)
    launches, plain = mk.mask_apply.launches, mk.mask_apply.routes["plain"]
    rt.block_step(cfg, state, blocks)
    assert mk.mask_apply.routes["plain"] == plain + calls
    sep = T.HPRIOffline(1000.0, 32, 8, device="cpu", **{k: v for k, v in kw.items()
                                                         if k != "outputs"})
    sep.process(np.random.default_rng(6).standard_normal(700).astype(np.float32))
    assert mk.mask_apply.routes["plain"] == plain + calls + 2 * bool(calls)
    assert mk.mask_apply.launches == launches


@pytest.mark.parametrize("kw", [{}, {"soft_mask": True}, {"stream_state": "bf16"}],
                         ids=["hard", "soft", "bf16"])
def test_step_masks_on_demand_are_the_filtered_features_masks(kw):
    """StepSpectra.masks, formed on demand, are the masks of the very
    rows the step filters: the masks the step held before."""
    cfg, state, blocks = _stream(**kw)
    step = rt.step_masks(cfg, state, blocks)
    h = tsp.time_filtered_tail_pair(state.feat_hist, step.feat, cfg)
    p = tsp.freq_filtered(step.feat, cfg)
    pm, hm, rm = _reference_masks(h, p, cfg)
    for got, want in zip(step.masks, (hm, pm, rm)):
        assert (got is None and want is None) or torch.equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"use_sse": True}], ids=["hard", "sse"])
def test_pass_masks_on_demand_are_the_filtered_features_masks(kw):
    """FrameMasks.masks, formed on demand, are the masks of the pass's
    filtered features: the masks the pass held before."""
    cfg = T.HPRConfig(fs=1000.0, hop=8, causal=False, **kw)
    audio = torch.from_numpy(np.random.default_rng(7).standard_normal(500).astype(np.float32))
    fm = toff.pass_masks(audio, cfg)
    _, feats = tsp.analyze_features(frame_signal(audio, cfg.hop, toff._n_frames(500, cfg)), cfg)
    h, p = tsp.time_filtered(feats, cfg), tsp.freq_filtered(feats, cfg)
    pm, hm, rm = _reference_masks(h, p, cfg)
    for got, want in zip(fm.masks, (hm, pm, rm)):
        assert (got is None and want is None) or torch.equal(got, want)


@pytest.mark.parametrize(
    "shape,stems,dim,want",
    [((3, 5, 513), 3, 0, (1, 7695, 7696)),  # a pass's [L, T, bins]: rows on pairs
     ((3, 5, 513), 1, 0, (1, 7695, 7695)),
     ((3, 5, 513), 2, 1, (3, 2565, 2565)),  # the step's [C, L, B, bins]
     ((1, 5, 513), 2, 1, (1, 2565, 2566)),
     ((2, 4, 513), 3, 0, (1, 4104, 4104))],
)
def test_mask_layout(shape, stems, dim, want):
    assert mk.mask_layout(shape, stems, dim) == want


@pytest.mark.parametrize(
    "change,match",
    [(dict(h=torch.zeros(2, 4, dtype=torch.float64)), "float32"),
     (dict(s=torch.zeros(2, 4, dtype=torch.complex128)), "complex64"),
     (dict(p=torch.zeros(2, 5)), "one shape"),
     (dict(stems=()), "distinct stems"),
     (dict(stems=(1, 1)), "distinct stems"),
     (dict(stems=(3,)), "distinct stems"),
     (dict(dim=2), "stem axis")],
)
def test_mask_apply_refuses_what_the_kernel_does_not_take(change, match):
    args = dict(s=torch.zeros(2, 4, dtype=torch.complex64), h=torch.zeros(2, 4),
                p=torch.zeros(2, 4), stems=(1,), dim=0)
    args.update(change)
    with pytest.raises(T.ZenError, match=match):
        mk.mask_apply(args["s"], args["h"], args["p"], 2.0, EPS, args["stems"], dim=args["dim"])


def test_smoke_counts_the_mask_kernel_apart_from_the_medians():
    """chip_smoke.py's launch counters carry the mask-and-apply kernel
    (MASK): reset_launches zeroes it, read_launches reads its kernel
    launches, and by_route drops it, since a count of the medians from
    the configs and shapes does not hold it (the main path's runs check
    it on their own); the kernels line names the kernel's source."""
    import chip_smoke as cs

    mk.mask_apply.launches += 3
    mk.mask_apply.routes["kernel"] += 3
    assert cs.read_launches()[cs.MASK] >= 3 and cs.mask_launches() >= 3
    cs.reset_launches()
    counts = cs.read_launches()
    assert counts[cs.MASK] == 0 == cs.mask_launches() == mk.mask_apply.launches
    counts.update({cs.MASK: 2, "tap_median_time/register": 1})
    assert cs.MASK not in cs.by_route(counts)
    assert cs.by_route(counts)["tap_median_time/register"] == 1
    assert (Path(T.__file__).parents[1] / cs.SOURCES[cs.MASK]).exists()
