"""The port's instruments (zen_tpu_torch/benches/) and timers
(zen_tpu_torch/runtime/profiling.py) on the CPU, at a tiny size: their
artifacts carry the JAX artifacts' keys (benches/hbm_pattern_r05.json,
benches/serving_bound_r05.json), and the serving legs compute what
zen_tpu's legs compute on the same numpy inputs: the median leg bitwise
(medians are selection), the transform leg at 1e-5 of max|y| (FFT round
off). Times here are the CPU's; the card's come from chip_smoke.py.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from zen_tpu import HPRConfig as JaxConfig  # noqa: E402
from zen_tpu.drivers.realtime import resolve_multistream_fft_impl  # noqa: E402
from zen_tpu.engine import spectral as jsp  # noqa: E402
from zen_tpu.engine.config import OUTPUT_PERCUSSIVE  # noqa: E402
from zen_tpu_torch import ZenError  # noqa: E402
from zen_tpu_torch.benches import hbm_pattern, serving_bound  # noqa: E402
from zen_tpu_torch.runtime import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--fs", "8000", "--hop", "64", "--block-hops", "4",
        "--iters", "1", "--repeats", "1"]


def _jax_artifact(name):
    return json.loads((ROOT / "benches" / name).read_text())


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_hbm_pattern_keys_match_jax(tmp_path, capsys):
    out = tmp_path / "hbm.json"
    result = hbm_pattern.main(TINY + ["--streams", "2", "--big-mb", "1", "--out", str(out)])
    ref = _jax_artifact("hbm_pattern_r05.json")
    assert set(result["stages"]) == set(ref["stages"])
    for name, st in result["stages"].items():
        assert set(st) == set(ref["stages"][name])
        assert st["us_per_step"] > 0 and st["bytes_per_iter"] > 0
    renamed = {"vmem_resident_gbps": "slab_ceiling_gbps"}
    assert set(result["derived"]) == {renamed.get(k, k) for k in ref["derived"]}
    assert set(ref) - {"round"} <= set(result)
    assert result["platform"] == "cpu" and "host wall" in result["timer"]
    assert json.loads(out.read_text())["stages"].keys() == result["stages"].keys()
    line = _last_json(capsys)
    assert line["metric"] == "hbm_pattern_ceiling_2streams" and line["platform"] == "cpu"
    assert line["value"] == result["stages"]["ceiling"]["gbps"]


def test_hbm_pattern_counts_the_ports_bytes():
    """Bytes from the port's own kernels' shapes: K1 reads the whole
    [S, H + B, bins] slab its taps reach, #9 only the B rows it copies."""
    args = hbm_pattern.parse(TINY + ["--streams", "2", "--big-mb", "1"])
    result = hbm_pattern.measure(args, log=lambda line: None)
    c = result["config"]
    s, h, b, bins = c["streams"], c["history_rows"], c["block_hops"], c["bins"]
    st = result["stages"]
    assert st["time_real"]["bytes_per_iter"] == 4 * s * bins * (h + 2 * b)
    assert st["time_dma"]["bytes_per_iter"] == 4 * s * bins * 2 * b
    assert st["freqT_real"]["bytes_per_iter"] == st["freqT_dma"]["bytes_per_iter"] == 8 * s * b * bins
    assert st["ceiling_big"]["bytes_per_iter"] == 2 << 20
    assert result["derived"]["time_compute_us"] == (
        st["time_real"]["us_per_step"] - st["time_dma"]["us_per_step"])


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_serving_bound_keys_match_jax(tmp_path, capsys, state):
    out = tmp_path / "sb.json"
    result = serving_bound.main(TINY + ["--streams", "2,3",
                                        "--stream-state", state, "--out", str(out)])
    ref = _jax_artifact("serving_bound_r05.json")
    legs = set(next(iter(ref["legs_us_per_step"].values())))
    for table in ("legs_us_per_step", "legs_wall_us_per_step", "per_sample_ns"):
        assert set(result[table]) == {2, 3}
        assert all(set(v) == legs for v in result[table].values())
    # the CPU has no device time: those columns are null, the wall is measured
    assert all(v is None for v in result["legs_us_per_step"][3].values())
    assert result["legs_wall_us_per_step"][3]["full"] > 0
    assert set(ref) - {"round"} <= set(result)
    assert result["config"]["stream_state"] == state
    cfg = serving_bound.config(serving_bound.parse(TINY))
    bins = cfg.nfft // 2 + 1
    assert result["transform_min_traffic_bytes_per_sample"] == pytest.approx(
        4 * (2 * cfg.nwin + 4 * bins) / cfg.hop)
    saved = json.loads(out.read_text())
    assert set(saved["legs_wall_us_per_step"]) == {"2", "3"}
    line = _last_json(capsys)
    assert line["metric"] == "serving_bound_full_3streams" and line["timer"] == "host wall"


def _jax_cfg(state, streams):
    cfg = JaxConfig(fs=8000.0, hop=64, beta=2.0, causal=True, outputs=OUTPUT_PERCUSSIVE,
                    stream_state=state)
    return resolve_multistream_fft_impl(cfg, streams)


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_median_leg_matches_zen_tpu(state):
    """One call of the port's median leg against zen_tpu's median_leg body
    (benches/serving_bound.py:195-204) on the same features, bitwise."""
    s, b = 3, 4
    cfg = serving_bound.config(serving_bound.parse(TINY + ["--stream-state", state]))
    fn, (feats, fresh) = serving_bound.legs(cfg, s, b, torch.device("cpu"))["median"]
    hist_out, new_out = fn((feats, fresh))

    rcfg = _jax_cfg(state, s)
    h_rows = rcfg.time_history
    hist_dt = jnp.bfloat16 if state == "bf16" else jnp.float32
    f0 = jnp.asarray(feats.float().numpy()).astype(hist_dt)
    newrows0 = f0[:, h_rows:, :]

    def one(fs_):
        h = jsp.time_filtered_tail(fs_, rcfg, h_rows)
        p = jsp.freq_filtered(fs_[h_rows:, :], rcfg).astype(jnp.float32)
        return h + p

    new = (newrows0.astype(jnp.float32) + 1e-12 * jax.vmap(one)(f0)).astype(hist_dt)
    want = jnp.concatenate([f0[:, b:, :], new], axis=1)
    np.testing.assert_array_equal(hist_out.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(new_out.float().numpy(), np.asarray(new, np.float32))
    assert hist_out.dtype == feats.dtype and hist_out.shape == feats.shape


def test_transform_leg_matches_zen_tpu():
    """One call of the port's transform leg against zen_tpu's
    analyze + synthesize(s, 0.5) (benches/serving_bound.py:177-182) on the
    same frames, at 1e-5 of max|y|."""
    s, b = 2, 4
    cfg = serving_bound.config(serving_bound.parse(TINY))
    fn, frames = serving_bound.legs(cfg, s, b, torch.device("cpu"))["transform"]
    got = fn(frames).numpy()
    rcfg = _jax_cfg("f32", s)
    half = jnp.float32(0.5)
    want = np.asarray(jax.vmap(lambda xb: jsp.synthesize(jsp.analyze(xb, rcfg), half, rcfg))(
        jnp.asarray(frames.numpy())))
    assert got.shape == want.shape == (s, b, cfg.nwin)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_full_leg_runs_the_block_step():
    cfg = serving_bound.config(serving_bound.parse(TINY))
    fn, blocks = serving_bound.legs(cfg, 2, 4, torch.device("cpu"))["full"]
    out = fn(blocks)
    assert out.shape == (2, 1, 4 * cfg.hop) and bool(torch.isfinite(out).all())


def test_steady_state_ms_on_the_cpu():
    x = torch.ones(64)
    assert profiling.steady_state_ms(lambda t: t * 1.0, x, iters=3, warmup=1) > 0
    # a chain of tuples, and an example with no tensor (the output's device)
    assert profiling.steady_state_ms(lambda c: (c[0] + 1, c[1]), (x, 2), iters=2) > 0
    assert profiling.steady_state_ms(lambda _: torch.zeros(4), None, iters=2) > 0


def test_device_ms_refuses_the_cpu():
    x = torch.ones(64)
    calls = []
    with pytest.raises(ZenError):
        profiling.device_ms(lambda t: calls.append(1) or t, x)
    assert not calls  # refused before running anything
    with pytest.raises(ZenError):  # no tensor in the example: the output's device
        profiling.device_ms(lambda _: torch.zeros(4), None, iters=1, repeats=1)
    with pytest.raises(ZenError):
        profiling.device_ms(lambda c: c, {"a": [x]})


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t"):
        torch.ones(8).sum()
    data = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert "traceEvents" in data
