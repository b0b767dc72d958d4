"""The port's measurement and entry surface on the CPU, at tiny sizes:
the headline bench (zen_tpu_torch/benches/headline.py), the flagship
entry points (zen_tpu_torch/entry.py), the fuzz sweep and the A/B and live-feed
tools (zen_tpu_torch/tools/), and the kernels, soak, scaling and codec
instruments (zen_tpu_torch/benches/), each held to its JAX counterpart's
output keys or, where it computes something zen_tpu computes, to
zen_tpu on the same inputs. Times here are the CPU's; the card's come
from chip_smoke.py.

Tolerances: the flagship step against zen_tpu's ``_block_step_body`` at
the realtime parity class, 5e-5 x max(1, max|ref|) per stem
(tests/test_torch_realtime.py), the ring bitwise; the dry run's
factorizations bitwise; the fuzz sweep at its own classes (5e-4 against
the oracle).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import zen_tpu as J  # noqa: E402
from zen_tpu.drivers.realtime import _block_step_body  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch import entry as tentry  # noqa: E402
from zen_tpu_torch.benches import headline, io_codec, kernels, scaling, soak  # noqa: E402
from zen_tpu_torch.io.audio import write_wav_pcm16  # noqa: E402
from zen_tpu_torch.tools import ab_reference, feed_wav_realtime, fuzz_parity, parity  # noqa: E402

ATOL = 5e-5
# bench.py:340-348's keys, and the port's wall figure beside them
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_headline_smoke_prints_bench_line(tmp_path, capsys):
    out = tmp_path / "headline.json"
    result = headline.main(["--smoke", "--device", "cpu", "--out", str(out)])
    line = _last_json(capsys)
    assert set(line) == BENCH_KEYS | {"wall_us_per_10ms", "smoke"}
    assert line["metric"] == "us_per_10ms_hop1024_hpr" and line["smoke"] is True
    assert line["unit"] == "us" and line["value"] > 0
    assert line["vs_baseline"] == round(160.0 / line["value"], 3)
    assert line["wall_us_per_10ms"] == line["value"]  # the CPU has no device column
    saved = json.loads(out.read_text())
    assert saved["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert set(saved["rows"]) == {"hop1024", "hop256", "soft_mask", "sse", "multistream",
                                  "offline_clip", "round_trip"}
    assert all(v is None for k, v in saved["rows"]["hop1024"].items() if k.startswith("device"))
    assert saved["memory"]["process_peak_bytes"] is None  # not measured on the CPU
    assert result["calls"]["track_process"] == result["calls"]["track_process_blocked"] == 1
    assert all(result["calls"][row] > 0 for row in saved["rows"])


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--smoke", "--device", "cuda"]])
def test_headline_cpu_only_under_smoke(argv):
    """No full-size CPU run and no smoke run on the card: the device timer
    refuses CPU tensors, and a smoke run is not a measurement."""
    with pytest.raises(SystemExit) as e:
        headline.parse(argv)
    assert e.value.code == 2


def test_entry_step_matches_zen_tpu_block_step_body():
    """entry(device="cpu")'s fn against zen_tpu's _block_step_body (what
    __graft_entry__.entry() returns) on the same warmed state and block."""
    fn, (state, block) = tentry.entry(device="cpu")
    cfg = tentry.entry_config()
    # __graft_entry__.py:27's config; zen_tpu runs it on its jnp reference path
    graft = J.HPRConfig(fs=44100.0, hop=1024, beta=2.0, causal=True, outputs=J.OUTPUT_ALL)
    assert T.config_from_fields(**dataclasses.asdict(graft)) == cfg
    jc = dataclasses.replace(graft, median_impl="xla", fft_impl="xla")
    assert tuple(block.shape) == (32, 1024) and block.device.type == "cpu"
    rng = np.random.default_rng(3)
    warm, blk = (rng.standard_normal((32, 1024)).astype(np.float32) for _ in range(2))
    jstate, _ = _block_step_body(jc, J.init_state(jc), jnp.asarray(warm))
    tstate = T.state_from_numpy(*map(np.asarray, jstate), device="cpu", cfg=cfg)
    jstate, jouts = _block_step_body(jc, jstate, jnp.asarray(blk))
    got_state, outs = fn(tstate, torch.from_numpy(blk))
    assert got_state is tstate  # updated in place
    want = np.asarray(jouts)
    assert outs.shape == want.shape == (3, 32 * 1024)
    for i in range(3):
        scale = max(1.0, float(np.abs(want[i]).max()))
        np.testing.assert_allclose(outs[i].numpy() / scale, want[i] / scale, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tstate.ring[0].numpy(), np.asarray(jstate.ring))
    np.testing.assert_allclose(tstate.ola_tail[0].numpy(), np.asarray(jstate.ola_tail),
                               rtol=0, atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    line = tentry.dryrun_multichip(n, device="cpu")
    assert line == capsys.readouterr().out.strip()
    assert line.startswith(f"dryrun_multichip ok on {n} shards of cpu (virtual")
    assert "flip rule" not in line and "bitwise" in line
    assert f"stream dp={n}" in line and f"blocked sp={n}" in line


def test_flip_rule_counts_and_excludes():
    """The card's fallback rule: a flipped bin excludes the samples its
    frame feeds; a difference elsewhere, or too many flips, raises."""
    hop, frames, bins = 4, 300, 400  # one flipped bin of 120,000 is within 1e-5
    masks = [torch.zeros(1, frames, bins), torch.ones(1, frames, bins)]
    flipped = [m.clone() for m in masks]
    flipped[0][0, 3, 2] = 1.0  # frame 3 feeds output chunks 2 and 3
    length = (frames - 1) * hop
    want = {k: torch.linspace(-2, 2, length)[None] for k in ("harmonic", "percussive",
                                                             "residual")}
    got = {k: v.clone() for k, v in want.items()}
    got["percussive"][0, 2 * hop : 4 * hop] += 1.0
    st = parity.flip_rule(got, want, flipped, masks, hop)
    assert st["flips"] == 1 and st["excluded"] == 2 * hop and st["rel_err"] == 0.0
    got["percussive"][0, 0] += 1.0
    with pytest.raises(T.ZenError, match="percussive"):
        parity.flip_rule(got, want, flipped, masks, hop)
    flipped[1][0, 100, 7] = 0.0  # a second flip: 1.67e-5 of the bins
    with pytest.raises(T.ZenError, match="flips"):
        parity.flip_rule(want, want, flipped, masks, hop)


@pytest.mark.parametrize("mode", sorted(fuzz_parity.MODES))
def test_fuzz_parity_every_mode_on_cpu(mode, capsys):
    assert fuzz_parity.main(["0", "2", mode, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PARITY SWEEP PASS" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["ran"] + line["rejected"] == 2 and line["device"]["platform"] == "cpu"


def _doubled(fn):
    def wrong(*a, **kw):
        out = fn(*a, **kw)
        return {k: 2 * v for k, v in out.items()}
    return wrong


class _DoubledFleet(fuzz_parity.MultiStreamHPR):
    def process_block(self, blocks):
        return 2 * super().process_block(blocks)


# mode: (the function whose result is planted wrong, the message's tag, a
# seed whose first two cases run at least one valid configuration)
PLANTED = {
    "oracle": ("hpr_separate", "stem=", 0),
    "blocked": ("hpr_separate_blocked", "stem=", 0),
    "sharded": ("sharded_separate_blocked", "BLOCKED-SHARDED", 1),
    "twopass": ("oracle_offline_pass", "harm", 0),
    "tp": ("tp_separate", "stem=", 0),
    "serving": ("MultiStreamHPR", "stream=", 0),
}


@pytest.mark.parametrize("mode", sorted(PLANTED))
def test_fuzz_parity_fails_on_a_planted_mismatch(mode, monkeypatch):
    """A wrong result of a valid configuration fails the sweep: it is never
    taken for a refusal, whatever the mode's refusal handlers catch."""
    name, tag, seed = PLANTED[mode]
    wrong = _DoubledFleet if mode == "serving" else _doubled(getattr(fuzz_parity, name))
    monkeypatch.setattr(fuzz_parity, name, wrong)
    with pytest.raises(AssertionError, match=tag):
        fuzz_parity.MODES[mode](seed, 2, torch.device("cpu"), log=lambda line: None)


def test_kernels_quick_writes_csv(tmp_path, capsys):
    csv = tmp_path / "k.csv"
    result = kernels.main(["--quick", "--device", "cpu", "--csv", str(csv), "--out",
                           str(tmp_path / "k.json")])
    lines = csv.read_text().splitlines()
    # benches/kernels_r04_full.csv's columns, then the timer and the device
    assert lines[0] == "name,ms,timer,device"
    names = [ln.split(",")[0] for ln in lines[1:]]
    for prefix in ("fft_roundtrip_NOMEM/", "fft_roundtrip_MEM/", "fft_c2c_fwd_NOMEM/",
                   "rfft_torch_NOMEM/", "irfft_dft_bf16_NOMEM/", "median_freq_plain_NOMEM/K187",
                   "median_freq_library_NOMEM/K13", "median_time_plain_NOMEM/K93",
                   "median_freq_MEM/K47", "hpr_block_step_NOMEM/hop256x32"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert all(ln.endswith(",wall,cpu") for ln in lines[1:])  # no device timer on the CPU
    assert all(float(ln.split(",")[1]) > 0 for ln in lines[1:])
    assert result["calls"]["hpr_block_step_NOMEM/hop256x32"] > 0
    assert "fft_roundtrip" in result["complexity"]
    assert _last_json(capsys)["rows"] == len(lines) - 1


def test_kernels_fit_complexity():
    pts = [(n, 3.0 * n**1.5) for n in (32, 64, 128, 256)]
    assert kernels.fit_complexity(pts) == pytest.approx(1.5)
    assert np.isnan(kernels.fit_complexity(pts[:2]))


def test_soak_on_cpu_is_finite(capsys):
    rc = soak.main(["--device", "cpu", "--fs", "8000", "--hop", "64", "--streams", "3",
                    "--block-hops", "4", "--steps", "5", "--dispatches", "3"])
    line = _last_json(capsys)
    assert rc == 0
    # benches/soak.py's keys, and what the port adds: its steps and device
    assert set(line) == {"metric", "value", "finite", "max_abs_first", "max_abs_last",
                         "drift_ratio", "steps", "device"}
    assert line["metric"] == "soak_stream_hours" and line["finite"] is True
    assert line["steps"] == 15 and line["max_abs_first"] > 0
    assert line["drift_ratio"] == round(line["max_abs_last"] / line["max_abs_first"], 4)


def test_soak_stats_match_the_outputs():
    """The per-dispatch stats reduced on the device equal the max and the
    non-finite count of the very outputs a host loop would see."""
    args = soak.parse(["--device", "cpu", "--fs", "8000", "--hop", "64", "--streams", "2",
                       "--block-hops", "4", "--steps", "1", "--dispatches", "1"])
    run = soak.Soak(args)
    mx, bad = run.dispatch()
    assert float(mx) == float(run.prev.abs().max()) and int(bad) == 0


def test_scaling_legs_on_a_cpu_mesh_of_2(tmp_path, capsys):
    out = tmp_path / "sc.json"
    result = scaling.main(["--devices", "1,2", "--mesh-legs", "--device", "cpu", "--fs", "8000",
                           "--hop", "64", "--frames", "64", "--streams-per-dev", "2",
                           "--block-hops", "4", "--json", str(out)])
    line = _last_json(capsys)
    # benches/scaling.py's keys, with "virtual" and the device
    assert set(line) == {"metric", "value", "unit", "dp_efficiency", "target", "platform",
                         "virtual", "device"}
    assert line["metric"] == "sp_scaling_efficiency_2dev" and line["virtual"] is True
    for leg in ("dp", "sp"):
        assert set(result[f"{leg}_samples_per_s"]) == {1, 2}
        assert result[f"{leg}_efficiency"][1] == 1.0
        assert result[f"{leg}_rows"][2] == {**result[f"{leg}_rows"][2], "virtual": True,
                                            "devices": ["cpu", "cpu"]}
        assert result[f"{leg}_rows"][1]["virtual"] is False
    assert "caveat" in result and json.loads(out.read_text())["counts"] == [1, 2]


def test_scaling_chip_curve_on_cpu(capsys):
    result = scaling.main(["--device", "cpu", "--fs", "8000", "--hop", "64", "--block-hops",
                           "4", "--chip-streams", "1,2", "--retention-passes", "2"])
    line = _last_json(capsys)
    assert line["metric"] == "chip_stream_throughput_2x" and line["timer"] == "host wall"
    assert set(result["chip_retention_interleaved"]) == {1, 2}
    assert all(pt["device_samples_per_s"] is None for pt in result["chip_stream_curve"].values())


def test_io_codec_native_rungs(tmp_path, capsys):
    out = tmp_path / "io.json"
    assert io_codec.main(["--seconds", "1", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert {"flac_encode_native", "flac_decode_native", "wv_encode_native",
            "flac_encode_native_stereo", "wv_encode_native_stereo", "wav_write_pcm16",
            "wav_read", "flac_ratio_vs_pcm16", "wv_ratio_vs_pcm16"} <= set(rows)
    # the checkout's regression files give three decoders a real file
    assert {"vorbis_decode_native", "mp3_decode_native", "opus_decode_native"} <= set(rows)
    # the pure-Python rungs are left out with their codecs
    assert not any(name.endswith("_python") for name in rows)
    assert rows["flac_encode_native"]["ms"] > 0 and 0 < rows["flac_ratio_vs_pcm16"] < 1


def _mixture(path, fs=4000, seconds=1.5):
    """tests/test_ab_reference.py's mixture: a tone and decaying bursts."""
    n = int(fs * seconds)
    t = np.arange(n) / fs
    harm = 0.5 * np.sin(2 * np.pi * 220 * t)
    perc = np.zeros(n, np.float32)
    rng = np.random.default_rng(0)
    for b in np.arange(0.2, seconds, 0.4):
        i = int(b * fs)
        perc[i : i + 200] += rng.standard_normal(200) * np.exp(-np.arange(200) / 40)
    write_wav_pcm16(str(path), fs, (harm + perc).astype(np.float32))


def test_ab_reference_self_stems_pass_and_corrupt_fails(tmp_path, capsys):
    from zen_tpu_torch import cli

    mix = tmp_path / "mix.wav"
    _mixture(mix)
    hps = ["--hps", "256", "2.0", "64", "2.0"]
    ref = str(tmp_path / "ref")
    cli.main(["offline", "-i", str(mix), "-o", ref, *hps, "--strict-ref", "--device", "cpu"])
    capsys.readouterr()
    rc = ab_reference.main([str(mix), ref, *hps, "--min-snr-db", "35", "--device", "cpu",
                            "--json", str(tmp_path / "rep.json")])
    rep = _last_json(capsys)
    assert rc == 0 and rep["pass"] is True
    assert rep["stems"]["harm"]["snr_db"] > 35 and rep["stems"]["perc"]["snr_db"] > 35
    assert rep["stems"]["residual"]["status"] == "both_silent"
    assert json.loads((tmp_path / "rep.json").read_text()) == rep
    # one stem corrupted: noise over the percussive stem fails the gate
    rng = np.random.default_rng(7)
    write_wav_pcm16(f"{ref}_perc.wav", 4000, rng.standard_normal(6000).astype(np.float32))
    rc = ab_reference.main([str(mix), ref, *hps, "--device", "cpu"])
    rep = _last_json(capsys)
    assert rc == 1 and rep["pass"] is False and rep["worst_snr_db"] < 20
    assert rep["stems"]["harm"]["snr_db"] > 35


def test_ab_reference_rate_mismatch_exits_2(tmp_path, capsys):
    mix = tmp_path / "mix.wav"
    _mixture(mix)
    write_wav_pcm16(str(tmp_path / "r_harm.wav"), 8000, np.zeros(100, np.float32))
    assert ab_reference.main([str(mix), str(tmp_path / "r"), "--hps", "256", "2.0", "64",
                              "2.0", "--device", "cpu"]) == 2


def test_feed_wav_realtime_recovers_every_sample(tmp_path, capsys):
    mix, out = tmp_path / "mix.wav", tmp_path / "perc.wav"
    _mixture(mix, seconds=0.5)
    st = feed_wav_realtime.main([str(mix), str(out), "32", "--block-hops", "4",
                                 "--device", "cpu"])
    assert st["recovered"] == 2000 and st["overruns"] == 0
    assert st["wall_s"] >= 0.45  # paced at the file's own rate
    assert _last_json(capsys)["device"]["platform"] == "cpu"
    assert out.stat().st_size == 44 + 2 * 2000
