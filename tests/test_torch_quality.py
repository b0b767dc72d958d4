"""The port's quality instrument (zen_tpu_torch/benches/quality.py) and
its copy of the mixtures (zen_tpu_torch/io/synth.py), on the CPU.

The mixtures and SI-SNR are copies: bitwise equal to zen_tpu's. The SSE
row at the floors' calibration (fs 22050, 1024/256, the 2 s hard
mixture) agrees with zen_tpu's separation within 0.05 dB and meets the
floors of tests/test_quality.py:93. The ladder's bf16_state rung is a
real cast in both packages, so its rows agree within 0.2 dB; full_bf16
has no zen_tpu yardstick on the CPU (its dft_bf16 computes float32
there), so it is held to its floor.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu as J  # noqa: E402
from zen_tpu.io import synth as jsynth  # noqa: E402
from zen_tpu_torch.benches import quality  # noqa: E402
from zen_tpu_torch.io import synth as tsynth  # noqa: E402


def test_mixtures_and_si_snr_equal_zen_tpu():
    for fs, dur in ((22050.0, 2.0), (8000.0, 0.5)):
        for a, b in zip(tsynth.make_quality_mixture(fs, dur), jsynth.make_quality_mixture(fs, dur)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tsynth.make_hard_mixture(fs, dur), jsynth.make_hard_mixture(fs, dur)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tsynth.synth_mixture(8000.0, 1.0, sawtooth=True, vibrato_cents=20.0),
                    jsynth.synth_mixture(8000.0, 1.0, sawtooth=True, vibrato_cents=20.0)):
        np.testing.assert_array_equal(a, b)
    h, p, _ = jsynth.make_quality_mixture(8000.0, 0.5)
    assert tsynth.si_snr(h, h + p) == jsynth.si_snr(h, h + p)


def test_sse_row_matches_zen_tpu_and_meets_its_floors():
    harm, perc, cym, mix = tsynth.make_hard_mixture(22050.0, 2.0)
    sig = {"harm": harm, "perc": perc, "cym": cym, "mix": mix}
    row = quality.offline_row(22050.0, "hard", sig, 1024, 256, "sse", 2.0,
                              {"use_sse": True}, "cpu")
    assert row["platform"] == "cpu" and row["cascade"] == "1024/256"
    assert all(row[k] > v for k, v in quality.SSE_FLOORS_DB.items()), row
    n = len(mix)
    h, p, _ = (np.asarray(x)[:n] for x in J.HPRIOffline(22050.0, 1024, 256, 2.0, 2.0,
                                                        use_sse=True).process(mix))
    assert abs(row["harm_db"] - jsynth.si_snr(harm, h)) < 0.05
    assert abs(row["perc_db"] - jsynth.si_snr(perc, p)) < 0.05


def test_ladder_rows_match_zen_tpu_bf16_state():
    """fs 22050, 1 s: bf16_state against zen_tpu's same rung; full_bf16
    above its floor; every row names its platform."""
    rows = quality.run_ladder(22050.0, 1.0, [], "cpu", log=lambda line: None)
    assert [(r["mixture"], r["mode"]) for r in rows] == [
        (m, mode) for m in ("easy", "hard") for mode, _ in quality.LADDER]
    mixes = {"easy": tsynth.make_quality_mixture(22050.0, 1.0)[2],
             "hard": tsynth.make_hard_mixture(22050.0, 1.0)[3]}
    for r in rows:
        assert r["platform"] == "cpu"
        assert r["vs_f32_harm_db"] > quality.LADDER_FLOORS_DB[r["mode"]], r
        if r["mode"] != "bf16_state":
            continue
        mix = mixes[r["mixture"]]
        base = np.asarray(J.HPRRealtime(22050.0, 256, 2.0).process_stream(mix, block_hops=32))
        y = np.asarray(J.HPRRealtime(22050.0, 256, 2.0, stream_state="bf16")
                       .process_stream(mix, block_hops=32))
        assert abs(r["vs_f32_perc_db"] - jsynth.si_snr(base[1], y[1])) < 0.2, r


def test_check_raises_on_a_floor():
    gate = {"mixture": "hard", "cascade": "1024/256", "variant": "hard", "beta": 2.0,
            "harm_db": 17.0, "perc_db": 7.0, "cym_resid_db": 4.0}
    rung = {"mode": "full_bf16", "mixture": "easy", "vs_f32_harm_db": 30.0,
            "vs_f32_perc_db": 30.0}
    quality.check([gate, rung])
    with pytest.raises(SystemExit, match="ladder floors"):
        quality.check([gate, {**rung, "vs_f32_perc_db": 21.9}])
    with pytest.raises(SystemExit, match="quality floors violated"):
        quality.check([{**gate, "perc_db": 4.0}, rung])
    with pytest.raises(SystemExit, match="not evaluable"):
        quality.check([rung])


def test_cli_writes_the_artifact(tmp_path):
    """python -m zen_tpu_torch.benches.quality --device cpu at fs 11025,
    0.5 s: the JSON artifact with zen_tpu's keys."""
    out = tmp_path / "quality.json"
    assert quality.main(["--fs", "11025", "--seconds", "0.5", "--json", str(out),
                         "--device", "cpu"]) == 0
    art = json.loads(out.read_text())
    assert (art["metric"], art["fs"], art["seconds"]) == ("quality_si_snr_db", 11025.0, 0.5)
    assert any(r.get("variant") == "sse" for r in art["rows"])
    assert any(r.get("mode") == "full_bf16" for r in art["rows"])
