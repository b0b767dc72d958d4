"""zen_tpu_torch's jax-free HPRConfig against zen_tpu's, field by field.

Every derived field must be EXACTLY equal (no tolerance): the two
packages have to pick the same taps, filter widths, windows and scales
for their medians to agree bitwise.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zen_tpu.engine.config import HPRConfig as JaxConfig  # noqa: E402
from zen_tpu.errors import ZenError as JaxZenError  # noqa: E402
from zen_tpu_torch import HPRConfig, ZenError, config_from_fields  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOPS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
FIELDS = (
    "nwin", "nfft", "l_harm", "l_perc", "lag", "stft_width",
    "time_filter_len", "freq_filter_len", "time_offsets", "time_history",
    "freq_offsets", "freq_boundary", "fast_rfft", "cola_factor",
    "synth_scale", "soft_power", "output_harmonic", "output_percussive",
    "output_residual", "lag_row_written", "border",
)
BORDERS = ("wrap", "valid", "replicate")


def _pair(**kw):
    """(jax cfg, port cfg), or (None, None) when zen_tpu rejects the
    config — then the port must reject it with ZenError too."""
    try:
        jc = JaxConfig(**kw)
    except JaxZenError:
        with pytest.raises(ZenError):
            HPRConfig(**kw)
        return None, None
    return jc, HPRConfig(**kw)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fs", [1000.0, 8000.0, 22050.0, 44100.0, 48000.0])
def test_derived_fields_equal_zen_tpu(fs, causal):
    """Every border x hop x fast_rfft at this (fs, causal), including the
    borders' fast_rfft demotion and lag_row_written."""
    checked = 0
    for border in BORDERS:
        for hop in HOPS:
            for fast in (True, False):
                jc, tc = _pair(fs=fs, hop=hop, causal=causal, fast_rfft=fast,
                               border=border)
                if jc is None:
                    continue
                for name in FIELDS:
                    assert getattr(tc, name) == getattr(jc, name), (fs, hop, border, name)
                np.testing.assert_array_equal(tc.window, jc.window)
                assert tc.window.dtype == jc.window.dtype == np.float32
                checked += 1
    assert checked >= 30


def test_main_path_geometry():
    """The shapes the CUDA kernels are built and checked for."""
    c = HPRConfig(fs=44100.0, hop=1024, causal=True)
    assert (c.nwin, c.nfft, c.time_offsets, c.time_history) == (
        2048, 4096, (-5, -1, 0), 5)
    assert c.freq_filter_len == 47 and c.fast_rfft
    c = HPRConfig(fs=44100.0, hop=256, causal=True)
    assert c.time_offsets == tuple(range(-21, -16)) + tuple(range(-5, 1))
    assert (c.time_history, c.freq_filter_len) == (21, 13)


def test_borders_and_bf16_state_construct():
    """The stock wide-fleet command's geometry (44.1 kHz, hop 256) under
    each border: replicate repeats offset 0 six times, valid reads the
    previous 11 frames; both run the full C2C spectrum."""
    c = HPRConfig(fs=44100.0, hop=256, causal=True, border="replicate")
    assert c.time_offsets == tuple(range(-5, 0)) + (0,) * 6
    assert (c.time_history, c.freq_boundary, c.fast_rfft) == (5, "clamp", False)
    c = HPRConfig(fs=44100.0, hop=256, causal=True, border="valid")
    assert c.time_offsets == tuple(range(-11, 0)) and c.time_history == 11
    assert (c.freq_offsets, c.freq_boundary) == (tuple(range(13)), "zero")
    assert HPRConfig(fs=44100.0, hop=256, stream_state="bf16").stream_state == "bf16"
    # offline valid at l_harm = 2: the reference never writes the lag row
    assert not HPRConfig(fs=8000.0, hop=256, border="valid").lag_row_written


def test_fast_rfft_never_demoted_under_wrap():
    """zen_tpu demotes fast_rfft when the frequency window spans the
    half spectrum (config.py:114-119); behind its filter-length check
    that never fires, so both packages keep fast_rfft over a sweep that
    reaches the lowest sample rates either accepts."""
    checked = 0
    for fs in np.arange(400.0, 1200.0, 3.0):
        for hop in (8, 16, 32, 64):
            jc, tc = _pair(fs=float(fs), hop=hop, causal=True)
            if jc is None:
                continue
            assert tc.fast_rfft == jc.fast_rfft is True
            checked += 1
    assert checked > 100


def test_synth_scale_is_nfft_times_cola():
    c = HPRConfig(fs=44100.0, hop=1024)
    w = c.window.astype(np.float64)
    assert c.synth_scale == 4096 * (4096 / float(np.sum(w**2)))
    assert c.synth_scale == JaxConfig(fs=44100.0, hop=1024).synth_scale


@pytest.mark.parametrize(
    "kw",
    [
        {"use_sse": True},
        {"fft_impl": "dft"},
        {"fft_impl": "dft_bf16"},
        {"fft_impl": "dft_f32"},
    ],
)
def test_sse_and_dft_configs_equal_zen_tpu(kw):
    """The SSE variant and the DFT transforms build, every derived field
    equal to zen_tpu's at every border, causal or not, fast_rfft on or
    off: SSE turns 'valid' into 'wrap' before the fast_rfft demotion, so
    SSE + 'valid' keeps the half spectrum; the 'dft*' names are stored
    as given."""
    for border in BORDERS:
        for causal in (False, True):
            for fast in (True, False):
                jc, tc = _pair(fs=8000.0, hop=64, border=border, causal=causal,
                               fast_rfft=fast, **kw)
                for name in FIELDS + ("use_sse",):
                    assert getattr(tc, name) == getattr(jc, name), (border, causal, fast, name)
                assert tc.fft_impl == kw.get("fft_impl", "torch")
    sse_valid = HPRConfig(fs=8000.0, hop=64, border="valid", use_sse=kw.get("use_sse", False))
    assert (sse_valid.border, sse_valid.fast_rfft) == (
        ("wrap", True) if "use_sse" in kw else ("valid", False))
    assert config_from_fields(fs=8000.0, hop=64, **kw).fft_impl == kw.get("fft_impl", "torch")


@pytest.mark.parametrize(
    "kw", [{"border": "mirror"}, {"median_impl": "xla"}, {"fft_impl": "mkl"},
           {"stream_state": "f16"}, {"hop": 48}],
)
def test_invalid_values_raise_zen_error(kw):
    args = {"fs": 8000.0, "hop": 64, **kw}
    with pytest.raises(ZenError):
        HPRConfig(**args)


def test_config_from_fields_maps_backend_names():
    jc = JaxConfig(fs=8000.0, hop=64, causal=True, soft_mask=True,
                   median_impl="pallas", fft_impl="xla")
    tc = config_from_fields(**dataclasses.asdict(jc))
    assert (tc.median_impl, tc.fft_impl) == ("cuda", "torch")
    assert tc.soft_mask and tc.causal and tc.time_offsets == jc.time_offsets
    jc = dataclasses.replace(jc, median_impl="xla")
    assert config_from_fields(**dataclasses.asdict(jc)).median_impl == "torch"


def test_port_imports_no_jax():
    """The card's machine has no JAX: the port must not pull it in. Every
    module of the package is imported (the instruments and tools too), but
    ``__main__``, which runs the CLI."""
    code = (
        "import importlib, pkgutil, sys, zen_tpu_torch; "
        "names = [m.name for m in pkgutil.walk_packages(zen_tpu_torch.__path__, "
        "'zen_tpu_torch.') if not m.name.endswith('__main__')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert {'zen_tpu_torch.entry', 'zen_tpu_torch.engine.oracle', "
        "'zen_tpu_torch.benches.headline', 'zen_tpu_torch.tools.fuzz_parity', "
        "'zen_tpu_torch.cli', 'zen_tpu_torch.parallel.sharded'} <= set(names), names; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'zen_tpu' not in sys.modules, 'zen_tpu imported'"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
