"""The median-selection network of the small-K routes, on the CPU.

``zen_tpu_torch/ops/select_network.py`` schedules a comparator network
per odd K and emits it as CUDA; the kernels that run it exist only on
the card (tests/test_torch_cuda.py). Here the schedule itself is held:
the 0-1 principle at every K the routes take (K1 up to 63 taps, K2 up to
31), the lower median torch.median picks on tie-heavy and infinite taps,
bitwise equality of the network's plain version with the plain twins of
both kernels at the path configs and with zen_tpu's own network
(``_median_network``), the comparator count against zen_tpu's pruned
bitonic schedule, the emitted header's shape (one K list per kernel) and
its place in the library's hash; and the host side of K1's network
kernel (the rows a run stages, each tap's slot in them, the run that
keeps them within the byte index) and of K2's (a row's split into
blocks), emulated in torch step for step.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median_pallas import _median_network, _pruned_schedule  # noqa: E402
from zen_tpu_torch.ops import _build  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from zen_tpu_torch.ops import select_network as sn  # noqa: E402
from rank_emulation import one_torch_thread  # noqa: E402,F401 (autouse: one torch thread)

NETWORK_KS = list(range(1, sn.MAX_TAPS + 1, 2))  # K1's, 1..63
FREQ_KS = list(range(1, sn.FREQ_MAX_TAPS + 1, 2))  # K2's, 1..63
T1024 = (-5, -1, 0)
T256 = tuple(range(-21, -16)) + tuple(range(-5, 1))
CENTERED11 = tuple(range(-5, 6))
# 44.1 kHz hop 64, causal: 47 taps under each border (H = 91, 47, 23)
T64 = tuple(range(-91, -68)) + tuple(range(-23, 1))
T64_VALID = tuple(range(-47, 0))
T64_REPLICATE = tuple(range(-23, 0)) + (0,) * 24
CENTERED63 = tuple(range(-31, 32))


def _levels(rng, shape, ties: bool = False) -> np.ndarray:
    x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
    return np.floor(x * 8).astype(np.float32) / 8 + np.float32(0.125) if ties else x


def _tensor(x: np.ndarray, dtype) -> torch.Tensor:
    """float32 numpy -> torch in ``dtype``; bf16 through jnp, read back
    as float32 (exact), as the other suites make their bf16 inputs."""
    if dtype == torch.bfloat16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return torch.from_numpy(x).to(dtype)


# ---------------- the schedule ----------------


@pytest.mark.parametrize("k", NETWORK_KS)
def test_schedule_passes_the_zero_one_principle(k):
    """A network that selects the median of every 0-1 input selects it
    of every input: all 2^K binary inputs up to K = 15, 4096 seeded ones
    above, and 1024 float inputs with ties and inf beside them."""
    sched = sn.median_schedule(k)
    assert all(0 <= i < j < k for i, j in sched)
    rng = np.random.default_rng(k)
    if k <= 15:
        bits = ((np.arange(2**k)[:, None] >> np.arange(k)) & 1).T
    else:
        bits = rng.random((k, 4096)) < 0.5
    floats = _levels(rng, (k, 1024), ties=True)
    floats[rng.random((k, 1024)) < 0.1] = np.inf
    for x in (bits.astype(np.float32), floats):
        got = sn.select_median_plain(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sort(x, axis=0)[(k - 1) // 2])


@pytest.mark.parametrize("k", NETWORK_KS)
def test_network_picks_torch_s_lower_median(k):
    """At every K of K1's network: the element torch.median picks (the
    lower median, sorted[(K - 1) / 2] for odd K), on tie-heavy taps with
    +inf and -inf among them (fill and empty rows)."""
    rng = np.random.default_rng(1000 + k)
    x = _levels(rng, (k, 2048), ties=True)
    x[rng.random((k, 2048)) < 0.08] = np.inf
    x[rng.random((k, 2048)) < 0.04] = -np.inf
    taps = torch.from_numpy(x)
    got = sn.select_median_plain(taps)
    assert torch.equal(got, torch.median(taps, dim=0).values)


@pytest.mark.parametrize("k", [2, 0, -3])
def test_schedule_refuses_even_and_empty(k):
    with pytest.raises(ValueError, match="odd"):
        sn.median_schedule(k)


@pytest.mark.parametrize("k", [3, 11, 13, 47])
def test_select_plain_matches_zen_tpu_network(k):
    """Bitwise the element zen_tpu's pruned bitonic network picks, on
    tie-heavy taps."""
    x = _levels(np.random.default_rng(k), (k, 7, 33), ties=True)
    want = np.asarray(_median_network([jnp.asarray(t) for t in x], (k - 1) // 2))
    got = sn.select_median_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [3, 11, 13, 33, 47, 63])
def test_comparator_count_at_most_zen_tpu(k):
    n = 1 << (k - 1).bit_length()
    jax_cmps = sum(op == "cmp" for op, *_ in _pruned_schedule(n, k, (k - 1) // 2))
    assert len(sn.median_schedule(k)) <= jax_cmps
    # half comparators: never more min/max than two per comparator
    assert len(sn.median_schedule(k)) < sn.minmax_count(k) <= 2 * len(sn.median_schedule(k))


def test_counts_at_the_path_widths():
    """What the kernels' notes state: K = 3, 11, 13 (hop 1024, hop 256),
    33, 47 (hop 64) and 63, K1's cap."""
    ks = (3, 11, 13, 33, 47, 63)
    assert [len(sn.median_schedule(k)) for k in ks] == [3, 32, 39, 198, 308, 439]
    assert [sn.minmax_count(k) for k in ks] == [4, 54, 66, 364, 570, 816]


# ---------------- the plain version against both kernels' twins ----------------


def _time_taps(a, b, offsets, start, fill):
    """The tap stack [K, C, t_out, F] of tap_median_time's windows."""
    v = torch.cat([a, b], dim=-2)
    t = v.shape[-2]
    fill = torch.tensor(fill, dtype=v.dtype)
    taps = []
    for o in offsets:
        rows = torch.arange(start, t) + o
        inside = (rows >= 0) & (rows < t)
        taps.append(torch.where(inside[:, None], v[..., rows.clamp(0, t - 1), :], fill))
    return torch.stack(taps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((1, 5, 65), (1, 8, 65), T1024, 5, 0.0),  # hop 1024, K = 3
     ((3, 21, 33), (3, 16, 33), T256, 21, 0.0),  # hop 256, K = 11 causal
     ((2, 40, 33), (2, 0, 33), CENTERED11, 0, 0.0),  # offline pass 2, centered
     ((2, 5, 33), (2, 6, 33), tuple(range(-5, 0)) + (0,) * 6, 5, float("inf"))],  # replicate
)
def test_select_plain_matches_time_twin(a_shape, b_shape, offsets, start, fill, dtype):
    rng = np.random.default_rng(len(offsets))
    a = _tensor(_levels(rng, a_shape, ties=True), dtype)
    b = _tensor(_levels(rng, b_shape, ties=True), dtype)
    got = sn.select_median_plain(_time_taps(a, b, offsets, start, fill))
    assert got.dtype == dtype
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


def _boundary_index(p, f, mode):
    if mode == "reflect":
        p = p.abs()
        return torch.minimum(p, 2 * (f - 1) - p)
    if mode == "wrap":
        return torch.remainder(p, f)
    if mode == "edge":
        return p.clamp(0, f - 1)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
def test_select_plain_matches_freq_twin(mode, dtype):
    """K = 13 over 513 bins (the hop-256 fleet), every border."""
    k, f_out = 13, 513
    f_in = f_out + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(np.random.default_rng(13), (5, f_in), ties=True), dtype)
    base = 0 if mode == "valid" else -(k - 1) // 2
    taps = torch.stack([x[:, _boundary_index(torch.arange(f_out) + base + q, f_in, mode)]
                        for q in range(k)])
    got = sn.select_median_plain(taps)
    assert got.dtype == dtype
    assert torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode))


# ---------------- the emitted header ----------------


def test_header_holds_one_straight_line_function_per_k():
    """median<K> for every K up to K1's cap, and each kernel's cap and
    K list apart: K1's 1..63, K2's 1..63."""
    text = sn.emit_header()
    assert sn.MAX_TAPS == sn.TIME_MAX_TAPS == 63 and sn.FREQ_MAX_TAPS == 63
    assert f"#define ZEN_SELECT_TIME_MAX_TAPS {sn.TIME_MAX_TAPS}\n" in text
    assert f"#define ZEN_SELECT_FREQ_MAX_TAPS {sn.FREQ_MAX_TAPS}\n" in text
    assert "ZEN_SELECT_MAX_TAPS" not in text
    bodies = re.findall(r"float median<(\d+)>\(const float \(&v\)\[\d+\]\) \{\n(.*?)\n\}", text,
                        flags=re.S)
    assert [int(k) for k, _ in bodies] == NETWORK_KS
    for k, body in bodies:
        lines = body.splitlines()
        assert lines[-1].startswith("  return ")
        assert len(lines) - 1 == sn.minmax_count(int(k))
        for line in lines[:-1]:
            assert re.fullmatch(r"  const float [lh]\d+ = f(min|max)f\([\w\[\]]+, [\w\[\]]+\);", line)
    assert "for" not in re.sub(r"//.*|ZEN_SELECT_FOR_EACH_\w+", "", text).split()
    cases = re.search(r"#define ZEN_SELECT_FOR_EACH_TIME_K\(X\) (.*)", text).group(1)
    assert cases.split() == [f"X({k})" for k in NETWORK_KS]
    cases = re.search(r"#define ZEN_SELECT_FOR_EACH_FREQ_K\(X\) (.*)", text).group(1)
    assert cases.split() == [f"X({k})" for k in FREQ_KS]


@pytest.mark.parametrize("k", [3, 11, 13, 31, 33, 47, 51, 63])
def test_header_function_computes_the_median(k):
    """The emitted C text of median<k>, read as Python, is the network."""
    body = re.search(rf"median<{k}>\(const float \(&v\)\[{k}\]\) \{{\n(.*?)\n\}}", sn.emit_header(),
                     flags=re.S).group(1)
    x = _levels(np.random.default_rng(k), (k, 500), ties=True)
    env = {"v": list(torch.from_numpy(x)), "fminf": torch.minimum, "fmaxf": torch.maximum}
    for line in body.splitlines()[:-1]:
        name, expr = re.fullmatch(r"  const float (\w+) = (.*);", line).groups()
        env[name] = eval(expr, {}, env)  # noqa: S307 (the repo's own generated text)
    got = eval(body.splitlines()[-1].removeprefix("  return ").rstrip(";"), {}, env)  # noqa: S307
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=0)[(k - 1) // 2])


def test_library_hash_covers_the_generated_header(monkeypatch):
    """An edited schedule names another library and another include
    directory, so a stale build is never reused."""
    before, text = _build.library_path(), sn.emit_header()
    ops = sn.median_ops

    def edited(k):
        return ops(k) + ((("both", 0, 1),) if k == 3 else ())

    monkeypatch.setattr(sn, "median_ops", edited)
    assert sn.emit_header() != text and _build.library_path() != before


def test_generated_header_lands_in_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    inc = _build.generated_include_dir()
    assert inc.parent == tmp_path and inc.name.startswith("gen_")
    assert (inc / _build.GENERATED_HEADER).read_text() == sn.emit_header()
    assert _build.generated_include_dir() == inc  # written once


# ---------------- K1's network kernel, from the wrapper's plan ----------------


def emulate_time_network(a, b, offsets, start, fill=0.0, run=None):
    """K1's network kernel: a thread per (stream, run of output rows,
    column) stages the rows ``time_network_plan`` lists (V = a ++ b, fill
    outside, in the inputs' dtype), then for each of its rows reads its K
    taps at the plan's slots and runs the network."""
    offsets = tuple(offsets)
    k = len(offsets)
    v = torch.cat([a, b], dim=-2)
    c, t_v, f = v.shape
    t_out = t_v - start
    run = run or mc.time_network_run(t_out, c, f, offsets)
    rows, slots = mc.time_network_plan(offsets, run)
    assert len(rows) <= mc.TIME_NETWORK_MAX_STAGED and max(slots) < len(rows)
    rel, fill = torch.tensor(rows), torch.tensor(fill, dtype=a.dtype)
    out = torch.empty((c, t_out, f), dtype=a.dtype)
    for i0 in range(0, t_out, run):
        r = rel + start + i0
        inside = (r >= 0) & (r < t_v)
        staged = torch.where(inside[None, :, None], v[:, r.clamp(0, t_v - 1)], fill)
        for i in range(min(run, t_out - i0)):
            taps = staged[:, list(slots[i * k : (i + 1) * k])].float()  # [C, K, F]
            out[:, i0 + i] = sn.select_median_plain(taps.transpose(0, 1)).to(a.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((1, 5, 65), (1, 32, 65), T1024, 5, 0.0),
     ((3, 21, 33), (3, 16, 33), T256, 21, 0.0),  # the 512-stream block: two runs of 8
     ((3, 21, 33), (3, 1, 33), T256, 21, 0.0),  # B = 1: a run of one row
     ((2, 21, 17), (2, 13, 17), T256, 21, 0.0),  # a ragged last run
     ((1, 43, 17), (1, 0, 17), CENTERED11, 0, 0.0),  # fill on both ends
     ((2, 5, 9), (2, 16, 9), tuple(range(-5, 0)) + (0,) * 6, 5, float("inf")),
     ((2, 11, 9), (2, 16, 9), tuple(range(-11, 0)), 11, 0.0),  # valid
     ((1, 40, 9), (1, 0, 9), tuple(range(-15, 16)), 0, float("inf")),  # K = 31
     ((1, 9, 9), (1, 0, 9), (0,), 0, 0.0),  # K = 1
     # 44.1 kHz hop 64 (K = 47) under wrap, valid and replicate; K = 63
     ((2, 91, 9), (2, 13, 9), T64, 91, 0.0),
     ((2, 47, 9), (2, 13, 9), T64_VALID, 47, 0.0),
     ((2, 23, 9), (2, 13, 9), T64_REPLICATE, 23, float("inf")),
     ((1, 62, 9), (1, 19, 9), CENTERED63, 62, float("inf"))],
)
def test_time_network_emulation_matches_twin(a_shape, b_shape, offsets, start, fill, dtype):
    rng = np.random.default_rng(len(offsets) + a_shape[1])
    a = _tensor(_levels(rng, a_shape, ties=True), dtype)
    b = _tensor(_levels(rng, b_shape, ties=True), dtype)
    assert mc.time_route(offsets) == "register" and len(offsets) <= mc.REGISTER_TAPS
    want = mc.tap_median_time_plain(a, b, offsets, start, fill)
    # the wrapper's run for this small grid (1) and a fleet's (8, or all the rows)
    assert torch.equal(emulate_time_network(a, b, offsets, start, fill), want)
    fleet = min(mc.TIME_NETWORK_RUN, want.shape[1])
    assert torch.equal(emulate_time_network(a, b, offsets, start, fill, run=fleet), want)


@pytest.mark.parametrize("run", [1, 2, 4, 8, 16])
def test_time_network_emulation_at_every_run_length(run):
    rng = np.random.default_rng(run)
    a = _tensor(_levels(rng, (2, 21, 9)), torch.float32)
    b = _tensor(_levels(rng, (2, 19, 9)), torch.float32)
    got = emulate_time_network(a, b, T256, 21, run=run)
    assert torch.equal(got, mc.tap_median_time_plain(a, b, T256, 21))


def test_time_network_plan_stages_the_union_once():
    rows, slots = mc.time_network_plan(T256, 8)
    assert rows == tuple(range(-21, -9)) + tuple(range(-5, 8)) and len(rows) == 25
    assert len(slots) == 8 * 11
    assert [rows[s] for s in slots[:11]] == list(T256)
    assert [rows[s] for s in slots[7 * 11 :]] == [o + 7 for o in T256]
    # a duplicated offset is one staged row read twice
    rows, slots = mc.time_network_plan((-1, 0, 0), 2)
    assert rows == (-1, 0, 1) and slots == (0, 1, 1, 1, 2, 2)
    assert mc.time_network_plan((0,), 1) == ((0,), (0,))


def test_time_network_run_fills_the_card():
    """Runs of TIME_NETWORK_RUN rows on a fleet, all the rows when fewer,
    halved while the grid has too few blocks to fill the card
    (``time_fill_run``, also #9's run); whatever the offsets, the
    network's run stages rows that fit its byte index and shared memory."""
    fill = mc.time_fill_run
    assert fill(32, 512, 513) == mc.TIME_NETWORK_RUN
    assert fill(16, 512, 513) == mc.TIME_NETWORK_RUN
    assert fill(3, 512, 513) == 3 and fill(1, 512, 513) == 1
    # 64 streams x 5 column tiles x 4 runs fill the card; one hop-1024 stream
    # (17 tiles x 32 rows) does so only a row a thread; the track's pass 2 at 8
    assert fill(32, 64, 513) == 8
    assert fill(32, 1, 2049) == 1
    assert fill(643, 1, 513) == 4
    assert fill(41355, 1, 513) == 8
    # taps whose runs stage few rows keep the filling run
    for args in ((32, 512, 513), (32, 64, 513), (32, 1, 2049), (643, 1, 513)):
        assert mc.time_network_run(*args, T256) == fill(*args)
    # hop 64's taps keep the run: 61 rows staged for 8 of them (wrap)
    assert mc.time_network_run(32, 512, 129, T64) == 8
    assert len(mc.time_network_plan(T64, 8)[0]) == 61
    assert len(mc.time_network_plan(T64_VALID, 8)[0]) == 54
    assert len(mc.time_network_plan(T64_REPLICATE, 8)[0]) == 31
    # 63 taps no two rows' taps meet: a run of 8 would stage 504 rows, so
    # the run halves until the plan's staged count fits the byte index
    scattered = tuple(range(-6200, 100, 100))
    assert len(scattered) == mc.REGISTER_TAPS
    assert len(mc.time_network_plan(scattered, 8)[0]) == 8 * 63
    run = mc.time_network_run(41355, 1, 513, scattered)
    staged = len(mc.time_network_plan(scattered, run)[0])
    assert run == 4 and staged == 4 * 63 <= mc.TIME_NETWORK_MAX_STAGED
    assert staged * mc.TIME_NETWORK_THREADS * 4 <= mc.SMEM_OPTIN
    # a run of one row stages at most K rows, which always fit
    assert mc.REGISTER_TAPS <= mc.TIME_NETWORK_MAX_STAGED


def test_host_constants_match_the_sources():
    """The wrappers' limits are the kernels' own (csrc), read from the
    sources: a drift would send a launch the kernel refuses."""
    def const(header, name):
        text = (_build.CSRC / header).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("time_runs.cuh", "kThreads") == mc.TIME_NETWORK_THREADS
    assert const("median_time.cu", "kNetMaxRun") == mc.TIME_NETWORK_MAX_RUN
    assert const("median_time.cu", "kNetMaxStaged") == mc.TIME_NETWORK_MAX_STAGED == 256
    assert const("row_segment.cuh", "kNetworkChunk") == mc.FREQ_NETWORK_CHUNK
    assert mc.FREQ_NETWORK_MAX_TAPS == sn.FREQ_MAX_TAPS == mc.REGISTER_TAPS == sn.TIME_MAX_TAPS


# ---------------- K2's network route: a row's split into blocks ----------------


@pytest.mark.parametrize("f_out,chunk,blocks", [(513, 513, 1), (1024, 1024, 1), (1025, 513, 2),
                                                (2049, 683, 3), (65, 65, 1), (1, 1, 1),
                                                (8193, 911, 9)])
def test_freq_network_chunk_splits_rows_evenly(f_out, chunk, blocks):
    assert mc.freq_network_chunk(f_out) == chunk <= mc.FREQ_NETWORK_CHUNK
    assert -(-f_out // chunk) == blocks


@pytest.mark.parametrize("mode", ["reflect", "wrap", "edge", "valid"])
@pytest.mark.parametrize("k,f_out", [(13, 513), (31, 1100), (1, 65), (5, 2049), (47, 2049),
                                     (63, 300)])
def test_freq_network_emulation_matches_twin(k, f_out, mode):
    """K2's network kernel: a block per (row, chunk) stages chunk + K - 1
    samples with the border on the load; each output runs the network on
    K consecutive staged samples."""
    f_in = f_out + (k - 1 if mode == "valid" else 0)
    x = _tensor(_levels(np.random.default_rng(k), (3, f_in), ties=True), torch.float32)
    chunk = mc.freq_network_chunk(f_out)
    out = torch.empty((3, f_out))
    for j0 in range(0, f_out, chunk):
        live = min(chunk, f_out - j0)
        base = j0 if mode == "valid" else j0 - (k - 1) // 2
        seg = x[:, _boundary_index(torch.arange(live + k - 1) + base, f_in, mode)]
        assert seg.shape[1] <= mc.FREQ_NETWORK_CHUNK + mc.FREQ_NETWORK_MAX_TAPS - 1
        taps = torch.stack([seg[:, q : q + live] for q in range(k)])
        out[:, j0 : j0 + live] = sn.select_median_plain(taps)
    assert mc.freq_route(k) == "network"
    assert torch.equal(out, mc.sliding_median_boundary_plain(x, k, mode))


# ---------------- K1's shared core (runs of outputs share their taps) ----------------

CORE_RS = (1, 2, 4, 8, 16)
CORE_KS = list(range(1, 32, 2))  # every odd K up to 31


def _core_taps(k: int, kind: str) -> tuple:
    """Taps of K = k: 'one' run centered; 'two' runs (fm, fm + 1) as the
    causal wrap lays them out (hop 256's at K = 11); 'duplicated' a run
    ending at 0 plus two more 0s, as the replicate border repeats it."""
    fm = k // 2
    if kind == "one":
        return tuple(range(-fm, fm + 1))
    if kind == "two":
        return tuple(range(-4 * k, -4 * k + fm)) + tuple(range(-fm, 1))
    return tuple(range(-(k - 3), 1)) + (0, 0) if k >= 3 else (0,)


@pytest.mark.parametrize("kind", ["one", "two", "duplicated"])
@pytest.mark.parametrize("k", CORE_KS)
def test_core_schedule_matches_the_twin_and_zen_tpu(k, kind):
    """The shared core's plain version (``tap_median_time_core_plain``:
    each run of R outputs loads the rows its taps reach and runs
    ``core_program``'s schedule) is bitwise ``tap_median_time_plain`` and
    zen_tpu's Pallas time median (interpret mode) at every R of
    CORE_RS, on tie-heavy inputs, with fill +inf or -inf past both ends
    of V; the schedule exists exactly where the R outputs share a tap."""
    from jax.experimental.pallas import tpu as pltpu

    from zen_tpu.ops import median_pallas as mp

    offsets = _core_taps(k, kind)
    assert len(offsets) == k
    fill = float("inf") if k % 4 == 1 else float("-inf")
    rng = np.random.default_rng(100 * k + len(kind))
    h = -min(offsets)
    x = _levels(rng, (2, h + 23, 9), ties=True)
    a, b = torch.from_numpy(x[:, :h]), torch.from_numpy(x[:, h:])
    start = max(0, h - 3)  # the first outputs' taps reach past row 0
    want = mc.tap_median_time_plain(a, b, offsets, start, fill)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(mp.tap_median_time_pallas(x, offsets, fill=fill, start=start))
    np.testing.assert_array_equal(want.numpy(), pallas)
    lengths = tuple(n for _, n in sn.tap_runs(offsets))
    for r in CORE_RS:
        if sn.core_program(lengths, r) is None:
            assert all(n < r for n in lengths), (lengths, r)
            continue
        got = mc.tap_median_time_core_plain(a, b, offsets, start, fill, r)
        assert torch.equal(got, want), (offsets, r)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_core_plain_bf16_matches_the_twin(r):
    """bf16 taps go through float and back (the kernel's to_float and
    from_float) and select the twin's bits: hop 256's two runs, the
    512-stream block's B = 16 outputs in runs of r (the last ragged)."""
    rng = np.random.default_rng(r)
    a = _tensor(_levels(rng, (3, 21, 17), ties=True), torch.bfloat16)
    b = _tensor(_levels(rng, (3, 16, 17), ties=True), torch.bfloat16)
    got = mc.tap_median_time_core_plain(a, b, T256, 21, 0.0, r)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.tap_median_time_plain(a, b, T256, 21))


def test_core_schedule_passes_the_zero_one_principle():
    """Every built shape (``core_shapes``) gives each of its R outputs the
    median of its K taps on every 0-1 input of the rows a thread loads,
    at K up to 9 (2^(K + 2(R - 1)) inputs), and on 4096 random 0-1
    inputs beyond."""
    rng = np.random.default_rng(0)
    for lengths, r in sn.core_shapes():
        loads, _, _, _ = sn.core_program(lengths, r)
        s = len(loads)
        if s <= 14:
            bits = (np.arange(1 << s)[:, None] >> np.arange(s)) & 1
        else:
            bits = rng.integers(0, 2, (4096, s))
        staged = torch.from_numpy(bits.T.astype(np.float32))
        got = sn.core_medians_plain(staged, lengths, r).numpy()
        pos = {jp: q for q, jp in enumerate(loads)}
        for i in range(r):
            taps = np.stack([bits[:, pos[(j, i + p)]] for j, n in enumerate(lengths)
                             for p in range(n)])
            want = np.sort(taps, axis=0)[(taps.shape[0] - 1) // 2]
            np.testing.assert_array_equal(got[i], want, err_msg=f"{lengths} R={r} output {i}")


def test_core_saves_min_max_over_the_network():
    """The shared core's min/max an output against median<K>'s at the
    paths' shapes (upper bounds counted over Batcher's full network were
    ~29, ~43 and ~150)."""
    assert sn.minmax_count(11) == 54 and sn.minmax_count(17) == 124
    assert sn.core_minmax_per_output((11,), 4) == 20.5
    assert sn.core_minmax_per_output((5, 6), 3) == 28.0
    assert sn.core_minmax_per_output((17,), 4) == 32.5
    assert sn.core_minmax_per_output((23, 24), 6) < 170 and sn.minmax_count(47) == 570
    # R = 1 is the per-output network itself
    for k in (3, 11, 17, 31):
        assert sn.core_minmax_per_output((k,), 1) == sn.minmax_count(k)


def test_tap_runs_split_the_multiset():
    assert sn.tap_runs(T256) == ((-21, 5), (-5, 6))
    assert sn.tap_runs(CENTERED11) == ((-5, 11),)
    assert sn.tap_runs(T1024) == ((-5, 1), (-1, 2))
    assert sn.tap_runs(tuple(range(-5, 0)) + (0,) * 6) == ((-5, 6),) + ((0, 1),) * 5
    assert sn.tap_runs((3, 1, 2, 2)) == ((1, 3), (2, 1))


def test_core_shapes_are_the_built_kernels():
    """One tap run of each odd length 5..63 and the causal wrap's (fm,
    fm + 1) for fm 2..31, each at its CORE_KEEP best R of CORE_RUNS; ids
    in order, split over CORE_PARTS sources (csrc/median_time_core_p*.cu,
    one per part)."""
    shapes = sn.core_shapes()
    assert len(shapes) == 115 and len(set(shapes)) == len(shapes)
    lengths = list(dict.fromkeys(s for s, _ in shapes))
    assert lengths == [(n,) for n in range(5, 64, 2)] + [(fm, fm + 1) for fm in range(4, 32)]
    assert all(sum(1 for s, _ in shapes if s == ln) <= sn.CORE_KEEP for ln in lengths)
    assert [r for s, r in shapes if s == (11,)] == [3, 4]
    assert [r for s, r in shapes if s == (5, 6)] == [2, 3]
    assert [r for s, r in shapes if s == (17,)] == [3, 4]
    assert [r for s, r in shapes if s == (23, 24)] == [4, 6]
    for lengths_r in shapes:
        assert len(sn.core_program(*lengths_r)[0]) <= sn.CORE_MAX_STAGED
    parts = sorted(p.name for p in _build.CSRC.glob("median_time_core_p*.cu"))
    assert parts == [f"median_time_core_p{q}.cu" for q in range(sn.CORE_PARTS)]
    assert {sn.core_part(q) for q in range(len(shapes))} == set(range(sn.CORE_PARTS))


def test_core_header_holds_each_shape():
    """zen_core.cuh: a Shape<id> a built shape, its loads by tap run and
    position, its program straight-line, and each part's list of ids."""
    text = sn.emit_core_header()
    assert f"#define ZEN_CORE_PARTS {sn.CORE_PARTS}\n" in text
    listed = []
    for q in range(sn.CORE_PARTS):
        ids = re.search(rf"#define ZEN_CORE_FOR_EACH_SHAPE_OF_PART_{q}\(X\) (.*)", text).group(1)
        listed += [int(x[2:-1]) for x in ids.split()]
    assert sorted(listed) == list(range(len(sn.core_shapes())))
    heads = re.findall(r"struct Shape<(\d+)> \{\n  static constexpr int kK = (\d+), kR = (\d+), "
                       r"kStaged = (\d+), kTapRuns = (\d+);", text)
    assert len(heads) == len(sn.core_shapes())
    for (sid, k, r, staged, runs), (lengths, rr) in zip(heads, sn.core_shapes()):
        assert (int(k), int(r), int(runs)) == (sum(lengths), rr, len(lengths))
        assert int(staged) == len(sn.core_program(lengths, rr)[0])
    assert "for" not in re.sub(r"//.*|ZEN_CORE_FOR_EACH_\w+", "", text).split()


@pytest.mark.parametrize("shape_id", [0, 5, 12, 40, 63, 90, 114])
def test_core_header_shape_computes_the_medians(shape_id):
    """A Shape<id>'s emitted stage and medians, read as Python, give each
    of its R outputs the median of its taps."""
    lengths, r = sn.core_shapes()[shape_id]
    body = re.search(rf"struct Shape<{shape_id}> \{{\n(.*?)\n\}};", sn.emit_core_header(),
                     flags=re.S).group(1)
    loads = [tuple(map(int, m)) for m in re.findall(r"v\[\d+\] = load\((\d+), (\d+)\);", body)]
    assert loads == list(sn.core_program(lengths, r)[0])
    x = _levels(np.random.default_rng(shape_id), (len(loads), 300), ties=True)
    env = {"v": list(torch.from_numpy(x)), "fminf": torch.minimum, "fmaxf": torch.maximum,
           "m": [None] * r}
    medians = body[body.index("static void medians"):]
    for line in medians.splitlines()[1:]:
        line = line.strip()
        if line.startswith("const float"):
            name, expr = re.fullmatch(r"const float (\w+) = (.*);", line).groups()
            env[name] = eval(expr, {}, env)  # noqa: S307 (the repo's own generated text)
        elif line.startswith("m["):
            i, expr = re.fullmatch(r"m\[(\d+)\] = (\w+);", line).groups()
            env["m"][int(i)] = env[expr]
    pos = {jp: q for q, jp in enumerate(loads)}
    for i in range(r):
        taps = np.stack([x[pos[(j, i + p)]] for j, n in enumerate(lengths) for p in range(n)])
        np.testing.assert_array_equal(env["m"][i].numpy(), np.sort(taps, axis=0)[sum(lengths) // 2])


def test_library_hash_covers_the_core_header(monkeypatch):
    """An edited shared-core schedule names another library."""
    before = _build.library_path()
    shapes = sn.core_shapes()
    monkeypatch.setattr(sn, "core_shapes", lambda: shapes[:-1])
    assert _build.library_path() != before


def test_split_builds_leave_the_core_out():
    """The cut builds (chip_smoke's split of a rank block) compile no
    shared-core source, K1's or K2's; the library compiles each of them."""
    full = {p.name for p in _build._sources(0)}
    cut = {p.name for p in _build._sources(1)}
    core = {p.name for p in (*_build.CSRC.glob("median_time_core*.cu"),
                             *_build.CSRC.glob("median_freq_core*.cu"))}
    assert core and core <= full and not core & cut and full - cut == core


def test_register_form_per_geometry():
    """``time_network_form``'s pick at each path's geometry: the shared
    core wherever its shape is built and the call has more than one output
    row, at the largest R whose grid keeps TIME_CORE_MIN_BLOCKS blocks (the
    smallest R on a single stream's few blocks); the per-output network
    elsewhere; a majority tap planned as K = 1 first."""
    form = mc.time_network_form
    assert form(T256, 32, 64, 513) == ("core", 3)  # the 64-stream fleet, B = 32
    assert form(T256, 16, 512, 513) == ("core", 3)  # the 512-stream block, B = 16
    assert form(T256, 1, 512, 513) == ("network", 1)  # B = 1: one row shares nothing
    assert form(CENTERED11, 41355, 1, 513) == ("core", 4)  # the track's pass 2
    assert form(CENTERED11, 643, 1, 513) == ("core", 4)  # the clip's pass 2
    assert form(tuple(range(-16, 1)), 2585, 1, 8193) == ("core", 4)  # median2d fl 17
    assert form(tuple(range(-11, 0)), 16, 512, 1024) == ("core", 4)  # the valid border
    assert form(T256, 64, 1, 513) == ("core", 2)  # beat-track: 160 blocks at R = 2
    assert form(T64, 32, 1, 129) == ("core", 4)  # one hop-64 stream, B = 32
    assert form(T64, 1, 1, 129) == ("network", 1)  # and B = 1
    assert form(T64, 32, 64, 129) == ("core", 6)  # the hop-64 fleet
    assert form(CENTERED63, 32, 64, 129) == ("core", 8)
    assert form(tuple(range(-32, 1)), 32, 64, 513) == ("core", 8)
    assert form(T1024, 32, 1, 2049) == ("network", 1)  # runs (1, 2): no shape
    assert form((0,), 8, 1, 8193) == ("network", 1)  # pitch-track's K = 1
    replicate = tuple(range(-5, 0)) + (0,) * 6
    assert mc.time_majority_tap(replicate) == 0 and mc.time_majority_tap(T256) is None
    assert form(replicate, 16, 512, 1024) == ("network", 8)
    assert mc.time_majority_tap(T64_REPLICATE) == 0
    assert mc._time_blocks(32, 64, 129, 8) == 512 >= mc.TIME_CORE_MIN_BLOCKS


def test_register_route_arguments():
    """What the wrapper hands each register kernel: the shared core's
    shape id and each tap run's first offset (and K); the replicate
    border's majority tap alone at K = 1 on the network; a shape the
    kernel is not built for raises, never falls back."""
    cpu = torch.device("cpu")
    shape, firsts = mc.time_core_plan(T256, 3)
    assert sn.core_shapes()[shape] == ((5, 6), 3) and firsts == (-21, -5)
    name, (fs, runs, sid), tail, k = mc._time_args(T256, 21, 21, 16, 512, 513, "register", cpu)
    assert (name, list(fs), runs, sid, tail, k) == (
        "zen_tap_median_time_core", [-21, -5], 2, shape, (), 11)
    replicate = tuple(range(-5, 0)) + (0,) * 6
    name, (rows, staged, slots, run), _, k = mc._time_args(replicate, 5, 5, 16, 512, 1024,
                                                           "register", cpu)
    assert (name, k, run, list(rows)) == ("zen_tap_median_time_network", 1, 8, list(range(8)))
    # forced forms (chip_smoke's sweeps): the network at a run, the core at an R
    assert mc._time_args(T256, 21, 21, 16, 512, 513, "register", cpu, run=2)[0] == (
        "zen_tap_median_time_network")
    assert mc._time_args(T256, 21, 21, 16, 512, 513, "register", cpu, core=2)[1][2] == (
        mc.time_core_plan(T256, 2)[0])
    assert mc.time_core_plan(T1024, 2) is None and mc.time_core_plan(T256, 4) is None
    with pytest.raises(mc.ZenError, match="no shared core"):
        mc._time_args(T256, 21, 21, 16, 512, 513, "register", cpu, core=4)


def test_smoke_labels_the_shared_core():
    """chip_smoke.py's launch labels: a register call that takes the
    shared core is CORE ('register@core'), counted on the register route
    too; one that takes the per-output network stays 'register'; by_route
    drops the CORE keys, which a count from the configs alone does not
    hold; the kernels line names the core's own source."""
    import chip_smoke as cs

    sms = mc.H100_SMS
    assert cs.time_call_label(T256, 21, 21 + 32, 64, 513, sms) == cs.CORE  # the 64-stream fleet
    assert cs.time_call_label(CENTERED11, 0, 41_355, 1, 513, sms) == cs.CORE  # the track's pass 2
    assert cs.time_call_label(T1024, 5, 5 + 32, 1, 2049, sms) == "register"  # hop 1024
    assert cs.time_call_label((0,), 0, 8, 1, 8193, sms) == "register"  # pitch-track
    assert cs.time_call_label(T256, 21, 22, 512, 513, sms) == "register"  # B = 1
    assert cs.launch_keys(f"tap_median_time/{cs.CORE}") == (
        f"tap_median_time/{cs.CORE}", "tap_median_time/register")
    counts = {"tap_median_time/register": 3, f"tap_median_time/{cs.CORE}": 2}
    assert cs.by_route(counts) == {"tap_median_time/register": 3}
    assert cs.SOURCES[f"tap_median_time/{cs.CORE}"] == "zen_tpu_torch/csrc/median_time_core.cu"
    assert (_build.CSRC.parents[1] / cs.SOURCES[f"tap_median_time/{cs.CORE}"]).exists()


# ---------------- K2's shared core (runs of outputs share their window) ----------------

FREQ_MODES = ["reflect", "wrap", "edge", "valid"]


def _csrc_const(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source: kSlack of freq_core.cuh
    (samples past a chunk's segment, and past its outputs, that a run's
    words may reach), kNetworkThreads of row_segment.cuh."""
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _word_samples(r: int, itemsize: int) -> int:
    """word_samples of csrc/freq_core.cuh: the largest power of two
    that divides R, at most 16 bytes."""
    a = 1
    while r % (2 * a) == 0 and 2 * a * itemsize <= 16:
        a *= 2
    return a


def emulate_freq_core(x: torch.Tensor, k: int, mode: str, r: int, grid: int = 3) -> torch.Tensor:
    """K2's shared-core kernel step for step: a persistent grid of
    ``grid`` blocks a chunk, block (b, c) taking chunk c of the rows b, b
    + grid, ...; for each row its threads stage chunk + K - 1 samples into
    a segment whose slack is stale (NaN here), the interior positions
    loaded directly and the at most K - 1 halo positions by the first
    threads under the border; thread t takes the runs t, t + 128, ... of
    R outputs, reads K + R - 1 samples from sample t R on in words of A,
    runs the shape's program and writes its R medians to the block's
    result buffer (stale past the chunk too), which the block writes out
    to the chunk's live outputs."""
    f_in = x.shape[-1]
    f_out = f_in - k + 1 if mode == "valid" else f_in
    loads, _, _, _ = sn.core_program((k,), r)
    n, a = len(loads), _word_samples(r, x.element_size())
    slack, threads = _csrc_const("freq_core.cuh", "kSlack"), _csrc_const(
        "row_segment.cuh", "kNetworkThreads")
    assert n == k + r - 1 and r + a - 2 <= slack
    chunk = mc.freq_network_chunk(f_out)
    rows = x.reshape(-1, f_in)
    out = torch.empty((rows.shape[0], f_out), dtype=x.dtype)
    done = []
    for j0 in range(0, f_out, chunk):
        live = min(chunk, f_out - j0)
        need = live + k - 1
        base = j0 if mode == "valid" else j0 - (k - 1) // 2
        hl, hr = max(0, -base), max(0, base + need - f_in)  # split_of
        assert hl + hr <= min(k - 1, threads)
        inside = torch.arange(need) + base
        inside = (inside >= 0) & (inside < f_in)
        halo = [t if t < hl else f_in - base + t - hl for t in range(hl + hr)]
        assert not inside[halo].any() and int(inside.sum()) + len(halo) == need
        for block in range(min(grid, rows.shape[0])):
            for ri in range(block, rows.shape[0], grid):
                row = rows[ri]
                seg = torch.full((chunk + k - 1 + slack,), float("nan"), dtype=x.dtype)
                seg[:need][inside] = row[torch.arange(need)[inside] + base]
                seg[halo] = row[_boundary_index(torch.tensor(halo, dtype=torch.long) + base,
                                                f_in, mode)]
                res = torch.full((chunk + slack,), float("nan"), dtype=x.dtype)
                taken = []
                for tid in range(threads):
                    for i0 in range(tid * r, live, threads * r):
                        words = -(-n // a)
                        assert i0 % a == 0 and i0 + words * a <= seg.shape[-1]
                        staged = seg[i0 : i0 + words * a].float()
                        medians = sn.core_medians_plain(staged[:n, None], (k,), r)[:, 0]
                        assert i0 + r <= res.shape[-1]
                        res[i0 : i0 + r] = medians.to(x.dtype)
                        taken.append(i0)
                assert sorted(taken) == list(range(0, live, r))
                out[ri, j0 : j0 + live] = res[:live]
                done.append((ri, j0))
    assert sorted(done) == sorted((ri, j0) for ri in range(rows.shape[0])
                                  for j0 in range(0, f_out, chunk))
    return out.reshape(x.shape[:-1] + (f_out,))


def _freq_core_input(rng, rows: int, f_in: int) -> np.ndarray:
    """Tie-heavy rows (8 levels) with +inf and -inf samples among them."""
    x = _levels(rng, (rows, f_in), ties=True)
    x[rng.random((rows, f_in)) < 0.05] = np.inf
    x[rng.random((rows, f_in)) < 0.05] = -np.inf
    return x


@pytest.mark.parametrize("mode", FREQ_MODES)
@pytest.mark.parametrize("k", [k for k in FREQ_KS if k <= 31])
def test_freq_core_matches_the_twin_and_zen_tpu(k, mode):
    """K2's shared core up to 31 taps (33 to 63: test_torch_freq_core_
    wide.py), ``check_freq_core``."""
    check_freq_core(k, mode)


def check_freq_core(k: int, mode: str) -> None:
    """K2's shared core, its plain version (``sliding_median_boundary_
    core_plain``) and the kernel's thread mapping emulated step for step,
    at every R it is built for at this K, bitwise ``sliding_median_
    boundary_plain`` and zen_tpu's Pallas frequency median in interpret
    mode (``sliding_median_boundary_pallas``; 'valid' the padded
    ``sliding_median_last_axis_pallas``), on tie-heavy rows with +-inf
    samples and 37 outputs a row (a multiple of no R); K = 1 and 3 have
    no shape (the per-output network takes them)."""
    from jax.experimental.pallas import tpu as pltpu

    from zen_tpu.ops import median_pallas as mp

    f_out = 37
    f_in = f_out + (k - 1 if mode == "valid" else 0)
    x = _freq_core_input(np.random.default_rng(10 * k + FREQ_MODES.index(mode)), 3, f_in)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(mp.sliding_median_last_axis_pallas(x, k) if mode == "valid"
                            else mp.sliding_median_boundary_pallas(x, k, mode))
    xt = torch.from_numpy(x)
    want = mc.sliding_median_boundary_plain(xt, k, mode)
    np.testing.assert_array_equal(want.numpy(), pallas)
    runs = mc.freq_core_runs(k)
    assert (runs == ()) == (k < 5)
    assert all(f_out % r for r in runs)
    for r in runs:
        assert torch.equal(mc.sliding_median_boundary_core_plain(xt, k, mode, r), want), r
        assert torch.equal(emulate_freq_core(xt, k, mode, r), want), r


@pytest.mark.parametrize("mode", FREQ_MODES)
def test_freq_core_bf16_and_chunks(mode):
    """bf16 samples go through float and back and select the twin's bits,
    at K = 13 (R = 3 and 4) and K = 31 (R = 6 and 8), on rows of one block
    (a ragged last run) and of three blocks (2049 outputs: chunks of 683,
    each with a ragged last run), and at K = 47 (R = 6 and 8, the hop-1024
    step's width) on those three blocks."""
    rng = np.random.default_rng(20 + FREQ_MODES.index(mode))
    for k, f_out in ((13, 131), (31, 2049), (47, 2049)):
        f_in = f_out + (k - 1 if mode == "valid" else 0)
        x = _tensor(_freq_core_input(rng, 2, f_in), torch.bfloat16)
        want = mc.sliding_median_boundary_plain(x, k, mode)
        for r in mc.freq_core_runs(k):
            got = mc.sliding_median_boundary_core_plain(x, k, mode, r)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, want), (k, r)
            assert torch.equal(emulate_freq_core(x, k, mode, r), want), (k, r)


def test_freq_core_shapes_are_the_one_run_shapes():
    """K2's core takes every one-run shape of core_shapes up to 63 taps
    (its window is one run of K samples), listed for its launcher's switch
    in zen_core.cuh and split over FREQ_CORE_PARTS sources (csrc/
    median_freq_core_p*.cu, one a part); K1's shapes and ids stay as they
    were."""
    ids = sn.freq_core_shape_ids()
    shapes = sn.core_shapes()
    assert [shapes[q] for q in ids] == [
        ((k,), r) for k in range(5, sn.FREQ_MAX_TAPS + 1, 2) for r in mc.freq_core_runs(k)]
    assert len(ids) == 59 and mc.freq_core_runs(13) == (3, 4) and mc.freq_core_runs(31) == (6, 8)
    assert mc.freq_core_runs(47) == mc.freq_core_runs(63) == (6, 8) and not mc.freq_core_runs(65)
    text = sn.emit_core_header()
    listed = re.search(r"#define ZEN_CORE_FOR_EACH_FREQ_SHAPE\(X\) (.*)", text).group(1)
    assert [int(v[2:-1]) for v in listed.split()] == list(ids)
    assert f"#define ZEN_CORE_FREQ_PARTS {sn.FREQ_CORE_PARTS}\n" in text
    by_part = []
    for q in range(sn.FREQ_CORE_PARTS):
        part = re.search(rf"#define ZEN_CORE_FOR_EACH_FREQ_SHAPE_OF_PART_{q}\(X\) (.*)",
                         text).group(1)
        by_part += [int(v[2:-1]) for v in part.split()]
        assert all(sn.freq_core_part(int(v[2:-1])) == q for v in part.split())
    assert sorted(by_part) == list(ids)
    sources = sorted(p.name for p in _build.CSRC.glob("median_freq_core_p*.cu"))
    assert sources == [f"median_freq_core_p{q}.cu" for q in range(sn.FREQ_CORE_PARTS)]
    assert sn.core_minmax_per_output((13,), 3) == 26.0 and sn.minmax_count(13) == 66


def test_freq_network_form_per_geometry():
    """``freq_network_form``'s pick at each path's geometry: the shared
    core wherever (K,) is built and the grid (a block a row chunk) has
    FREQ_CORE_MIN_BLOCKS blocks, at the R whose block issues the fewest
    min/max, and from FREQ_CORE_WIDE_TAPS on at any row count; the
    per-output network on the latency rows below it (beat-track's 64 rows,
    hop 32's K = 1), where no shape is built (K = 3) and below
    FREQ_CORE_MIN_TAPS (K = 5, where the card ran the network faster)."""
    form = mc.freq_network_form
    assert form(13, 8192, 513, "reflect") == ("core", 3)  # the 512-stream block
    assert form(13, 8192, 1024, "edge") == ("core", 4)  # its replicate border
    assert form(13, 8192, 1036, "valid") == ("core", 4)  # its valid border
    assert form(13, 2048, 513, "reflect") == ("core", 3)  # the 64-stream fleet
    assert form(13, 643, 513, "reflect") == ("core", 3)  # the clip's pass 2
    assert form(13, 41_355, 513, "wrap") == ("core", 3)  # the track's pass 2, median2d fl 13
    assert form(13, 322, 513, "reflect") == ("core", 3)  # an sp=4 shard's pass 2
    assert form(13, 64, 513, "reflect") == ("network", 1)  # beat-track
    assert form(1, 32, 65, "reflect") == ("network", 1)  # hop 32
    assert form(3, 8192, 513, "reflect") == ("network", 1)  # no shape at K = 3
    assert mc.freq_core_runs(5) == (2,) and form(5, 8192, 513, "reflect") == ("network", 1)
    assert form(7, 8192, 513, "reflect") == ("core", 3) and mc.FREQ_CORE_MIN_TAPS == 7
    assert form(13, 263, 513, "reflect") == ("network", 1) and mc.FREQ_CORE_MIN_BLOCKS == 264
    # from FREQ_CORE_WIDE_TAPS on the core takes any row count, at its
    # smaller R (6), which the card ran fastest on the few rows and the many
    assert mc.FREQ_CORE_WIDE_TAPS == 33
    for k, rows, f_in, mode in ((47, 32, 2049, "reflect"),  # the hop-1024 step, B = 32
                                (47, 1, 2049, "reflect"),  # and B = 1
                                (33, 64, 513, "reflect"),  # beat-track's rows
                                (47, 2048, 513, "reflect"), (63, 37, 4096, "wrap")):
        assert form(k, rows, f_in, mode) == ("core", 6) == ("core", min(mc.freq_core_runs(k)))
    # the issue counts behind the R: 513 bins in 171 runs of 3 (6 warp
    # passes of 78 min/max) or 129 of 4 (5 of 100); 1024 in 342 or 256
    assert mc.freq_core_issue(13, 513, 3) == 6 * 78 < mc.freq_core_issue(13, 513, 4) == 5 * 100
    assert mc.freq_core_issue(13, 1024, 4) == 8 * 100 < mc.freq_core_issue(13, 1024, 3) == 11 * 78
    assert mc.freq_core_issue(13, 513, 1) == 17 * sn.minmax_count(13)


def test_freq_core_refuses_unbuilt_shapes():
    """A shape the kernel is not built for raises, never falls back."""
    assert mc._freq_core_shape(13, 3) == sn.core_shape_id((13,), 3)
    for k, r in ((13, 2), (3, 2), (33, 4)):
        with pytest.raises(mc.ZenError, match="no shared core"):
            mc._freq_core_shape(k, r)


def test_smoke_labels_k2_shared_core():
    """chip_smoke.py's launch labels: a K2 network call that takes the
    shared core is FREQ_CORE ('network@core'), counted on the network
    route too; one that takes the per-output network stays 'network';
    by_route drops the FREQ_CORE key; the kernels line names the core's
    own source."""
    import chip_smoke as cs

    sms = mc.H100_SMS
    assert cs.freq_call_label(13, 8192, 513, "reflect", sms) == cs.FREQ_CORE
    assert cs.freq_call_label(13, 643, 513, "reflect", sms) == cs.FREQ_CORE
    assert cs.freq_call_label(13, 64, 513, "reflect", sms) == "network"  # beat-track
    assert cs.freq_call_label(1, 32, 65, "reflect", sms) == "network"  # hop 32
    assert cs.freq_call_label(47, 32, 2049, "reflect", sms) == cs.FREQ_CORE  # hop 1024
    assert cs.freq_call_label(47, 1, 2049, "reflect", sms) == cs.FREQ_CORE  # and its B = 1
    key = f"sliding_median_boundary/{cs.FREQ_CORE}"
    assert cs.launch_keys(key) == (key, "sliding_median_boundary/network")
    assert cs.by_route({"sliding_median_boundary/network": 3, key: 2}) == {
        "sliding_median_boundary/network": 3}
    assert cs.SOURCES[key] == "zen_tpu_torch/csrc/median_freq_core.cu"
    assert (_build.CSRC.parents[1] / cs.SOURCES[key]).exists()
