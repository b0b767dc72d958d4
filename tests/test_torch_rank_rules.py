"""The host side of the wide median routes, which needs no card: K1's
multiplicity table and staged rows, each route's staging limits and
shared memory as the launchers reckon it, K2's crossover, the cost rule
between the rank, warp and select routes at the paths' rows, the select
geometry, K2's tiles, the library hash over csrc/*.cuh and the split
builds, and chip_smoke.py's launch labels.
"""
import pytest

torch = pytest.importorskip("torch")

from zen_tpu_torch.ops import _build  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    K12801,
    K25601,
    K93,
)


def test_time_rank_table_counts_each_offset_between_zero_pads():
    lo, span, table = mc.time_rank_table((-3, 0, 0, -1, 0))
    pad = mc.TIME_RANK_RUN - 1
    assert (lo, span, len(table)) == (-3, 4, 4 + 2 * pad)
    assert table[pad : pad + 4] == (1, 0, 1, 3)
    assert sum(table) == 5 and not any(table[:pad]) and not any(table[pad + 4 :])


def test_time_rank_rows_are_the_taps_of_the_run():
    assert mc.time_rank_rows(K93, 1) == tuple(o + 183 for o in K93)
    rows = mc.time_rank_rows(K93, 32)
    assert len(rows) == 155 and rows == tuple(sorted(rows))
    assert rows == tuple(sorted({o + 183 + i for o in K93 for i in range(32)}))
    assert mc.time_rank_rows(tuple(range(-200, 201)), 32) == tuple(range(432))
    assert mc.time_rank_rows((-3, 0, 0, 0, 0), 2) == (0, 1, 3, 4)


def _launch_rank_bytes(offsets, run):
    """(bytes, table in shared memory) of launch_rank (csrc/median_time.cu),
    from the source's own arithmetic: key_count(staged) keys of 8 bytes,
    and the span + 2 (kRun - 1) table ints beside them where both fit
    227 KB. The wrapper reckons the keys (``time_rank_keys``)."""
    staged = len(mc.time_rank_rows(offsets, run))
    keys = 8 * max(32, 1 << (staged - 1).bit_length())
    assert mc.time_rank_keys(offsets, run) == keys
    table = 4 * (mc.time_rank_table(offsets)[1] + 2 * 31)
    return (keys + table, True) if keys + table <= 232_448 else (keys, False)


def test_time_routes_and_staging_limit():
    """The network up to 63 taps, the rank route from 65 at any span and
    every tap count: its reckoning of a block's shared memory is
    launch_rank's, the table leaves shared memory where it no longer fits
    beside the keys, the run shrinks, down to one row, where the keys do
    not fit, and past one row's keys the sort cannot take the call (the
    select route does)."""
    assert mc.time_route(tuple(range(-62, 1))) == "register"
    assert mc.time_route(tuple(range(-64, 1))) == "rank"
    assert mc.time_route(tuple(range(-12286, 1))) == "rank"
    for far in ((-16352,) + tuple(range(-65, 1)), (-16353,) + tuple(range(-65, 1)),
                (-70000,) + tuple(range(-65, 1)), (-(1 << 30),) + tuple(range(-65, 1))):
        assert mc.time_route(far) == "rank"
    # the keys of a run of 32 and a table of 16,416 ints: 67,712 bytes
    far = (-16353,) + tuple(range(-65, 1))
    assert mc.time_rank_run(far) == 32
    assert _launch_rank_bytes(far, 32) == (67_712, True)
    # past a span of about 57,000 rows the table stays in device memory
    far = (-70000,) + tuple(range(-65, 1))
    assert _launch_rank_bytes(far, 32) == (2048, False)
    # a call clamps the taps that read only fill next to V: on 300 rows the
    # far tap lands at row -300, and the table is 363 ints
    near = mc.time_rank_offsets(far, 0, 300)
    assert near == (-300,) + tuple(range(-65, 1))
    assert _launch_rank_bytes(near, 32) == (3500, True)
    # runs shrink while the keys do not fit: 601 taps 40 apart stage 19,232
    # rows at 32 (32,768 keys), 9,616 at 16 (16,384 keys and the table)
    spread = tuple(range(-24000, 1, 40))
    assert len(mc.time_rank_rows(spread, 32)) == 19_232
    assert mc.time_rank_keys(spread, 32) > mc.SMEM_OPTIN
    assert mc.time_rank_run(spread) == 16
    assert _launch_rank_bytes(spread, 16)[0] <= mc.SMEM_OPTIN
    assert mc.time_rank_plan(spread, 24000, 24040)[1:] == (16, True)
    # 192 kHz hop 1 (12,801 taps in two runs): a run of 32 stages 12,863
    # rows, 16,384 keys beside a table in device memory
    assert mc.time_rank_run(K12801) == 32
    assert _launch_rank_bytes(K12801, 32) == (131_072, False)
    assert mc.time_rank_plan(K12801, 25599, 25631)[1:] == (32, True)
    # 384 kHz hop 1 (25,601 taps): one row stages 25,601, 32,768 keys: only
    # the select route takes it
    assert mc.time_rank_run(K25601) == 1
    assert mc.time_rank_plan(K25601, 51199, 51231)[1:] == (1, False)
    assert mc.time_call_route(K25601, 51199, 51231, 1, 3) == "select"
    # K1's widest tap set, scattered: one row a block, its distinct taps,
    # 2^21 keys for a sort; the select route reads its order bits through L2
    widest = tuple(range(-3 * (mc.MAX_TIME_TAPS - 1), 1, 3))
    assert len(widest) == mc.MAX_TIME_TAPS and mc.time_rank_run(widest) == 1
    assert mc.time_rank_keys(widest, 1) == mc.KEY_BYTES * mc.RANK_STORE_MAX_KEYS
    assert mc.time_rank_plan(widest, 0, 3 * mc.MAX_TIME_TAPS)[1:] == (1, False)
    assert mc.time_select_plan(widest, 0, 3 * mc.MAX_TIME_TAPS, 1, 1)[1:] == (
        1, mc.MAX_TIME_TAPS, mc.SELECT_MAX_THREADS)
    assert 4 * mc.MAX_TIME_TAPS > mc.SELECT_SHARED_BYTES
    # the steps keep merge_sort's layout (a key's room after every 8) and
    # the rank of each relative row (span + run - 1 ints): median2d's fl 93
    # at a run of 352 stages 444 rows (512 keys, 4,608 in merge_sort's room)
    fl93 = tuple(range(-92, 1))
    assert mc.time_rank_bytes(fl93, 352, 1) == 8 * 512
    # 128 threads merge 512 keys a run each: one buffer; 16 threads a
    # column (8 columns) would merge 256 keys two runs each, but a warp
    # sorts the column's 256 in registers: one buffer too
    assert mc.time_rank_bytes(fl93, 352, 11) == 9 * 512 + 4 * (93 + 351) + 4 * 352
    # four adjacent columns: each its own keys and ranks, the medians of all
    assert mc.time_rank_bytes(fl93, 160, 5, 4) == 4 * (9 * 256 + 4 * (93 + 159)) + 4 * 640
    assert mc.time_rank_bytes(fl93, 160, 9, 8) == 8 * (9 * 256 + 4 * (93 + 159)) + 4 * 1280
    # past one warp's 256 keys, 16 threads a column merging 512 keys take a second buffer
    assert mc.time_rank_bytes(fl93, 352, 11, 8) == 8 * (2 * 9 * 512 + 4 * (93 + 351)) + 4 * 2816
    # a span of 70,001 rows: no inverse fits beside the keys, so the call
    # keeps the walk from rank 0 at every lane run
    assert mc.time_rank_bytes(far, 96, 3) > mc.SMEM_OPTIN
    assert mc.time_rank_geometry(far, 70_000, 70_300, 1, 9)[1] == 1
    for offsets, start, t_v, streams, f in ((K93, 183, 215, 1, 65), (fl93, 92, 41_447, 1, 513),
                                            (spread, 24_000, 24_040, 1, 2)):
        run, lane_run, cols = mc.time_rank_geometry(offsets, start, t_v, streams, f)
        assert lane_run in mc.RANK_LANE_RUNS and run <= t_v - start
        assert cols in mc.TIME_RANK_COLUMNS and (cols == 1 or lane_run > 1)
        assert run <= (mc.TIME_RANK_RUN if lane_run == 1 else
                       mc.TIME_RANK_THREADS // cols * lane_run)
        planned = mc.time_rank_offsets(offsets, start, t_v)
        assert mc.time_rank_bytes(planned, run, lane_run, cols) <= mc.SMEM_OPTIN


def test_freq_route_crossover_and_staging_limit():
    """K2 runs its network up to FREQ_NETWORK_MAX_TAPS below
    FREQ_RANK_MIN_TAPS and ranks from the crossover on, at every K up to
    MAX_FREQ_TAPS: in shared memory up to the widest K whose keys fit at
    the smallest tile, on the key store beyond, where a unit of
    RANK_STORE_THREADS outputs at MAX_FREQ_TAPS fills a whole slice."""
    k_star = mc.FREQ_RANK_MIN_TAPS
    assert k_star % 2 == 1 and 1 < k_star <= mc.FREQ_NETWORK_MAX_TAPS + 2
    for k in range(1, k_star, 2):
        assert mc.freq_route(k) == "network"
    widest = mc.SMEM_OPTIN // mc.KEY_BYTES  # keys of one block
    last = max(k for k in range(16001, 16400, 2) if mc.freq_rank_tile(k))
    assert last == 16_353
    assert mc._pow2_at_least(mc.freq_rank_tile(last) + last - 1) <= widest
    for k in (k_star, 93, 187, 257, last):
        assert (mc.freq_route(k), mc.freq_rank_store(k)) == ("rank", "shared")
    for k in (last + 2, 57_857, 65_537, mc.MAX_FREQ_TAPS):
        assert (mc.freq_route(k), mc.freq_rank_store(k)) == ("rank", "scratch")
    assert mc._key_count(mc.RANK_STORE_THREADS + mc.MAX_FREQ_TAPS - 1) == mc.RANK_STORE_MAX_KEYS
    assert mc.MAX_FREQ_TAPS % 2 == 1 and mc.MAX_TIME_TAPS % 2 == 1
    assert min(mc.MAX_FREQ_TAPS, mc.MAX_TIME_TAPS) > 1 << 20


# the rows whose outputs are too few to share a sort (they lost to
# torch.kthvalue on the key store or the shared sort) and the paths' rank
# rows, as benches/rank_store.py times them: K1 (offsets, start, t_v,
# streams, f), K2 (k, rows, f_in, mode)
SELECT_ROWS = [
    ("time", (K12801, 25_599, 25_631, 1, 3)),  # 192 kHz hop 1, B=32
    ("freq", (mc.MAX_FREQ_TAPS, 2, 64, "wrap")),
    ("time", (tuple(range(-20_000, 1)), 0, 20_100, 1, 9)),
    ("time", (K25601, 51_199, 51_200, 1, 3)),  # 384 kHz hop 1, B=1
    ("freq", (57_857, 1, 58_112, "valid")),
    ("time", (K25601, 51_199, 51_231, 1, 3)),  # B=32
    ("freq", (65_537, 2, 65_792, "valid")),
]


SORT_ROWS = [
    ("freq", (187, 8, 8193, "reflect")),  # pitch-track
    ("freq", (187, 41, 8193, "reflect")),  # offline pass 1
    ("freq", (187, 2585, 8193, "reflect")),  # the 4-minute track's pass 1
    ("time", (tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513)),  # median2d fl 93
    ("freq", (187, 2585, 8193, "wrap")),  # median2d fl 187
    ("freq", (16_385, 4, 8193, "reflect")),  # K2's store: 8193 outputs a row
    ("freq", (257, 32, 2049, "reflect")),  # fs 8000 hop 1024
]
# the streaming steps' rows that left the sort: hop 32's K = 93 (K1) takes
# the warp route (test_torch_warp.py, WARP_ROWS), hop 1024's K = 47 (K2)
# the network's shared core: K2 (k, rows, f_in, mode), B = 32 and B = 1
NETWORK_ROWS = [(47, 32, 2049, "reflect"), (47, 1, 2049, "reflect")]


def _pick(kind, args):
    return (mc.time_call_route if kind == "time" else mc.freq_call_route)(*args)


@pytest.mark.parametrize("kind,args", SELECT_ROWS)
def test_cost_rule_takes_few_output_rows_to_select(kind, args):
    """The seven rows take the select route on an H100's 132 SMs (on the
    card each ran 1.7-1500x under its torch.kthvalue: PERF.md), their
    blocks an output, or a run of 32 where 180,900 outputs fill the card."""
    assert _pick(kind, args) == "select"
    if kind == "time":
        _, run, staged, threads = mc.time_select_plan(*args)
        t_out, f = args[2] - args[1], args[4]
        assert run == (32 if t_out * f > 32 * mc.H100_SMS else 1)
    else:
        tile, staged, threads = mc.freq_select_plan(*args)
        assert tile == 1 and staged == min(args[0], args[2])
    assert threads == mc.select_threads(staged)


@pytest.mark.parametrize("kind,args", SORT_ROWS)
def test_cost_rule_keeps_shared_sorts(kind, args):
    """The paths' rank rows and K2's store row keep the sort, which the
    card measured 4-80x faster than select on each (chip_smoke phase 3),
    and K1's (median2d's 21 M outputs) faster than the warp route."""
    assert _pick(kind, args) == "rank"
    costs = (mc.time_route_costs if kind == "time" else mc.freq_route_costs)(*args)
    sort, pick = costs[:2]
    assert sort < pick
    if kind == "time":
        assert sort < costs[2]


@pytest.mark.parametrize("args", NETWORK_ROWS)
def test_hop1024_step_takes_the_network_core(args):
    """The hop-1024 step's K = 47 takes K2's network route, now that it
    reaches 63 taps, in its shared-core form (``freq_network_form``)."""
    assert mc.freq_call_route(*args) == "network" and args[0] < mc.FREQ_RANK_MIN_TAPS
    assert mc.freq_network_form(*args)[0] == "core"


def test_select_geometry_and_layout():
    """A select block: power-of-two threads, about 16 staged samples each,
    64 to 1024; its order bits and bins in shared memory where both fit
    (the bins only at 1024 threads), else the bits, else the bins."""
    assert [mc.select_threads(s) for s in (1, 64, 93, 1000, 12_801, 70_001)] == [
        64, 64, 64, 64, 1024, 1024]
    assert mc.select_shared_bins(1024) and not mc.select_shared_bins(64)
    assert mc.select_layout(25_601, 1024) == (True, True, 4 * 25_601 + 64 * 1024)
    assert mc.select_layout(57_857, 1024) == (True, False, 4 * 57_857)
    assert mc.select_layout(65_537, 1024) == (False, True, 64 * 1024)
    assert mc.select_layout(442, 64, False) == (True, False, 4 * 442)
    # K1's runs halve until the call fills the SMs; K2's tiles too, and
    # the grid's second dimension caps them from below
    assert mc.time_select_plan(K93, 183, 215, 1, 65)[1] == 8
    assert mc.freq_select_plan(47, 1, 2049, "reflect")[0] == 8  # 257 blocks; 16: 129
    assert mc.freq_select_plan(13, 1, 10_000_000, "reflect")[0] == 256
    # a run of one over distinct taps counts each staged row once
    assert mc.time_select_unit(K25601, 1) and not mc.time_select_unit(K25601, 2)
    assert not mc.time_select_unit((0, 0, -1), 1)


@pytest.mark.parametrize("k", [3, 13, 47, 187, 257, 401, 4001])
def test_freq_rank_tile_minimizes_walk_plus_sort(k):
    """freq_rank_tile (the copy mirror's tile, and whether a tile's keys
    fit at all) minimizes the walk from rank 0 plus the sort per output;
    freq_rank_plan, a call's geometry, minimizes sort_us over every tile
    and run that fits a block: at run 1 that tile, past
    it runs of RANK_LANE_RUNS outputs, as many walking threads as a key
    count's staged outputs allow up to WARP_STEPS_THREADS, the block's
    threads freq_rank_threads': whole warps for the walkers, at least
    freq_steps_threads."""
    tile = mc.freq_rank_tile(k)
    assert tile in mc.FREQ_RANK_TILES

    def cost(t):
        n = mc._pow2_at_least(t + k - 1)
        lg = n.bit_length() - 1
        return (t + k - 1) / 2 + (n // 2) * lg * (lg + 1) / t

    assert cost(tile) == min(cost(t) for t in mc.FREQ_RANK_TILES)
    for rows, f_in in ((8, 8193), (32, 2049), (2585, 8193)):
        plans = mc._freq_rank_plans(k, rows, f_in, "reflect", mc.H100_SMS)
        assert mc.freq_rank_plan(k, rows, f_in, "reflect") == min(plans)[1:]
        for us, t, run in plans:
            threads = mc.freq_rank_threads(k, t, run)
            n = mc._key_count(t + k - 1)
            assert t % run == 0 and t // run <= threads
            assert (threads == t == tile if run == 1 else
                    threads == max(32 * -(-(t // run) // 32), mc.freq_steps_threads(n)))
            assert threads <= mc.WARP_STEPS_THREADS
            assert t + k - 1 <= n
            assert run in mc.RANK_LANE_RUNS and mc.freq_rank_bytes(k, t, run) <= mc.SMEM_OPTIN
            seg = min(t, f_in) + k - 1
            assert us == mc.sort_us(rows * -(-f_in // t), seg, threads,
                                    mc.freq_rank_bytes(k, t, run), mc.H100_SMS, run=run,
                                    step=seg / k + 1)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh names another library, so a stale build is
    never reused."""
    for src in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "rank_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_split_builds_are_libraries_of_their_own():
    """ZEN_RANK_CUT 1 and 2 (chip_smoke's split of a rank block's time)
    name libraries beside the full one, never in its place."""
    paths = {_build.library_path(cut) for cut in (0, 1, 2)}
    assert len(paths) == 3 and _build.library_path() == _build.library_path(0)
    with pytest.raises(ValueError, match="ZEN_RANK_CUT"):
        _build.library(3)


def test_smoke_labels_the_steps_kernel():
    """chip_smoke.py's launch labels: the many-output rank calls (the
    offline passes 1, median2d's fl 93) take the steps kernel (STEPS), the
    streams' latency rows left the rank route (hop 32's K1 for the warp
    route, hop 1024's K2 for the network's shared core), pitch-track's K2
    walks from rank 0; a STEPS or SCRATCH launch
    counts on its kernel's rank route too; ``by_route`` drops the STEPS
    keys, which a count from the configs alone does not hold."""
    import chip_smoke as cs

    sms = mc.H100_SMS
    assert cs.freq_call_label(187, 2585, 8193, "reflect", sms) == cs.STEPS
    assert cs.freq_call_label(187, 41, 8193, "reflect", sms) == cs.STEPS
    assert cs.freq_call_label(187, 2585, 8193, "wrap", sms) == cs.STEPS
    for rows in (1, 32):  # hop 1024's K2, B=1 and B=32: the network's shared core
        assert cs.freq_call_label(47, rows, 2049, "reflect", sms) == cs.FREQ_CORE
    assert cs.freq_call_label(187, 8, 8193, "reflect", sms) == "rank"  # pitch-track
    assert cs.freq_call_label(16_385, 4, 8193, "reflect", sms) == cs.SCRATCH
    # K2's network route: the 64-stream fleet's 2048 rows take its shared
    # core (FREQ_CORE), beat-track's 64 the per-output network
    assert cs.freq_call_label(13, 2048, 513, "reflect", sms) == cs.FREQ_CORE
    assert cs.freq_call_label(13, 64, 513, "reflect", sms) == "network"
    k93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # hop 32, B=32 and B=1
    assert cs.time_call_label(k93, 183, 183 + 32, 1, 65, sms) == "warp"
    assert cs.time_call_label(k93, 183, 183 + 1, 1, 65, sms) == "warp"
    assert cs.time_call_label(tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513, sms) == cs.STEPS
    # the clip's pass 2 takes K1's register route, in its shared-core form
    assert cs.time_call_label(tuple(range(-5, 6)), 0, 643, 1, 513, sms) == cs.CORE
    assert cs.launch_keys(f"tap_median_time/{cs.STEPS}") == (
        f"tap_median_time/{cs.STEPS}", "tap_median_time/rank")
    assert cs.launch_keys(f"sliding_median_boundary/{cs.SCRATCH}")[1] == (
        "sliding_median_boundary/rank")
    assert cs.launch_keys("sliding_median_boundary/network") == ("sliding_median_boundary/network",)
    counts = {"tap_median_time/rank": 2, f"tap_median_time/{cs.STEPS}": 1,
              f"sliding_median_boundary/{cs.SCRATCH}": 3}
    assert cs.by_route(counts) == {"tap_median_time/rank": 2,
                                   f"sliding_median_boundary/{cs.SCRATCH}": 3}
