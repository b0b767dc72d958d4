"""K1's warp route (a warp an output) on the CPU.

The CUDA kernel (``tap_median_time_warp_kernel`` of csrc/median_time.cu,
its sort ``zen_rank::warp_sort`` of csrc/rank_select.cuh) runs only on
the card (tests/test_torch_cuda.py), so it is emulated here in torch
step for step from the wrapper's own choices (``time_warp_slots``, the
planned offsets ``time_rank_offsets``): lane l holds taps l, l + 32, ...
as order bits, ~0 past K; each stage of the bitonic network pairs two
slots of a lane or, from a stride of S on, a slot with the same slot of
lane ^ (stride / S), as ``__shfl_xor_sync`` does; lane h // S's slot h %
S is the median. Held BITWISE against the plain twin
(``tap_median_time_plain``) and zen_tpu's time median (its plain
reference ``zen_tpu.ops.median.sliding_median``, as the rank route's
tests hold theirs), at hop 32's K = 93, on a 127-tap set, at the eight
slots' K = 187 and 255, on tie-heavy, duplicated, far-span and bf16
inputs. The host side (slots, the cost rule's picks, the launch
arguments) needs no card either.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from zen_tpu.ops.median import sliding_median as jax_sliding_median  # noqa: E402
from zen_tpu_torch.ops import _build  # noqa: E402
from zen_tpu_torch.ops import median_cuda as mc  # noqa: E402
from rank_emulation import (  # noqa: E402
    _levels,
    _order_bits,
    _tensor,
    _value_of_bits,
    one_torch_thread,  # noqa: F401 (autouse)
)

LANES = 32
PAD = 0xFFFFFFFF  # ~0u: above every tap's order bits
K93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32, the causal wrap
K127 = tuple(range(-126, 1))  # four slots a lane, one pad
K187 = tuple(range(-93, 94))  # eight slots a lane
K255 = tuple(range(-254, 1))  # eight slots a lane, one pad


def warp_stages(slots: int) -> list:
    """The network's (size, stride) stages in the order warp_sort runs
    them (its template recursion): sizes 2 .. 32 S, strides size / 2 .. 1."""
    stages, size = [], 2
    while size <= LANES * slots:
        stride = size // 2
        while stride >= 1:
            stages.append((size, stride))
            stride //= 2
        size *= 2
    return stages


def warp_sort(v: torch.Tensor) -> torch.Tensor:
    """zen_rank::warp_sort on v [N, 32, S] (int64 order bits; a warp an
    N): element e = lane * S + j. A stride under S: in each lane, slots j
    (bit `stride` of j clear) and j | stride take min and max, ascending
    where bit `size` of lane * S + j is clear; from S up: every slot meets
    the same slot of lane ^ (stride / S) (the shuffle), the lane keeping
    the min where (bit stride / S of the lane clear) == (bit size / S of
    the lane clear)."""
    slots = v.shape[-1]
    lane = torch.arange(LANES)[:, None]
    for size, stride in warp_stages(slots):
        if stride >= slots:
            m = stride // slots
            other = v[:, torch.arange(LANES) ^ m, :]  # __shfl_xor_sync(v[j], m)
            up = (lane & (size // slots)) == 0
            keep_min = ((lane & m) == 0) == up
            v = torch.where(keep_min, torch.minimum(v, other), torch.maximum(v, other))
        else:
            v = v.clone()
            for j in range(slots):
                if j & stride:
                    continue
                up = ((lane[:, 0] * slots + j) & size) == 0
                lo = torch.minimum(v[:, :, j], v[:, :, j | stride])
                hi = torch.maximum(v[:, :, j], v[:, :, j | stride])
                v[:, :, j], v[:, :, j | stride] = (torch.where(up, lo, hi),
                                                     torch.where(up, hi, lo))
    return v


def emulate_time_warp(a, b, offsets, start, fill=0.0) -> torch.Tensor:
    """The warp route on tap_median_time's arguments, as the kernel runs
    it: one warp an output (c, i, col); lane l, slot j reads tap j * 32 + l
    through the planned offsets (row start + i + o of V = a ++ b, ``fill``
    in the inputs' dtype outside), ~0 past K; warp_sort; lane h // S, slot
    h % S, h = (K - 1) / 2."""
    offsets = mc._int_offsets(tuple(offsets))
    k = len(offsets)
    slots = mc.time_warp_slots(k)
    v = torch.cat([a, b], dim=-2)
    t_v = v.shape[-2]
    t_out = t_v - start
    planned = torch.tensor(mc.time_rank_offsets(offsets, start, t_v))
    q = torch.arange(slots)[None, :] * LANES + torch.arange(LANES)[:, None]  # [32, S]
    live = q < k
    rows = start + torch.arange(t_out)[:, None, None] + planned[q.clamp(max=k - 1)]
    inside = (rows >= 0) & (rows < t_v)
    fill_t = torch.tensor(fill, dtype=a.dtype)
    taps = torch.where(inside, v[..., rows.clamp(0, t_v - 1), :].movedim(-1, -4), fill_t)
    # taps [..., F, t_out, 32, S] -> a warp each
    bits = torch.where(live, _order_bits(taps), PAD)
    lead = bits.shape[:-2]
    ordered = warp_sort(bits.reshape(-1, LANES, slots))
    h = (k - 1) // 2
    med = _value_of_bits(ordered[:, h // slots, h % slots]).reshape(lead)
    return med.movedim(-2, -1).to(a.dtype)  # [..., t_out, F]


@pytest.mark.parametrize("slots", mc.WARP_SLOTS)
def test_warp_sort_orders_every_warp(slots):
    """The network sorts any 32 S values ascending (random ones, and a
    0-1 sample of the principle), and has log2 n (log2 n + 1) / 2 stages,
    those from a stride of S up across lanes: 28 and 15 at S = 4."""
    n = LANES * slots
    stages = warp_stages(slots)
    lg = n.bit_length() - 1
    assert len(stages) == lg * (lg + 1) // 2
    cross = sum(1 for _, stride in stages if stride >= slots)
    assert (len(stages), cross) == ((28, 15) if slots == 4 else (36, 15))
    g = torch.Generator().manual_seed(slots)
    v = torch.randint(0, 2**32, (64, n), generator=g, dtype=torch.int64)
    v[:16] = torch.randint(0, 2, (16, n), generator=g)
    got = warp_sort(v.reshape(-1, LANES, slots)).reshape(-1, n)
    assert torch.equal(got, v.sort(dim=-1).values)


def test_warp_slots_and_limits():
    """Four taps a lane up to 128, eight up to 256; the kernel's cap is
    read from its source, and the route starts past the register route."""
    assert [mc.time_warp_slots(k) for k in (65, 93, 127, 129, 187, 255, 257)] == [
        4, 4, 4, 8, 8, 8, None]
    text = (_build.CSRC / "median_time.cu").read_text()
    assert int(re.search(r"constexpr int kWarpMaxSlots = (\d+);", text).group(1)) == (
        mc.WARP_SLOTS[-1])
    assert mc.WARP_SLOTS[0] == 4 and mc.REGISTER_TAPS + 2 == 65
    assert mc.warp_us(65, 301, mc.H100_SMS) is None


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize(
    "a_shape,b_shape,offsets,start,fill",
    [((1, 183, 9), (1, 32, 9), K93, 183, 0.0),  # hop 32, B = 32
     ((2, 183, 7), (2, 1, 7), K93, 183, 0.0),  # hop 32, B = 1
     ((1, 126, 5), (1, 9, 5), K127, 126, float("inf")),  # 127 taps: one pad
     ((1, 60, 4), (1, 0, 4), K187, 0, 0.0),  # centered, fill past both ends
     ((1, 254, 3), (1, 4, 3), K255, 254, 0.0),  # eight slots, one pad
     ((1, 70, 6), (1, 3, 6), tuple(range(-69, 0)) + (0,) * 60, 3, 0.0),  # replicate's 0s
     ((1, 300, 3), (1, 0, 3), (-16353,) + tuple(range(-65, 1)), 0, 0.0),  # a far tap
     ((1, 40, 3), (1, 9, 3), (-70000,) + tuple(range(-32, 33)) + (70000,), 20,
      float("inf"))],  # far taps on both ends
)
def test_time_warp_emulation_matches_twin(a_shape, b_shape, offsets, start, fill, ties):
    rng = np.random.default_rng(len(offsets) + start)
    a = _tensor(_levels(rng, a_shape, ties), torch.float32)
    b = _tensor(_levels(rng, b_shape, ties), torch.float32)
    assert mc.time_route(offsets) == "rank" and mc.time_warp_slots(len(offsets))
    got = emulate_time_warp(a, b, offsets, start, fill)
    assert got.shape == (a_shape[0], a_shape[1] + b_shape[1] - start, a_shape[2])
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, start, fill))


@pytest.mark.parametrize("offsets,h,t", [(K93, 183, 32), (K127, 126, 9)])
def test_time_warp_emulation_matches_jax(offsets, h, t):
    """The emulation against zen_tpu's time median over the concat, tie-heavy."""
    rng = np.random.default_rng(h)
    a, b = _levels(rng, (2, h, 5), True), _levels(rng, (2, t, 5), True)
    want = np.asarray(jax_sliding_median(
        jnp.concatenate([a, b], axis=-2), offsets, -2, "zero")[..., h:, :])
    got = emulate_time_warp(_tensor(a, torch.float32), _tensor(b, torch.float32), offsets, h)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offsets,h", [(K93, 183), (K255, 254)])
def test_time_warp_emulation_bf16(offsets, h):
    """bf16 taps go through float and back and select the twin's bits;
    the fill rounds to bf16 first, as the wrapper rounds it."""
    rng = np.random.default_rng(23)
    a = _tensor(_levels(rng, (1, h, 6), False), torch.bfloat16)
    b = _tensor(_levels(rng, (1, 32, 6), True), torch.bfloat16)
    got = emulate_time_warp(a, b, offsets, h, 0.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mc.tap_median_time_plain(a, b, offsets, h, 0.3))


def test_time_warp_orders_signed_zeros_inf_and_nan_as_the_rank_route():
    """Order bits put -0.0 below +0.0 and NaN above +inf, as the rank
    route's keys do: the warp picks what a sort of the order bits picks."""
    x = torch.tensor([[0.0], [-0.0], [float("nan")], [float("inf")], [1.0]] * 23)
    a = x[torch.randperm(115, generator=torch.Generator().manual_seed(0))].reshape(1, 115, 1)
    offs = tuple(range(-92, 1))
    got = emulate_time_warp(a, a[:, :0], offs, 92)
    for i in range(got.shape[-2]):
        taps = a[0, 92 + i + torch.tensor(offs), 0]
        bits = _order_bits(taps).sort().values
        assert _value_of_bits(bits[46:47]).view(torch.int32) == got[0, i, 0:1].view(torch.int32)


# the streaming steps' few-output rows, which the warp route takes from
# the walk: K1 (offsets, start, t_v, streams, f)
WARP_ROWS = [
    (K93, 183, 215, 1, 65),  # hop 32, B = 32: 2080 outputs
    (K93, 183, 184, 1, 65),  # hop 32, B = 1: 65
]


@pytest.mark.parametrize("args", WARP_ROWS)
def test_cost_rule_takes_the_hop32_step_to_the_warp(args):
    """The hop-32 step's K = 93 takes the warp route on an H100's 132 SMs,
    priced under the walk and select; median2d's fl 93 (21 M outputs)
    keeps the steps."""
    sort, pick, warp = mc.time_route_costs(*args)
    assert mc.time_call_route(*args) == "warp"
    assert warp < sort and warp < pick
    fl93 = (tuple(range(-92, 1)), 92, 41_355 + 92, 1, 513)
    assert mc.time_call_route(*fl93) == "rank"
    assert mc.time_route_costs(*fl93)[2] > mc.time_route_costs(*fl93)[0]


def test_warp_route_arguments():
    """What the wrapper hands the warp kernel: the planned offsets (far
    taps next to V) on the device, K and the slots a lane; the route
    refuses a tap count past 256."""
    cpu = torch.device("cpu")
    name, (offs,), tail, k = mc._time_args(K93, 183, 183, 32, 1, 65, "warp", cpu)
    assert (name, tail, k) == ("zen_tap_median_time_warp", (4,), 93)
    assert offs.dtype == torch.int32 and offs.tolist() == list(K93)
    far = (-70000,) + tuple(range(-32, 33)) + (70000,)
    _, (offs,), tail, _ = mc._time_args(far, 20, 40, 9, 1, 3, "warp", cpu)
    assert offs.tolist() == list(mc.time_rank_offsets(far, 20, 49)) and tail == (4,)
    with pytest.raises(mc.ZenError, match="warp route"):
        mc._time_args(tuple(range(-300, 1)), 300, 301, 1, 1, 3, "warp", cpu)
    assert "warp" in mc.tap_median_time.routes
