"""PyTorch port, K2 and K2q: the row-streaming pool ``csrc/maxpool_rows.cu``.

- **A plain-torch emulation of the kernel** (``emulate_maxpool_rows``)
  follows its order for a :func:`pool_plan`: block ``b`` takes output rows
  ``b, b + grid, ...``; each row's four input rows (two runs of two adjacent
  rows) pass through a ring of ``stages`` stages, are max-reduced in
  16-byte chunks with a scalar tail (the scalar path is all tail), and the
  W-pair compaction runs thread by thread over the flattened row with C
  stride (``c`` stepped as the kernel steps it); the output row leaves in
  ``out_vec``-byte stores. Held against ``maxpool2_plain`` /
  ``maxpool2_q_plain`` and against the Pallas ``maxpool2_chain`` in
  interpret mode (f32 and ``fill=-128`` int8). Results must be equal: a max
  rounds nothing. A NaN in a bf16 or f32 window survives.
- **The plan** at all 20 K2/K2q launch shapes of the paths: every output
  row is taken by exactly one block, in one wave on 132 SMs, within 227 KB
  of shared memory a block, on the vector path.
- **Routing on a patched card**: ``build.function`` records what it is
  asked for and launches nothing. ``maxpool2`` (bf16, f32),
  ``maxpool2_f32`` and ``maxpool2_q`` reach the new entries with the plan's
  arguments and count on ``maxpool2_rows``; the ``*_direct`` functions reach
  ``csrc/maxpool.cu`` and count nothing.

The CUDA kernel is held against the plain versions on the card by
``chip_smoke.py`` (phase 2, every launch shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import build
from ctunet_tpu_torch.ops.kernels import conv3d as kc

torch.set_num_threads(2)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _volume(rng, shape, dtype):
    if dtype == torch.int8:
        return _t(rng.integers(-128, 128, shape, dtype=np.int8))
    return _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _plain(x):
    return (kc.maxpool2_q_plain(x) if x.dtype == torch.int8
            else kc.maxpool2_plain(x))


def emulate_maxpool_rows(x, plan):
    """``csrc/maxpool_rows.cu`` for ``plan`` in plain torch, in its order;
    asserts that every output row is written exactly once."""
    d, h, w, c = x.shape
    h2, n_out, row_el = h // 2, (w // 2) * c, w * c
    rows, isz = (d // 2) * h2, x.element_size()
    flat = x.reshape(-1)
    out = torch.empty(rows * n_out, dtype=x.dtype)
    written = torch.zeros(rows, dtype=torch.int64)
    nt = kc.POOL_THREADS

    def four_rows(r):  # runs (2oz + a, 2oy), (2oz + a, 2oy + 1), a = 0, 1
        oz, oy = divmod(r, h2)
        start = [((2 * oz + a) * h + 2 * oy) * row_el for a in (0, 1)]
        return [flat[s + q * row_el:s + (q + 1) * row_el]
                for s in start for q in (0, 1)]

    for b in range(plan.grid):
        mine = range(b, rows, plan.grid)
        ring = {}
        for k in range(plan.stages):  # the prologue fills the ring
            if k < len(mine):
                ring[k % plan.stages] = four_rows(mine[k])
        for k, r in enumerate(mine):
            if plan.stages:
                src = ring[k % plan.stages]
                n16 = row_el * isz // 16  # 16-byte chunks of a row
            else:
                src, n16 = four_rows(r), 0  # the scalar path reads global
            e16 = n16 * 16 // isz
            R = torch.empty(max(e16, 2 * n_out), dtype=x.dtype)
            mx = torch.maximum  # keeps NaN, as __hmax2_nan and f32's select
            R[:e16] = mx(mx(src[0][:e16], src[1][:e16]),
                         mx(src[2][:e16], src[3][:e16]))
            tail = slice(e16, 2 * n_out)  # empty on the vector path
            R[tail] = mx(mx(src[0][tail], src[1][tail]),
                         mx(src[2][tail], src[3][tail]))
            # the W-pair compaction, thread t taking j = t, t + nt, ...
            O = torch.empty(n_out, dtype=x.dtype)
            t = torch.arange(nt)
            cc = t % c
            for m in range(-(-n_out // nt)):
                j = t + m * nt
                ok = j < n_out
                i = (2 * j - cc)[ok]
                O[j[ok]] = mx(R[i], R[i + c])
                cc = cc + nt % c
                cc = torch.where(cc >= c, cc - c, cc)
            if plan.stages and k + plan.stages < len(mine):
                ring[k % plan.stages] = four_rows(mine[k + plan.stages])
            # out_vec-byte stores of the staged row
            units = O.view(torch.uint8).reshape(-1, plan.out_vec)
            dst = out[r * n_out:(r + 1) * n_out].view(torch.uint8)
            dst.copy_(units.reshape(-1))
            written[r] += 1
    assert bool((written == 1).all())
    return out.reshape(d // 2, h2, w // 2, c)


@pytest.mark.parametrize("shape", [(5, 7, 9), (4, 6, 16), (3, 5, 17)])
@pytest.mark.parametrize("c", [3, 7, 8, 14])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_emulation_matches_plain(rng, dt, c, shape):
    x = _volume(rng, shape + (c,), DTYPES[dt])
    plan = kc.pool_plan(*x.shape, x.element_size())
    assert (plan.stages > 0) == (shape[2] * c * x.element_size() % 16 == 0)
    got = emulate_maxpool_rows(x, plan)
    assert got.dtype == x.dtype and torch.equal(got, _plain(x))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ring_and_grid_walk_with_few_blocks(rng, dt):
    """3 blocks of 6-7 rows each, the ring of every depth wrapping several
    times; and the scalar path of an unaligned volume."""
    x = _volume(rng, (8, 10, 16, 7), DTYPES[dt])
    plans = kc.pool_plans(*x.shape, x.element_size())
    assert sorted({p.stages for p in plans}) == [1, 2, 3]
    for plan in plans:
        plan = plan._replace(grid=3)
        assert torch.equal(emulate_maxpool_rows(x, plan), _plain(x))
    scalar = kc.pool_plan(*x.shape, x.element_size(),
                          aligned=False)._replace(grid=3)
    assert scalar.stages == 0 and scalar.out_vec == x.element_size()
    assert torch.equal(emulate_maxpool_rows(x, scalar), _plain(x))


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_nan_in_a_window_survives(rng, dt):
    x = _volume(rng, (4, 6, 16, 7), DTYPES[dt])
    x[1, 0, 3, 2] = float("nan")     # window (0, 0, 1)
    x[3, 5, 14, 6] = float("nan")    # window (1, 2, 7), last channel
    for aligned in (True, False):    # the vector and the scalar path
        plan = kc.pool_plan(*x.shape, x.element_size(), aligned=aligned)
        got, want = emulate_maxpool_rows(x, plan), kc.maxpool2_plain(x)
        nan = torch.isnan(got)
        assert int(nan.sum()) == 2 and torch.equal(nan, torch.isnan(want))
        assert bool(nan[0, 0, 1, 2]) and bool(nan[1, 2, 7, 6])
        assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


@pytest.mark.parametrize("pack,c,dhw", [(4, 7, (4, 8, 32)),
                                        (2, 14, (4, 6, 8))])
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_kernel_emulation_matches_pallas(rng, dt, pack, c, dhw):
    """Against ``maxpool2_chain`` in interpret mode, as
    ``test_torch_port_kernels.py`` (f32) and
    ``test_torch_port_int8_kernels.py`` (``fill=-128``) run it."""
    d, hh, ww = dhw
    x = _volume(rng, (d, hh, ww, c), DTYPES[dt])
    fill = {"fill": -128} if dt == "int8" else {}
    wp = ww // pack
    xc = pc.to_chain(jnp.asarray(x.numpy().reshape(d, hh, wp, pack * c)),
                     pack, **fill)
    out = pc.maxpool2_chain(xc, hh, wp, pack, c, interpret=True, **fill)
    half = pack // 2
    want = pc.unpack_output(pc.from_chain(out, hh // 2, wp, half * c), half,
                            c)
    got = emulate_maxpool_rows(x, kc.pool_plan(*x.shape, x.element_size()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the 20 K2/K2q launch shapes of the paths: UNetSP / UNet4_2IC (7 channels
# at full resolution) and recAE_v2_fixed (8) in bf16 and f32, UNetSP in int8
PATH_SHAPES = [(224 >> lv, 304 >> lv, 304 >> lv, i0 << lv, isz)
               for isz, firsts in ((2, (7, 8)), (4, (7, 8)), (1, (7,)))
               for i0 in firsts for lv in range(4)]


@pytest.mark.parametrize("d,h,w,c,isz", PATH_SHAPES)
def test_pool_plan_at_every_path_shape(d, h, w, c, isz):
    plans = kc.pool_plans(d, h, w, c, isz)
    assert kc.pool_plan(d, h, w, c, isz) in plans
    for plan in plans:
        _check_path_plan(plan, d, h, w, c, isz)


def _check_path_plan(plan, d, h, w, c, isz):
    rows = (d // 2) * (h // 2)
    # block b takes rows b, b + grid, ...: each row exactly once, no block
    # without a row
    assert 1 <= plan.grid <= rows
    assert sum(len(range(b, rows, plan.grid))
               for b in range(plan.grid)) == rows
    assert w * c * isz % 16 == 0 and plan.stages > 0  # the vector path
    need = plan.stages * 4 * plan.row_cap + -(-(w // 2) * c * isz // 16) * 16
    assert need <= plan.smem <= kc.SMEM_PER_BLOCK
    # one wave: the grid fits the SMs at once
    per_sm = min(kc.POOL_BLOCKS_PER_SM,
                 kc.SMEM_PER_SM // (plan.smem + kc.SMEM_PER_BLOCK_RESERVED))
    assert plan.grid <= per_sm * kc.TC_SMS
    assert (w // 2) * c * isz % plan.out_vec == 0


def test_pool_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError):
        kc.pool_plan(1, 8, 8, 4, 2)  # no output row
    with pytest.raises(ValueError):
        kc.pool_plan(2, 2, 4096, 32, 4)  # 512 KB rows
    assert kc.pool_plan(4, 4, 9, 3, 2).stages == 0  # 54-byte rows


# --------------------------------------------------------------------------
# routing on a patched card
# --------------------------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    """A card that launches nothing: ``meta`` tensors pass the device check,
    ``build.function`` records each ``(library, symbol, args)``."""
    asked = []

    def function(lib, symbol, argtypes):
        def call(*args):
            asked.append((lib, symbol, args))
            return 0
        return call

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(kc, "_require_cuda", lambda t, what: None)
    kernels.reset_launches()
    return asked


CALLS = {  # call, dtype, symbol, counters it adds to besides maxpool2_rows
    "maxpool2 bf16": (kc.maxpool2, torch.bfloat16, "ctunet_maxpool2_rows",
                      ("maxpool2",)),
    "maxpool2 f32": (kc.maxpool2, torch.float32, "ctunet_maxpool2_rows_f32",
                     ("maxpool2", "maxpool2_f32")),
    "maxpool2_f32": (kc.maxpool2_f32, torch.float32,
                     "ctunet_maxpool2_rows_f32", ("maxpool2_f32",)),
    "maxpool2_q": (kc.maxpool2_q, torch.int8, "ctunet_maxpool2_rows_q",
                   ("maxpool2_q",)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrappers_launch_maxpool2_rows(card, name):
    call, dtype, symbol, counters = CALLS[name]
    x = torch.empty((6, 10, 16, 7), dtype=dtype, device="meta")
    out = call(x)
    assert out.dtype == dtype and out.shape == (3, 5, 8, 7)
    plan = kc.pool_plan(6, 10, 16, 7, x.element_size())
    assert [(lib, sym) for lib, sym, _ in card] == [("maxpool_rows", symbol)]
    assert card[0][2][2:] == (6, 10, 16, 7, plan.stages, plan.grid,
                              plan.row_cap, plan.out_vec, plan.smem, 0, None)
    counts = {k: v for k, v in kernels.launches().items() if v}
    assert counts == dict.fromkeys(counters + ("maxpool2_rows",), 1)
    assert kernels.WRAPPERS["maxpool2_rows"] is kc.maxpool2_rows


@pytest.mark.parametrize("direct,dtype,symbol", [
    (kc.maxpool2_direct, torch.bfloat16, "ctunet_maxpool2"),
    (kc.maxpool2_f32_direct, torch.float32, "ctunet_maxpool2_f32"),
    (kc.maxpool2_q_direct, torch.int8, "ctunet_maxpool2_q"),
])
def test_direct_entries_reach_maxpool_cu_and_count_nothing(card, direct,
                                                           dtype, symbol):
    x = torch.empty((6, 10, 16, 7), dtype=dtype, device="meta")
    assert direct(x).shape == (3, 5, 8, 7)
    assert [(lib, sym) for lib, sym, _ in card] == [("maxpool", symbol)]
    assert sum(kernels.launches().values()) == 0


def test_wrappers_refuse_other_dtypes(card):
    half = torch.empty((4, 4, 4, 8), dtype=torch.float16, device="meta")
    for call in (kc.maxpool2, kc.maxpool2_f32, kc.maxpool2_q,
                 kc.maxpool2_rows, kc.maxpool2_direct):
        with pytest.raises(TypeError):
            call(half)
    assert card == [] and sum(kernels.launches().values()) == 0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cpu_tensors_take_the_plain_versions(rng, dt):
    kernels.reset_launches()
    x = _volume(rng, (5, 6, 9, 7), DTYPES[dt])
    want = _plain(x)
    wrappers = ((kc.maxpool2_q, kc.maxpool2_q_direct) if dt == "int8" else
                (kc.maxpool2, kc.maxpool2_f32, kc.maxpool2_direct,
                 kc.maxpool2_f32_direct))
    for fn in wrappers + (kc.maxpool2_rows,):
        assert torch.equal(fn(x), want)
    assert sum(kernels.launches().values()) == 0


def test_maxpool2_rows_launches_the_plan_it_is_given(card):
    """``chip_smoke.py`` times every plan of ``pool_plans`` through it."""
    x = torch.empty((6, 10, 16, 7), dtype=torch.bfloat16, device="meta")
    plans = kc.pool_plans(6, 10, 16, 7, 2)
    for plan in plans:
        kc.maxpool2_rows(x, plan)
    assert [args[6:11] for _, _, args in card] == [
        (p.stages, p.grid, p.row_cap, p.out_vec, p.smem) for p in plans]
    assert kc.maxpool2_rows.launches == len(plans)
