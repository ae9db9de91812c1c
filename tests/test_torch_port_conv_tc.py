"""PyTorch port, the tensor-core conv ``conv3d_tc`` (``csrc/conv3d_tc.cu``):
the host side that the CPU can hold.

- The tile plan (``tc_plan``) and the kernel's grid arithmetic
  (``tc_blocks``) write every output voxel and channel exactly once at
  ragged extents.
- The weight packing (``pack_tc_weights``), run through a plain-torch
  emulation of the kernel's stage loop (per block and per (dz, channel
  chunk) stage: the zero-filled halo slab with the kernel's channel stride,
  A rows gathered at the lane's row offset plus the tap table's, B from the
  packed weights, f32 sums, bias, ReLU), equals the plain version in f32.
  atol 1e-5: both sum the same f32 products in different orders, with
  weights scaled by their fan-in so outputs are O(1).
- One small shape against the Pallas ``conv3d_fused`` in interpret mode at
  k = 3 and k = 5, in bf16: the emulation on bf16 operands, rounded once,
  within 2 bf16 ulps of the Pallas output (each side rounds an f32 sum
  taken in its own order once).

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 2.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu_torch.ops.kernels import conv3d as kc

torch.set_num_threads(2)

EXTENTS = (19, 38, 76, 304)
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, bytes


def _emulate(x, w, bias, relu, plan):
    """``csrc/conv3d_tc.cu``'s data flow in plain torch (f32 sums)."""
    d, h, wd, ci = x.shape
    co, k, p = w.shape[-1], plan.k, plan.k // 2
    ty, tx = plan.tile
    sy, sx = ty + k - 1, tx + k - 1
    cc, c8s = plan.cc, plan.cc // 8
    cs = cc if c8s % 2 else cc + 8
    bn, groups = 8 * plan.nf, plan.groups()
    wp = kc.pack_tc_weights(w, plan).float()
    tab = []
    for g in range(groups):
        tap, c8 = divmod(g, c8s)
        dy, dx = divmod(tap, k)
        tab.append((dy * sx + dx) * cs + c8 * 8 if g < k * k * c8s else 0)
    m = torch.arange(ty * tx)
    row_off = ((m // tx) * sx + m % tx) * cs
    idx = (row_off[:, None, None] + torch.tensor(tab)[None, :, None]
           + torch.arange(8)[None, None, :]).reshape(ty * tx, -1)
    # zero border and channel padding: the kernel's zero-filled copies
    xp = F.pad(x.float(), (0, cc * plan.chunks - ci, p, p + tx, p, p + ty,
                           p, p))
    bias_p = F.pad(bias.float(), (0, plan.n_tiles(co) * bn - co))
    out = torch.full((d, h, wd, co), float("nan"))
    for z, y0, x0, n0, vy, vx, ncol in kc.tc_blocks((d, h, wd), co, plan):
        acc = torch.zeros(ty * tx, bn)
        for dz in range(k):
            if not 0 <= z + dz - p < d:
                continue  # the kernel skips planes outside the volume
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs)
                slab[..., :cc] = xp[z + dz, y0:y0 + sy, x0:x0 + sx,
                                    chunk * cc:(chunk + 1) * cc]
                a = slab.reshape(-1)[idx]
                b = wp[n0 // bn, dz, chunk].permute(0, 2, 1).reshape(-1, bn)
                acc += a @ b
        acc = acc + bias_p[n0:n0 + bn]
        if relu:
            acc = torch.relu(acc)
        tile = acc.reshape(ty, tx, bn)
        out[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] = tile[:vy, :vx, :ncol]
    return out


def _case(ci, co, k, shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape + (ci,)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, k, k, ci, co))
                          / math.sqrt(k ** 3 * ci)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
    return x, w.to(dtype), b


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(19, 38, 76), (76, 304, 19),
                                   (38, 19, 304), (304, 76, 38)])
@pytest.mark.parametrize("ci,co", [(2, 7), (28, 56), (112, 112)])
def test_tc_plan_covers_every_output_once(k, shape, ci, co):
    plan = kc.tc_plan(shape, ci, co, k)
    ty, tx = plan.tile
    assert ty * tx == 64 * plan.mf and (plan.mf, plan.tx_log2) in kc.TC_TILES
    assert plan.cc % 8 == 0 and plan.cc * plan.chunks >= ci
    assert plan.cc * (plan.chunks - 1) < ci  # no chunk of padding alone
    # two stages (slab + weights) and the tap table fit a block
    cs = plan.cc if (plan.cc // 8) % 2 else plan.cc + 8
    stage = 2 * (ty + k - 1) * (tx + k - 1) * cs + 16 * plan.groups() * (
        8 * plan.nf)
    assert 2 * stage + 4 * plan.groups() <= SMEM_PER_BLOCK
    count = np.zeros(shape + (co,), np.uint8)
    for z, y0, x0, n0, vy, vx, ncol in kc.tc_blocks(shape, co, plan):
        assert vy > 0 and vx > 0 and ncol > 0
        count[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] += 1
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("ci", [1, 2, 7, 28, 56, 112, 128])
@pytest.mark.parametrize("co", [7, 8, 14, 56])
def test_tc_pack_through_the_stage_loop_equals_plain(k, ci, co):
    shape = (3, 7, 19) if ci < 56 else (2, 5, 11)
    x, w, b = _case(ci, co, k, shape, seed=ci * 100 + co)
    plan = kc.tc_plan(shape, ci, co, k)
    relu = co % 2 == 0  # both epilogues
    got = _emulate(x, w, b, relu, plan)
    want = (kc.conv3d_bias_act_plain if k == 3
            else kc.conv3d5_bias_act_plain)(x, w, b, relu)
    assert float(want.abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_tc_matches_pallas_conv3d_fused(k):
    """bf16, 7 -> 14 channels over 4x16x16 (H a multiple of 8, W of the
    pack: the Pallas kernel itself runs in interpret mode)."""
    shape, ci, co = (4, 16, 16), 7, 14
    x, w, b = _case(ci, co, k, shape, seed=k, dtype=torch.bfloat16)
    want = np.array(jnp.asarray(pc.conv3d_k3(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), w.float().numpy(),
        bias=b.numpy(), pack=2, relu=True, interpret=True,
        out_dtype=jnp.bfloat16), jnp.float32))
    tol = 2.0 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(np.abs(want).max()))
    plan = kc.tc_plan(shape, ci, co, k)
    emu = _emulate(x, w, b, True, plan).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(emu, want, rtol=0, atol=tol)
    got = kc.conv3d_tc(x, w, b, True)  # the CPU route: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == shape + (co,)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_tc_packing_is_kept_per_weight_tensor():
    x, w, b = _case(14, 28, 5, (2, 4, 8), seed=1, dtype=torch.bfloat16)
    plan = kc.tc_plan((2, 4, 8), 14, 28, 5)
    first = kc.tc_packed(w, plan)
    assert kc.tc_packed(w, plan) is first
    w.mul_(2.0)  # an in-place update (an optimizer step) packs anew
    again = kc.tc_packed(w, plan)
    assert again is not first
    torch.testing.assert_close(again, 2.0 * first)
    assert first.shape == (plan.n_tiles(28), 5, plan.chunks, plan.groups(),
                           8 * plan.nf, 8)


def test_tc_wrapper_routes_and_checks():
    from ctunet_tpu_torch.ops import kernels

    assert kernels.WRAPPERS["conv3d_tc"] is kc.conv3d_tc
    kernels.reset_launches()
    x, w, b = _case(3, 5, 3, (2, 3, 4), seed=2)
    kc.conv3d_tc(x, w, b)
    assert kernels.launches()["conv3d_tc"] == 0  # the CPU runs the plain
    meta = x.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.conv3d_tc(meta, w, b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.conv3d5_bias_act(meta, w, b)
