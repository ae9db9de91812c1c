"""PyTorch port, the single-output training synthesis on the CPU:
``ops/preprocess.py`` (6-neighbourhood morphology), ``ops/warp.py``
(affine, elastic, S-flip, the cranioplasty chain) and the synthesis of
``FlapRec``, ``FlapRecWithShapePrior`` and ``DenoisingAE``, against
``ctunet_tpu``.

Deterministic pieces agree with JAX value for value: ``erode``,
``dilate``, the erode/dilate core, ``random_flip_s`` at p = 1, and
``affine_warp`` at the identity, at integer translations and at a
half-voxel translation (nearest rounds halves away from zero), exactly. At a
fixed rotation and scale, and for the elastic warp at a fixed displacement
grid (JAX's side rebuilt from ``warp._sample`` and ``jax.image.resize`` on
the same grid), the nearest sample of a coordinate within f32 rounding of
a half voxel may land on either side in either package, so they agree at
all but 1e-4 of the voxels. The random pieces draw from a torch Philox
stream that cannot give JAX's threefry numbers, so they are held by their
statistics: over a few hundred draws each coin's rate lies within 3 sigma
of its p; warps keep a binary skull binary; locked borders do not move;
``cranioplasty_transform`` keeps the contract ``tests/test_warp.py:69-78``
holds JAX to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import problem as jproblem
from ctunet_tpu.ops import preprocess as jpre
from ctunet_tpu.ops import warp as jwarp
from ctunet_tpu_torch import problem
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.ops import preprocess, warp

torch.set_num_threads(2)

SHAPE = (16, 16, 32)
BIG = (32, 48, 64)  # 98,304 voxels: 1e-4 of them is 9


def _skull(shape=SHAPE, seed=0):
    return spherical_shell(shape, seed=seed).astype(np.float32)


def _binary(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.6).astype(
        np.float32)


def _mismatch(a, b) -> float:
    return float(np.mean(np.asarray(a) != np.asarray(b)))


def _within_3_sigma(hits: int, n: int, p: float) -> bool:
    return abs(hits - n * p) <= 3.0 * np.sqrt(n * p * (1.0 - p))


# --------------------------------------------------------------------------
# Morphology
# --------------------------------------------------------------------------


@pytest.mark.parametrize("times", [1, 2])
def test_erode_dilate_equal_jax(times):
    v = _binary(SHAPE, times)
    for fn, jfn in ((preprocess.erode, jpre.erode),
                    (preprocess.dilate, jpre.dilate)):
        got = fn(torch.from_numpy(v), times=times).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(v),
                                                          times=times)))
    # the border reads 1 for erosion and 0 for dilation
    ones = torch.ones(4, 4, 4)
    assert torch.equal(preprocess.erode(ones), ones)
    one = torch.zeros(4, 4, 4)
    one[0, 0, 0] = 1.0
    assert int(preprocess.dilate(one).sum()) == 4


def test_erode_dilate_core_and_rates():
    v = _skull()
    vt = torch.from_numpy(v)
    for choice, jfn in ((0, jpre.erode), (1, jpre.dilate)):
        got = preprocess.erode_dilate_core(vt, choice, True).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(v))))
    assert torch.equal(preprocess.erode_dilate_core(vt * 3, 1, False), vt)
    # coin p = 0.3, then erode or dilate with probability 1/2 each
    gen = torch.Generator().manual_seed(0)
    small = torch.from_numpy(_skull((8, 8, 8), seed=3))
    n0 = int(small.sum())
    n, grew, shrank = 400, 0, 0
    for _ in range(n):
        c = int(preprocess.erode_dilate(gen, small, p=0.3).sum())
        grew += c > n0
        shrank += c < n0
    assert _within_3_sigma(grew + shrank, n, 0.3)
    assert _within_3_sigma(grew, grew + shrank, 0.5)


# --------------------------------------------------------------------------
# Warps
# --------------------------------------------------------------------------


def test_affine_identity_and_integer_translations_equal_jax():
    v = _skull()
    vt = torch.from_numpy(v)
    eye = np.eye(3, dtype=np.float32)
    for t in ([0.0, 0.0, 0.0], [2.0, -3.0, 5.0], [-7.0, 4.0, -1.0]):
        t = np.asarray(t, np.float32)
        got = warp.affine_warp(vt, torch.from_numpy(eye),
                               torch.from_numpy(t)).numpy()
        want = np.asarray(jwarp.affine_warp(jnp.asarray(v), jnp.asarray(eye),
                                            jnp.asarray(t)))
        np.testing.assert_array_equal(got, want)
    # nearest at a half-voxel shift: every coordinate lands on a half,
    # which both packages round away from zero
    half = warp.affine_warp(vt, torch.from_numpy(eye),
                            torch.tensor([0.5, -0.5, 0.5])).numpy()
    want = np.asarray(jwarp.affine_warp(jnp.asarray(v), jnp.asarray(eye),
                                        jnp.asarray([0.5, -0.5, 0.5])))
    np.testing.assert_array_equal(half, want)


def test_nearest_rounds_half_away_from_zero():
    c = torch.tensor([-2.5, -1.5, -0.5, -0.49999997, 0.49999997, 0.5, 1.5,
                      2.5, 3.2, -3.7])
    want = jax.lax.round(jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(warp._round_half_away(c).numpy(),
                                  np.asarray(want))


def test_affine_rotation_scale_agrees_with_jax():
    v = _skull(BIG, seed=4)
    scale = np.asarray([0.93, 1.07, 1.02], np.float32)
    angles = np.deg2rad(np.asarray([11.0, -7.0, 4.0], np.float32))
    trans = np.asarray([1.5, -2.25, 3.0], np.float32)
    got = warp.random_affine_core(torch.from_numpy(v), scale, trans,
                                  angles, True).numpy()
    m = jwarp._rotation_matrix(-jnp.asarray(angles)) @ jnp.diag(
        1.0 / jnp.asarray(scale))
    want = np.asarray(jwarp.affine_warp(jnp.asarray(v), m,
                                        jnp.asarray(trans)))
    assert got.sum() > 0.5 * v.sum()
    assert _mismatch(got, want) <= 1e-4
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        warp.random_affine_core(torch.from_numpy(v), scale, trans, angles,
                                False).numpy(), v)


def test_elastic_core_agrees_with_jax():
    v = _skull(BIG, seed=5)
    rng = np.random.default_rng(5)
    disp = rng.uniform(-7.5, 7.5, (3, 7, 7, 7)).astype(np.float32)
    disp[:, :2] = disp[:, -2:] = 0.0
    disp[:, :, :2] = disp[:, :, -2:] = 0.0
    disp[:, :, :, :2] = disp[:, :, :, -2:] = 0.0
    got = warp.random_elastic_core(torch.from_numpy(v),
                                   torch.from_numpy(disp), True).numpy()
    field = jax.image.resize(jnp.asarray(disp), (3, *BIG), "trilinear")
    grid = jnp.stack(jnp.meshgrid(*[jnp.arange(n, dtype=jnp.float32)
                                    for n in BIG], indexing="ij"))
    want = np.asarray(jwarp._sample(jnp.asarray(v), grid + field, 0))
    assert not np.array_equal(got, v)
    assert _mismatch(got, want) <= 1e-4


def test_random_draws_rates_and_locked_borders():
    gen = torch.Generator().manual_seed(1)
    n = 400
    aff = [warp.draw_affine(gen, "cpu", p=0.5) for _ in range(n)]
    ela = [warp.draw_elastic(gen, "cpu", p=0.5) for _ in range(n)]
    assert _within_3_sigma(sum(bool(d["apply"]) for d in aff), n, 0.5)
    assert _within_3_sigma(sum(bool(d["apply"]) for d in ela), n, 0.5)
    scale = torch.stack([d["scale"] for d in aff])
    trans = torch.stack([d["translation"] for d in aff])
    angles = torch.stack([d["angles"] for d in aff])
    assert 0.9 <= float(scale.min()) and float(scale.max()) <= 1.1
    assert (trans.abs() <= torch.tensor([10.0, 10.0, 15.0])).all()
    assert float(angles.abs().max()) <= np.deg2rad(15.0) + 1e-6
    for d in ela[:20]:
        disp = d["disp"]
        assert float(disp.abs().max()) <= 7.5
        border = disp.clone()
        border[:, 2:-2, 2:-2, 2:-2] = 0.0
        assert not border.any() and disp[:, 2:-2, 2:-2, 2:-2].all()
    # locked borders: a full volume keeps its corners through the warp
    ones = torch.ones(16, 16, 16)
    out = warp.random_elastic(gen, ones, p=1.0)
    assert out[0, 0, 0] == 1.0 and out[-1, -1, -1] == 1.0
    # the S-flip coin
    asym = torch.zeros(4, 4, 4)
    asym[0] = 1.0
    flips = sum(bool(warp.random_flip_s(gen, asym, p=0.5)[-1, 0, 0])
                for _ in range(n))
    assert _within_3_sigma(flips, n, 0.5)


def test_flip_and_warps_keep_a_skull_binary():
    v = _skull()
    vt = torch.from_numpy(v)
    gen = torch.Generator().manual_seed(2)
    np.testing.assert_array_equal(
        warp.random_flip_s(gen, vt, p=1.0).numpy(),
        np.asarray(jwarp.random_flip_s(jax.random.key(0), jnp.asarray(v),
                                       p=1.0)))
    for fn in (warp.random_affine, warp.random_elastic):
        out = fn(gen, vt, p=1.0)
        assert set(np.unique(out.numpy())) <= {0.0, 1.0}
        assert 0.5 * v.sum() < float(out.sum()) < 2.0 * v.sum()
        assert torch.equal(fn(gen, vt, p=0.0), vt)


def test_cranioplasty_transform_contract():
    vt = torch.from_numpy(_skull((24, 24, 24)))
    gen = torch.Generator().manual_seed(3)
    holes = 0
    for _ in range(20):
        broken, (full, flap) = warp.cranioplasty_transform(gen, vt)
        assert broken.shape == full.shape == flap.shape == vt.shape
        for t in (broken, full, flap):
            assert t.dtype == torch.float32
            assert set(np.unique(t.numpy())) <= {0.0, 1.0}
        assert bool((flap <= full).all())
        holes += int(flap.sum()) > 0
    assert holes >= 12  # a hole at p = 0.9


# --------------------------------------------------------------------------
# The single-output handlers' synthesis
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["FlapRec", "FlapRecWithShapePrior",
                                  "DenoisingAE"])
def test_single_output_synthesis_matches_jax_shapes(name):
    v = _skull()
    got_x, got_t = getattr(problem, name)().synthesize(
        torch.Generator().manual_seed(0), torch.from_numpy(v))
    want_x, want_t = getattr(jproblem, name)().synthesize(
        jax.random.key(0), jnp.asarray(v))
    assert got_x.shape == want_x.shape == SHAPE
    assert got_t.shape == want_t.shape == (*SHAPE, 2)
    assert got_x.dtype == torch.float32 and got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.sum(-1).numpy(), 1.0)  # one-hot
    assert set(np.unique(got_x.numpy())) <= {0.0, 1.0}
    again = getattr(problem, name)().synthesize(
        torch.Generator().manual_seed(0), torch.from_numpy(v))
    assert torch.equal(again[0], got_x) and torch.equal(again[1], got_t)
    if name == "DenoisingAE":  # the clean skull is the target
        np.testing.assert_array_equal(got_t[..., 1].numpy(), v > 0)
    elif name == "FlapRec":  # the flap is cut out of the unwarped skull
        flap = got_t[..., 1].numpy()
        assert flap.sum() > 0 and (flap <= v).all()


def test_flap_rec_noise_rate():
    """``FlapRec``: a hole always, noise with probability 0.5;
    ``DenoisingAE``: noise with probability 0.8."""
    v = torch.from_numpy(_skull((16, 16, 16), seed=6))
    gen = torch.Generator().manual_seed(4)
    n = 300
    noisy = 0
    for _ in range(n):
        x, t = problem.FlapRec().synthesize(gen, v)
        assert float(t[..., 1].sum()) > 0
        # without noise the broken skull and the flap partition the skull
        noisy += not torch.equal(x + t[..., 1], v)
    assert _within_3_sigma(noisy, n, 0.5)
    noisy = sum(not torch.equal(
        problem.DenoisingAE().synthesize(gen, v)[0], v) for _ in range(n))
    assert _within_3_sigma(noisy, n, 0.8)
