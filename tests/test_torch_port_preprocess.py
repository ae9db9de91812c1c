"""PyTorch port, the public ``ops`` surface on the CPU: the names of
``ctunet_tpu.ops.__all__``, and preprocessing, thresholding, the device
largest-component flood and the nonzero-voxel draw against the JAX
functions.

Inputs come from numpy seeds. Tolerances: ``resample_to_shape`` atol 1e-6
on values in [0, 1] (measured up to 1.8e-7: the f32 weights and the order
of the three contractions differ from XLA's by an ulp or two);
``hu_window``, padding, ``threshold`` and ``largest_cc_device`` exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctunet_tpu.ops as jops
import ctunet_tpu_torch.ops as tops
from ctunet_tpu.ops import postprocess as jpost
from ctunet_tpu.ops import preprocess as jpre
from ctunet_tpu_torch.ops import postprocess as tpost
from ctunet_tpu_torch.ops import preprocess as tpre
from ctunet_tpu_torch.ops import synthesis as tsyn

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_ops_exports_every_name_of_the_jax_package():
    assert set(tops.__all__) == set(jops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


@pytest.mark.parametrize("binarize", [True, False])
def test_hu_window_matches_jax(binarize):
    rng = np.random.default_rng(1)
    hu = rng.uniform(-1200.0, 2500.0, (9, 10, 11)).astype(np.float32)
    hu[0, 0, :3] = (150.0, -100.0, 1500.0)  # the threshold and both edges
    want = np.asarray(jpre.hu_window(jnp.asarray(hu), binarize=binarize))
    got = tpre.hu_window(_t(hu), binarize=binarize)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("target", [
    (24, 32, 40),   # up by 2
    (6, 8, 10),     # down by 2
    (7, 9, 13),     # down, non-integer ratios
    (19, 5, 20),    # mixed: up, down, unchanged
    (13, 17, 29),   # up, non-integer ratios
    (1, 1, 1),
])
def test_resample_to_shape_matches_jax(target):
    """``jax.image.resize`` antialiases when it downsamples:
    ``F.interpolate`` is 0.19 off at (6, 8, 10) and 0.33 at (7, 9, 13)."""
    rng = np.random.default_rng(2)
    v = rng.random((12, 16, 20)).astype(np.float32)
    want = np.asarray(jpre.resample_to_shape(jnp.asarray(v), target))
    got = tpre.resample_to_shape(_t(v), target)
    assert tuple(got.shape) == target and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_resample_to_spacing_matches_jax():
    rng = np.random.default_rng(3)
    v = (rng.random((10, 14, 15)) > 0.6).astype(np.float32)
    for spacing, target in (((1.25, 0.6, 0.6), (1.0, 1.0, 1.0)),
                            ((0.5, 0.7, 1.1), (1.0, 0.5, 1.0))):
        want = np.asarray(jpre.resample_to_spacing(jnp.asarray(v), spacing,
                                                   target))
        got = tpre.resample_to_spacing(_t(v), spacing, target).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fixed_pad_and_unpad_match_jax():
    rng = np.random.default_rng(4)
    v = rng.random((5, 7, 3)).astype(np.float32)
    want, want_pad = jpre.fixed_pad(jnp.asarray(v), (8, 7, 6), 2.5)
    got, pad = tpre.fixed_pad(_t(v), (8, 7, 6), 2.5)
    assert pad == want_pad == ((0, 3), (0, 0), (0, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpre.unpad(got, pad).numpy(), v)
    np.testing.assert_array_equal(
        tpre.unpad(got, pad).numpy(),
        np.asarray(jpre.unpad(want, want_pad)))
    for mod in (jpre, tpre):
        with pytest.raises(ValueError, match="exceeds"):
            mod.fixed_pad(_t(v) if mod is tpre else jnp.asarray(v),
                          (4, 7, 3))


@pytest.mark.parametrize("multiple", [4, 16])
def test_pad_to_multiple_matches_jax(multiple):
    v = np.random.default_rng(5).random((5, 16, 17)).astype(np.float32)
    want, want_pad = jpre.pad_to_multiple(jnp.asarray(v), multiple)
    got, pad = tpre.pad_to_multiple(_t(v), multiple)
    assert pad == want_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threshold_matches_jax():
    p = np.random.default_rng(6).random((6, 7, 8)).astype(np.float32)
    p[0, 0, 0] = 0.5
    for thr in (0.5, 0.3):
        np.testing.assert_array_equal(
            tpost.threshold(_t(p), thr).numpy(),
            np.asarray(jpost.threshold(jnp.asarray(p), thr)))


def _component_sizes(mask):
    from scipy import ndimage

    labels, _ = ndimage.label(mask > 0, ndimage.generate_binary_structure(
        3, 1))
    return np.sort(np.bincount(labels.ravel())[1:])[::-1]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("density", [0.3, 0.45])
def test_largest_cc_device_matches_jax_and_host(seed, density):
    """Random masks around the percolation threshold: many components,
    often ties among the small ones. Equal to the JAX flood always, and to
    the host labelling where the largest size is unique."""
    mask = (np.random.default_rng(seed).random((10, 12, 14))
            < density).astype(np.float32)
    want = np.asarray(jpost.largest_cc_device(jnp.asarray(mask)))
    got = tpost.largest_cc_device(_t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    sizes = _component_sizes(mask)
    if len(sizes) < 2 or sizes[0] > sizes[1]:
        np.testing.assert_array_equal(got.numpy(), jpost.largest_cc(mask))


def test_largest_cc_device_ties():
    """Equal-size components: the one with the smallest largest id wins,
    as in JAX. Blocks stacked along z (first voxel and last voxel in the
    same order) agree with the host labelling; a z-line before an x-line
    in the first voxel but after it in the last voxel does not."""
    stacked = np.zeros((12, 6, 6), np.float32)
    stacked[1:4, 1:3, 1:3] = 1
    stacked[7:10, 2:4, 2:4] = 1
    crossed = np.zeros((6, 6, 8), np.float32)
    crossed[0:4, 0, 0] = 1      # z-line: voxels 0 .. 3*48
    crossed[1, 3, 2:6] = 1      # x-line inside z = 1
    for mask, agrees in ((stacked, True), (crossed, False)):
        want = np.asarray(jpost.largest_cc_device(jnp.asarray(mask)))
        got = tpost.largest_cc_device(_t(mask)).numpy()
        np.testing.assert_array_equal(got, want)
        host = jpost.largest_cc(mask)
        assert np.array_equal(got, host) == agrees
        np.testing.assert_array_equal(host, tpost.largest_cc(mask))
    # empty and single-component masks
    for mask in (np.zeros((4, 4, 4), np.float32), stacked[:6]):
        np.testing.assert_array_equal(
            tpost.largest_cc_device(_t(mask)).numpy(),
            np.asarray(jpost.largest_cc_device(jnp.asarray(mask))))


def test_random_nonzero_voxel_lands_on_a_nonzero_voxel():
    rng = np.random.default_rng(7)
    vol = (rng.random((9, 10, 11)) > 0.97).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    hits = set()
    for _ in range(40):
        center, any_nz = tsyn.random_nonzero_voxel(gen, _t(vol))
        z, y, x = (int(c) for c in center)
        assert bool(any_nz) and center.dtype == torch.float32
        assert vol[z, y, x] > 0
        hits.add((z, y, x))
    assert len(hits) > 5  # uniform over ~30 voxels, not one
    _, any_nz = tsyn.random_nonzero_voxel(gen, torch.zeros(3, 4, 5))
    assert not bool(any_nz)
