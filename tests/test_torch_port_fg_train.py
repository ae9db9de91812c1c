"""PyTorch port, foreground-crop training (``b_fg_crop_train``) on the CPU.

``steps.make_fg_crop_fn`` and ``steps.fg_crop_size_for`` against
``ctunet_tpu.steps``'s on seeded volumes (crops, atlas slices, the lost
voxel counter, pairs mode), one f32 train step on the window against the
JAX step on the same window (terms rtol 1e-4, BatchNorm statistics atol
1e-5, gradients atol 2e-4 against ``jax.grad`` on the JAX crop, as in
``test_torch_port_train_step.py``), and ``Model`` training on the window
it plans from the data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import steps as jsteps
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.problem import FlapRecWithShapePriorDoubleOut as JHandler
from ctunet_tpu_torch import Model, steps
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.data.datasets import NiftiImageDataset
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import to_flax
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
from ctunet_tpu_torch.utils import nifti

torch.set_num_threads(2)

CANVAS = (32, 32, 32)
WINDOW = (16, 16, 16)
CFG = dict(optimizer="adam", learning_rate=1e-4)
LOSS = dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True)


def _pairs(seed=0, n=2, canvas=CANVAS, radius_frac=0.15, lo=9, hi=23):
    """(broken, flap) pairs of shells centred in ``[lo, hi)`` on every axis
    of ``canvas`` (clipped to its middle), and an atlas with distinct
    values so a misplaced slice shows."""
    rng = np.random.default_rng(seed)
    broken, flaps = [], []
    for i in range(n):
        c = np.minimum(rng.uniform(lo, hi, size=3), np.array(canvas) / 2)
        full = spherical_shell(canvas, radius_frac=radius_frac,
                               center=tuple(c)).astype(np.float32)
        zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in canvas)]
        p = np.argwhere(full > 0)[rng.integers(0, int(full.sum()))]
        hole = ((zz - p[0]) ** 2 + (yy - p[1]) ** 2 + (xx - p[2]) ** 2) <= 9
        flaps.append(full * hole)
        broken.append(full * ~hole)
    atlas = rng.random(canvas).astype(np.float32)
    return np.stack(broken), np.stack(flaps), atlas


def _jax_crop(size, atlas, margin, multiple, batch):
    crop = jsteps.make_fg_crop_fn(size, atlas, margin=margin,
                                  multiple=multiple)
    out, atlas_b = crop(jax.random.key(0), {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    return out, atlas_b


@pytest.mark.parametrize("size,margin,multiple,pairs", [
    (WINDOW, 2, 4, False),
    (WINDOW, 2, 2, True),
    (WINDOW, 0, 16, True),
    ((16, 32, 16), 3, 8, False),
    (CANVAS, 2, 2, True),
    ((8, 8, 8), 1, 2, True),   # too small: fg_lost counts what it misses
])
def test_fg_crop_fn_matches_jax(size, margin, multiple, pairs):
    broken, flaps, atlas = _pairs(seed=margin + multiple)
    batch = {"image": broken}
    if pairs:
        batch["flap"] = flaps
    want, want_atlas = _jax_crop(size, atlas, margin, multiple, batch)
    crop = steps.make_fg_crop_fn(size, torch.from_numpy(atlas),
                                 margin=margin, multiple=multiple)
    got, got_atlas = crop(None, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got_atlas.numpy(), np.asarray(want_atlas))
    if size == (8, 8, 8):
        assert got["fg_lost"].min() > 0


def test_fg_crop_fn_empty_and_edge_volumes():
    vols = np.zeros((3,) + CANVAS, np.float32)
    vols[1, 28:, 30:, :3] = 1.0   # touching three canvas faces
    vols[2, 0, 0, 0] = 1.0        # the first voxel
    crop = steps.make_fg_crop_fn(WINDOW, None, margin=2, multiple=4)
    got, _ = crop(None, {"image": torch.from_numpy(vols)})
    want, _ = _jax_crop(WINDOW, None, 2, 4, {"image": vols})
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["fg_lost"].tolist() == [0, 0, 0]


@pytest.mark.parametrize("margin,multiple", [(2, 4), (2, 16), (16, 16),
                                             (24, 8)])
def test_fg_crop_size_for_matches_jax(margin, multiple):
    broken, flaps, _ = _pairs(seed=3, n=3)
    vols = list(np.maximum(broken, flaps))
    cases = [vols, vols[:1], [np.ones(CANVAS, np.float32)],
             [np.zeros(CANVAS, np.float32)], []]
    for case in cases:
        assert steps.fg_crop_size_for(case, CANVAS, margin, multiple) == \
            jsteps.fg_crop_size_for(case, CANVAS, margin, multiple)


def test_fg_crop_size_and_patch_exclude_each_other():
    model = build_model("UNetSP")
    with pytest.raises(AssertionError, match="exclusive"):
        steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(), LOSS,
                              train_patch=WINDOW, fg_crop_size=WINDOW)


@pytest.fixture(scope="module")
def start():
    torch.manual_seed(0)
    m = build_model("UNetSP")
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.normal_(0, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
    return {k: v.clone() for k, v in m.state_dict().items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_fg_crop_train_step_matches_jax(start):
    """One f32 train step on the foreground window, pairs mode, against the
    JAX train step with ``fg_crop_size``: the terms (``fg_lost_voxels``
    included) within rtol 1e-4, the BatchNorm statistics after the step
    within atol 1e-5, and the step's gradients within atol 2e-4 of
    ``jax.grad`` of the JAX loss on the JAX crop of the same batch, as in
    ``test_torch_port_train_step.py``.
    """
    # shells filling 16x16 of a 16x16x64 canvas, cut to 16x16x32 at the
    # pool multiple 16 (W offsets 16 and 0): the step test's shape, on
    # which the deepest BatchNorm sees 4 values a channel
    canvas, size = (16, 16, 64), (16, 16, 32)
    broken, flaps, _ = _pairs(seed=11, canvas=canvas, radius_frac=0.38,
                              lo=8, hi=44)
    atlas = spherical_shell(canvas, radius_frac=0.42).astype(np.float32)
    kw = dict(fg_crop_size=size, fg_margin=2)
    params, stats = jax.tree.map(jnp.asarray, to_flax(start))
    jm = jax_build_model("UNetSP", compute_dtype="float32",
                         use_checkpoint=False)
    jhandler = JHandler()
    jbatch = {"image": jnp.asarray(broken), "flap": jnp.asarray(flaps)}
    opt = jsteps.make_optimizer(CFG)
    jstep = jsteps.make_train_step(jm, jhandler, opt, LOSS, atlas=atlas,
                                   compute_dtype=jnp.float32,
                                   from_pairs=True, donate=False,
                                   fg_multiple=16, **kw)
    jstate, want = jstep(
        jsteps.TrainState(params, stats, opt.init(params),
                          jnp.zeros((), jnp.int32)),
        jbatch, jax.random.key(0))
    cut, atlas_b = _jax_crop(size, atlas, 2, 16, jbatch)
    np.testing.assert_array_equal(  # the two samples' windows differ
        np.asarray(atlas_b), np.stack([atlas[:, :, 16:48], atlas[:, :, :32]]))
    x = jnp.stack([cut["image"], atlas_b], -1)
    _, targets = jax.vmap(jhandler.targets_from_pair)(cut["image"],
                                                      cut["flap"])

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, True,
                          mutable=["batch_stats"])
        return jhandler.compute_losses(out, targets, LOSS)[0]

    want_grads = jax.grad(loss_fn)(params)

    model = build_model("UNetSP")
    model.load_state_dict(start)
    model.configure("xla", torch.float32)
    tstate = steps.TrainState(model, steps.make_optimizer(
        CFG, model.parameters()))
    tstep = steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(),
                                  LOSS, atlas=atlas,
                                  compute_dtype=torch.float32,
                                  from_pairs=True, **kw)
    batch = {"image": torch.from_numpy(broken),
             "flap": torch.from_numpy(flaps)}
    _, got = tstep(tstate, batch, torch.Generator().manual_seed(0))
    assert set(got) == set(want) and "fg_lost_voxels" in got
    assert int(got["fg_lost_voxels"]) == int(want["fg_lost_voxels"]) == 0
    for k in got:
        tol = (dict(atol=2e-3, rtol=0) if k.startswith("dice_coef")
               else dict(rtol=1e-4))
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **tol)
    _, got_stats = to_flax(model.state_dict())
    for (path, w), (_, g) in zip(_leaves(jstate.batch_stats),
                                 _leaves(got_stats)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                   err_msg=str(path))
    sd = {k: v.clone() for k, v in start.items()}
    sd.update({k: p.grad for k, p in model.named_parameters()})
    got_grads, _ = to_flax(sd)
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(got_grads)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4,
                                   err_msg=str(path))


def test_model_trains_on_the_planned_window(tmp_path):
    """``b_fg_crop_train`` through ``Model``: the window planned over every
    train and validation volume, both steps on it, ``fg_lost_voxels`` 0."""
    shape = (32, 64, 64)
    csv = make_dataset(str(tmp_path / "data"), n=2, shape=shape, seed=1)
    register_atlas(shape, spherical_shell(shape, radius_frac=0.42))
    m = Model(params=dict(
        train_flag=True, test_flag=False, name="fgt", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(tmp_path / "ws"), train_files_csv=csv,
        validation_files_csv=csv, n_epochs=1, batch_size=1,
        optimizer="adam", learning_rate=1e-4, ce_lambda=1.0,
        dice_lambda=1.0, conv_impl="chain", compute_dtype="float32",
        fg_crop_train=True, fg_margin=2))
    vols = [nifti.read(f).data.astype(np.float32)
            for f in NiftiImageDataset(csv).files]
    want = jsteps.fg_crop_size_for(vols + vols, shape, margin=2, multiple=16)
    assert m.fg_train_size == want
    assert want[1] < shape[1] and want[2] < shape[2]
    hist = m.writer.history
    for phase in ("train", "val"):
        assert hist[f"{phase}/epoch/fg_lost_voxels"][-1][1] == 0
        assert np.isfinite(hist[f"{phase}/epoch/epoch_loss"][-1][1])
