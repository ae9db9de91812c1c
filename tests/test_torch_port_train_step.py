"""PyTorch port, the training slice as a whole on the CPU: the train step
against the JAX step, and ``Model`` train -> save -> resume -> test.

UNetSP at 16x16x32 in f32, stored (broken, flap) pairs (``from_pairs``: no
random synthesis), one set of weights carried across with
``models/convert.py``. The JAX step runs ``conv_impl = "xla"``; the port
runs ``xla`` and ``chain`` (on the CPU the kernel's plain version and the
tap-shifted weight gradient). Tolerances: loss history rtol 1e-4 (the
argmax-counting Dice coefficient atol 2e-3), step-1 gradients atol 2e-4
against JAX and 5e-5 against the port's own graph in f64, BN statistics
atol 1e-5 after the first step (5e-4 after the third, when AMSGrad's
sign-like first steps have moved the two sets of weights apart).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import steps as jsteps
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.problem import FlapRecWithShapePriorDoubleOut as JHandler
from ctunet_tpu.utils import tb_writer as jax_tb
from ctunet_tpu_torch import Model, checkpoint, steps
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.data.datasets import (DECODE_CACHE,
                                            FlapRecWShapePrior2OTrainDataset)
from ctunet_tpu_torch.data.pipeline import HostLoader, device_prefetch
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import to_flax
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
from ctunet_tpu_torch.utils import nifti, tb_writer

torch.set_num_threads(2)

SHAPE = (16, 16, 32)
CFG = dict(optimizer="adam", learning_rate=1e-4)  # the INI's
LOSS = dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True)


def _pairs(batch=2, seed=0):
    """Stored (broken, flap) pairs and an atlas, from a numpy seed."""
    rng = np.random.default_rng(seed)
    broken, flaps = [], []
    for i in range(batch):
        full = spherical_shell(SHAPE, seed=seed + i).astype(np.float32)
        zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in SHAPE)]
        c = np.argwhere(full > 0)[rng.integers(0, int(full.sum()))]
        hole = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) <= 16
        flaps.append(full * hole)
        broken.append(full * ~hole)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    return np.stack(broken), np.stack(flaps), atlas


@pytest.fixture(scope="module")
def start():
    """Initial weights with non-trivial BN statistics, as a state_dict."""
    torch.manual_seed(0)
    m = build_model("UNetSP")
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.normal_(0, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
    return {k: v.clone() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def jax_run(start):
    """Three JAX train steps (``conv_impl = "xla"``) and the step-1
    gradients: ``(losses, grads, final params, (batch_stats after step 1,
    after step 3))``."""
    broken, flaps, atlas = _pairs()
    params, stats = to_flax(start)
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    jpc.set_conv_impl("xla")
    jm = jax_build_model("UNetSP", compute_dtype="float32",
                         use_checkpoint=False)
    opt = jsteps.make_optimizer(CFG)
    handler = JHandler()
    x = jnp.stack([jnp.asarray(broken),
                   jnp.broadcast_to(atlas[None], broken.shape)], -1)
    _, targets = jax.vmap(handler.targets_from_pair)(jnp.asarray(broken),
                                                     jnp.asarray(flaps))

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, True,
                          mutable=["batch_stats"])
        return handler.compute_losses(out, targets, LOSS)[0]

    grads = jax.grad(loss_fn)(params)
    step = jsteps.make_train_step(jm, handler, opt, LOSS, atlas=atlas,
                                  compute_dtype=jnp.float32, from_pairs=True,
                                  donate=False)
    state = jsteps.TrainState(params, stats, opt.init(params),
                              jnp.zeros((), jnp.int32))
    batch = {"image": jnp.asarray(broken), "flap": jnp.asarray(flaps)}
    losses, stats1 = [], None
    for i in range(3):
        state, terms = step(state, batch, jax.random.key(i))
        losses.append({k: float(v) for k, v in terms.items()})
        stats1 = state.batch_stats if stats1 is None else stats1
    return losses, grads, state.params, (stats1, state.batch_stats)


def _port_run(start, impl, n_steps=3):
    broken, flaps, atlas = _pairs()
    model = build_model("UNetSP")
    model.load_state_dict(start)
    model.configure(impl, torch.float32)
    state = steps.TrainState(model, steps.make_optimizer(CFG,
                                                         model.parameters()))
    step = steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(),
                                 LOSS, atlas=atlas,
                                 compute_dtype=torch.float32, from_pairs=True)
    batch = {"image": torch.from_numpy(broken),
             "flap": torch.from_numpy(flaps)}
    gen = torch.Generator().manual_seed(0)
    losses, grads = [], None
    for _ in range(n_steps):
        state, terms = step(state, batch, gen)
        losses.append({k: float(v) for k, v in terms.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            grads["stats1"] = to_flax(model.state_dict())[1]
    return losses, grads, model, state


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("impl", ["xla", "chain"])
def test_three_train_steps_match_jax(start, jax_run, impl):
    want_losses, want_grads, want_params, want_stats = jax_run
    losses, grads, model, state = _port_run(start, impl)
    assert state.step == 3
    for got, want in zip(losses, want_losses):
        assert set(got) == set(want)
        for k in got:
            # the Dice coefficient counts argmax voxels: a near-tie that
            # flips moves it by 1/|skull| ~ 5e-4, so it gets an atol
            tol = (dict(atol=2e-3, rtol=0) if k.startswith("dice_coef")
                   else dict(rtol=1e-4))
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert losses[2]["epoch_loss"] < losses[0]["epoch_loss"]
    # step-1 gradients: carry the port's through the weight converter
    stats1 = grads.pop("stats1")
    sd = {k: v.clone() for k, v in start.items()}
    sd.update(grads)
    got_grads, _ = to_flax(sd)
    # atol 2e-4 (largest gradient 5e-2): the JAX package's f32 gradients on
    # the CPU are what is up to 1.1e-4 away; the port's agree with its own
    # graph run in f64 to 2e-5 (test_step1_gradients_match_f64_run)
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(got_grads)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4,
                                   err_msg=str(path))
    # BN statistics (biased running variance): after step 1 the weights
    # are still equal, atol 1e-5; after step 3 each weight has moved by up
    # to 3 lr-sized AMSGrad steps whose signs can differ where a gradient
    # is ~0, which shifts a deep layer's channel mean by up to 2e-4: 5e-4
    _, stats3 = to_flax(model.state_dict())
    for want, got, atol in ((want_stats[0], stats1, 1e-5),
                            (want_stats[1], stats3, 5e-4)):
        for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
            np.testing.assert_allclose(g, np.asarray(w), atol=atol,
                                       err_msg=str(path))
    # parameters after three AMSGrad steps: lr-sized moves, same direction
    got_params, _ = to_flax(model.state_dict())
    close = [np.isclose(g, np.asarray(w), atol=2e-4).mean()
             for (_, w), (_, g) in zip(_leaves(want_params),
                                       _leaves(got_params))]
    assert min(close) > 0.95, min(close)


@pytest.mark.parametrize("impl", ["xla", "chain"])
def test_step1_gradients_match_f64_run(start, impl):
    """The same graph with f64 weights and activations (statistics and
    losses stay f32 as the modules compute them)."""
    _, grads, _, _ = _port_run(start, impl, n_steps=1)
    del grads["stats1"]
    broken, flaps, atlas = _pairs()
    model = build_model("UNetSP")
    model.load_state_dict(start)
    model.double().configure("xla", torch.float64).train()
    handler = FlapRecWithShapePriorDoubleOut()
    b, f = torch.from_numpy(broken), torch.from_numpy(flaps)
    x = torch.stack([b, torch.from_numpy(atlas)[None].expand(b.shape)], -1)
    targets = tuple(torch.stack(t) for t in zip(
        *[handler.targets_from_pair(i, j)[1] for i, j in zip(b, f)]))
    handler.compute_losses(model(x.double()), targets, LOSS)[0].backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(grads[k].numpy(), p.grad.numpy(),
                                   atol=5e-5, err_msg=k)


@pytest.mark.slow
def test_chain_step_matches_jax_chain_step(start):
    """One step with ``conv_impl = "chain"`` on both sides: the JAX side
    runs the Pallas kernel in interpret mode where its gate admits the
    layer."""
    broken, flaps, atlas = _pairs(batch=1)
    params, stats = to_flax(start)
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    jpc.set_conv_impl("chain")
    try:
        jm = jax_build_model("UNetSP", compute_dtype="float32",
                             use_checkpoint=False)
        opt = jsteps.make_optimizer(CFG)
        step = jsteps.make_train_step(jm, JHandler(), opt, LOSS, atlas=atlas,
                                      compute_dtype=jnp.float32,
                                      from_pairs=True, donate=False)
        state = jsteps.TrainState(params, stats, opt.init(params),
                                  jnp.zeros((), jnp.int32))
        _, want = step(state, {"image": jnp.asarray(broken),
                               "flap": jnp.asarray(flaps)}, jax.random.key(0))
        want = float(want["epoch_loss"])
    finally:
        jpc.set_conv_impl("xla")
    model = build_model("UNetSP")
    model.load_state_dict(start)
    model.configure("chain", torch.float32)
    st = steps.TrainState(model, steps.make_optimizer(CFG,
                                                      model.parameters()))
    _, got = steps.make_train_step(
        model, FlapRecWithShapePriorDoubleOut(), LOSS, atlas=atlas,
        compute_dtype=torch.float32, from_pairs=True)(
            st, {"image": torch.from_numpy(broken),
                 "flap": torch.from_numpy(flaps)},
            torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["epoch_loss"]), want, rtol=1e-4)


def test_eval_step_uses_running_statistics_and_changes_nothing(start):
    _, _, model, state = _port_run(start, "xla", n_steps=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    broken, flaps, atlas = _pairs()
    ev = steps.make_eval_step(model, FlapRecWithShapePriorDoubleOut(), LOSS,
                              atlas=atlas, compute_dtype=torch.float32,
                              from_pairs=True)
    terms, (out, targets) = ev(state, {"image": torch.from_numpy(broken),
                                       "flap": torch.from_numpy(flaps)},
                               torch.Generator().manual_seed(0))
    assert np.isfinite(float(terms["epoch_loss"]))
    assert out[0].shape == targets[0].shape == (2, *SHAPE, 2)
    assert not out[0].requires_grad
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_step_synthesizes_and_crops(start):
    """Without stored pairs the step punches its own holes from the
    generator; ``train_patch`` crops volume and atlas alike; an empty loss
    configuration is refused."""
    full = np.stack([spherical_shell(SHAPE, seed=i) for i in range(2)]
                    ).astype(np.float32)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    model = build_model("UNetSP")
    model.load_state_dict(start)
    handler = FlapRecWithShapePriorDoubleOut()
    state = steps.TrainState(model, steps.make_optimizer(CFG,
                                                         model.parameters()))
    runs = []
    for seed in (0, 0, 1):
        model.load_state_dict(start)
        step = steps.make_train_step(model, handler, LOSS, atlas=atlas,
                                     compute_dtype=torch.float32,
                                     train_patch=(16, 16, 16))
        _, terms = step(state, {"image": torch.from_numpy(full)},
                        torch.Generator().manual_seed(seed))
        runs.append(float(terms["epoch_loss"]))
    assert runs[0] == runs[1] != runs[2]
    crop = steps.make_crop_fn((8, 8, 8), torch.from_numpy(atlas))
    out, atlas_b = crop(torch.Generator().manual_seed(3),
                        {"image": torch.from_numpy(full),
                         "flap": torch.from_numpy(full)})
    assert out["image"].shape == atlas_b.shape == (2, 8, 8, 8)
    assert torch.equal(out["image"], out["flap"])
    vol = torch.arange(16 * 16 * 32.0).reshape(SHAPE)
    patch = steps.random_crop(torch.Generator().manual_seed(4), vol, (4, 4, 4))
    z, y, x = np.unravel_index(int(patch[0, 0, 0]), SHAPE)
    assert torch.equal(patch, vol[z:z + 4, y:y + 4, x:x + 4])
    with pytest.raises(ValueError, match="lambda"):
        steps.make_train_step(model, handler, dict(ce_lambda=0))


# --------------------------------------------------------------------------
# Model: train -> save -> resume -> test
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    csv = make_dataset(str(root / "data"), n=2, shape=SHAPE, seed=11)
    register_atlas(SHAPE, spherical_shell(SHAPE, radius_frac=0.42))
    params = dict(
        train_flag=True, test_flag=True, name="e2e", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(root / "ws"), train_files_csv=csv,
        validation_files_csv=csv, test_files_csv=csv, n_epochs=2,
        batch_size=1, optimizer="adam", learning_rate=1e-3, ce_lambda=1.0,
        dice_lambda=1.0, conv_impl="chain", compute_dtype="float32",
        save_dice_plots=True, save_hd_plots=True, autosave_epochs=2,
        packed_train=True, remat=False, scheduler=True)
    return root, csv, params, Model(params=params)


def test_model_trains_saves_and_serves(trained):
    root, csv, params, m = trained
    assert m.state.step == 4 and len(m.step_losses) == 2
    hist = m.writer.history
    for key in ("train/epoch/epoch_loss", "val/epoch/epoch_loss",
                "train/epoch/dice_coef_sk", "val/epoch/hd_coef_fl"):
        assert [s for s, _ in hist[key]] == [1, 2], key
        assert all(np.isfinite(v) for _, v in hist[key])
    assert hist["train/epoch/epoch_loss"][1][1] < \
        hist["train/epoch/epoch_loss"][0][1]
    model_dir = root / "ws" / "UNetSP_FlapRecWithShapePriorDoubleOut" / "model"
    assert (model_dir / "e2e.ckpt").is_file()
    assert (model_dir / "checkpoints" / "e2e_ep2.ckpt").is_file()
    out = sorted(glob.glob(str(root / "data" / "pred_e2e" / "*")))
    assert [os.path.basename(f) for f in out] == [
        f"skull_00{i}_{s}.nii.gz" for i in (0, 1) for s in ("fl", "i", "sk")]
    assert nifti.read(out[2]).data.shape == SHAPE
    # the TensorBoard file reads back with both packages' readers
    (events,) = glob.glob(str(root / "ws" / "runs" / "*" / "events.*"))
    for reader in (tb_writer.read_scalars, jax_tb.read_scalars):
        scalars = reader(events)
        assert [s for s, _ in scalars["val/epoch/epoch_loss"]] == [1, 2]
        np.testing.assert_allclose(
            [v for _, v in scalars["train/epoch/epoch_loss"]],
            [v for _, v in hist["train/epoch/epoch_loss"]], rtol=1e-6)


def test_checkpoint_round_trip(trained):
    root, _, _, m = trained
    ck = checkpoint.restore_checkpoint(str(
        root / "ws" / "UNetSP_FlapRecWithShapePriorDoubleOut" / "model"
        / "checkpoints" / "e2e_ep2.ckpt"))
    assert ck["step"] == 4 and ck["extra"] == {"epoch": 2}
    live = m.state.model.state_dict()
    assert set(ck["model"]) == set(live)
    for k, v in live.items():
        assert torch.equal(ck["model"][k], v), k
    group = ck["optimizer"]["param_groups"][0]
    assert group["count"] == 4 and group["plateau"]["scale"] == 1.0
    assert len(ck["optimizer"]["state"]) == len(list(
        m.state.model.parameters()))
    assert checkpoint.load_any(m.params["model_path"]).keys() == live.keys()
    with pytest.raises(ValueError, match="train-state"):
        torch.save({"x": 1}, str(root / "other.ckpt"))
        checkpoint.restore_checkpoint(str(root / "other.ckpt"))


def test_resume_restores_optimizer_state_and_step(trained):
    root, csv, params, m = trained
    resumed = Model(params=dict(
        params, name="e2e_resumed", test_flag=False, n_epochs=1,
        autosave_epochs=0, resume_model=str(
            root / "ws" / "UNetSP_FlapRecWithShapePriorDoubleOut" / "model"
            / "checkpoints" / "e2e_ep2.ckpt")))
    assert resumed.state.step == 4 + 2
    assert resumed.state.optimizer.param_groups[0]["count"] == 6
    p0 = next(iter(resumed.state.model.parameters()))
    assert float(resumed.state.optimizer.state[p0]["nu_max"].abs().sum()) > 0
    # it went on from the trained weights, not from the random start
    first = resumed.writer.history["train/epoch/epoch_loss"][0][1]
    assert first < m.writer.history["train/epoch/epoch_loss"][0][1]


def test_test_only_run_serves_the_saved_model(trained):
    root, csv, params, m = trained
    served = Model(params=dict(params, train_flag=False, name="e2e"))
    assert served.state is None and served.n_served == 2
    for k, v in m.state.model.state_dict().items():
        assert torch.equal(served.state_dict[k], v.cpu()), k


def test_model_train_without_card_raises_unless_cpu(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _, _, params, _ = trained
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(params=dict(params, device=None))


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------


def test_train_dataset_pairs_and_cache(tmp_path):
    full = spherical_shell(SHAPE, seed=1)
    paths = {}
    for name in ("a.nii.gz", "b_nfg_d.nii.gz", "b_nfg_i.nii.gz",
                 "c_nfg_d.nii.gz", "c_flap.nii.gz"):
        paths[name] = str(tmp_path / name)
        nifti.write(paths[name], nifti.NiftiImage(full, np.eye(4)))
    csv = tmp_path / "files.csv"
    csv.write_text("image,mask\n" + f"{paths['a.nii.gz']},\n"
                   + f"{paths['b_nfg_d.nii.gz']},\n"
                   + f"{paths['c_nfg_d.nii.gz']},{paths['c_flap.nii.gz']}\n")
    ds = FlapRecWShapePrior2OTrainDataset(str(csv))
    assert len(ds) == 3 and "flap" not in ds[0]
    assert ds[1]["flap"].shape == SHAPE and ds[2]["flap"].shape == SHAPE
    assert ds[0]["image"] is ds[0]["image"]  # decoded once
    assert not ds[0]["image"].flags.writeable
    DECODE_CACHE.clear()


def test_host_loader_sampling_and_prefetch(tmp_path):
    csv = make_dataset(str(tmp_path / "d"), n=5, shape=(8, 8, 8), seed=2)
    ds = FlapRecWShapePrior2OTrainDataset(csv)
    rep = HostLoader(ds, batch_size=2, shuffle=True, replacement=True, seed=1)
    assert len(rep) == 3
    names = [os.path.basename(p) for b in rep for p in b["filepath"]]
    assert len(names) == 5
    perm = HostLoader(ds, batch_size=2, shuffle=True, replacement=False,
                      seed=1, drop_remainder=True)
    got = [p for b in perm for p in b["filepath"]]
    assert len(perm) == 2 and len(got) == 4 and len(set(got)) == 4
    a = [p for b in HostLoader(ds, 1, shuffle=True, seed=3)
         for p in b["filepath"]]
    b = [p for b in HostLoader(ds, 1, shuffle=True, seed=3)
         for p in b["filepath"]]
    assert a == b  # the seed fixes the stream
    batches = list(device_prefetch(iter(HostLoader(ds, 2)),
                                   torch.device("cpu"), depth=2))
    assert [tuple(b["image"].shape) for b in batches] == [
        (2, 8, 8, 8), (2, 8, 8, 8), (1, 8, 8, 8)]
    assert batches[0]["image"].dtype == torch.float32
    assert isinstance(batches[0]["filepath"], list)
    DECODE_CACHE.clear()
