"""Data-parallel training in ``ctunet_tpu_torch``: ranks equal one process.

Two gloo ranks on the CPU (``parallel.spawn``), each holding one sample of
a global batch of 2, against one process stepping on the whole batch:

- one train step (``steps.make_train_step`` with a ``DataShard``): the
  gradients before the optimizer within 1e-5 of the largest gradient
  entry and within 1e-4 of each tensor's largest, the BatchNorm batch statistics within 1e-5 of each statistic's
  largest, the loss within 1e-5 relative, the parameters after the step
  bit-equal across the ranks.
  Per-rank BatchNorm statistics, a BatchNorm all-reduce whose backward
  passes the gradient through unsummed, or gradients summed instead of
  averaged, fail it; it is held on gradients because Adam's update hides their scale;
- the synthesis draws a rank's samples get are the single-process batch's;
- ``Model`` with ``b_distributed`` and ``i_mesh_data = 2`` (2 epochs at
  32^3) against the single-process batch-2 history: every loss term within
  1e-5 absolute (the JAX package's 2-process loop is within 7.2e-6,
  ``MULTIHOST.json``), the argmax Dice coefficients within 1e-4 (one
  near-tie voxel); rank 0 alone writing the checkpoint and the events.
"""

import glob
import os

import numpy as np
import pytest
import torch

from ctunet_tpu_torch import parallel, steps
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.unet import BatchNorm, sync_batch_stats
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut

SHAPE = (16, 16, 16)
LOSS_CFG = dict(ce_lambda=1.0, dice_lambda=1.0)
OPT = dict(optimizer="adam", learning_rate=1e-3)


def _batch():
    """A fixed global batch of 2 stored (broken skull, flap) pairs and an
    atlas: the pairs path draws nothing."""
    from ctunet_tpu_torch.data import spherical_shell

    rng = np.random.default_rng(3)
    vols = np.stack([spherical_shell(SHAPE, radius_frac=f)
                     for f in (0.40, 0.34)]).astype(np.float32)
    flap = (vols * (rng.random(vols.shape) < 0.2)).astype(np.float32)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    return vols - flap, flap, atlas


def _one_step(shard, conv_impl):
    """One train step on the samples of ``shard`` (all of them without);
    returns the gradients, the BatchNorm batch statistics and the
    parameters after the step, as numpy."""
    torch.manual_seed(0)
    model = build_model("UNetSP").configure(conv_impl, torch.float32)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0  # the running statistics become the batch's
    if shard is not None:
        sync_batch_stats(model, shard.group, shard.size)
    image, flap, atlas = _batch()
    if shard is not None:
        image, flap = image[shard.index:shard.index + 1], \
            flap[shard.index:shard.index + 1]
    state = steps.TrainState(model, steps.make_optimizer(
        OPT, model.parameters()))
    step = steps.make_train_step(
        model, FlapRecWithShapePriorDoubleOut(), LOSS_CFG, atlas=atlas,
        compute_dtype=torch.float32, from_pairs=True, shard=shard)
    _, terms = step(state, {"image": torch.from_numpy(image),
                            "flap": torch.from_numpy(flap)},
                    torch.Generator().manual_seed(0))
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    return dict(grads=grads, stats=stats, params=params,
                loss=float(terms["epoch_loss"]))


def _dp_step_rank(rank, conv_impl):
    torch.set_num_threads(1)
    parallel.initialize_from_params(dict(distributed=True, device="cpu"))
    mesh = parallel.make_mesh(2, 1)
    shard = steps.DataShard(mesh.data_group, mesh.data, mesh.data_index)
    return _one_step(shard, conv_impl)


def _rel(got, want, per_tensor: bool):
    """The largest error of a set of tensors relative to each tensor's own
    largest entry (``per_tensor``) or to the largest entry of the set."""
    top = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - w).max())
               / (float(np.abs(w).max()) if per_tensor else top)
               for k, w in want.items())


@pytest.mark.parametrize("conv_impl", ["xla", "chain"])
def test_dp_step_matches_single_process_batch(conv_impl):
    ranks = parallel.spawn(_dp_step_rank, 2, (conv_impl,))
    ref = _one_step(None, conv_impl)
    for r, got in enumerate(ranks):
        # gradients: within 1e-5 of the model's largest gradient entry, and
        # each tensor within 1e-4 of its own largest: there the deepest
        # layers' f32 noise reaches 1.3e-5 (the two runs sum the BatchNorm
        # statistics in another order, and its backward cancels)
        g = _rel(got["grads"], ref["grads"], per_tensor=False)
        gt = _rel(got["grads"], ref["grads"], per_tensor=True)
        s = _rel(got["stats"], ref["stats"], per_tensor=True)
        print(f"rank {r}: gradients {g:.2e} of the largest, per tensor "
              f"{gt:.2e}; BatchNorm statistics {s:.2e}")
        assert g <= 1e-5, f"rank {r}: gradients {g:.2e} from the batch's"
        assert gt <= 1e-4, f"rank {r}: a gradient tensor {gt:.2e} off"
        assert s <= 1e-5, f"rank {r}: BatchNorm statistics {s:.2e} off"
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(v, ranks[1]["params"][k]), k


def test_dp_synthesis_draws_match_single_process():
    """Each rank's samples get the synthesis draws of the single-process
    batch, and every rank's stream ends where the single process's does
    (the next step draws on)."""
    from ctunet_tpu_torch.data import spherical_shell

    handler = FlapRecWithShapePriorDoubleOut()
    vols = torch.from_numpy(np.stack([
        spherical_shell(SHAPE, radius_frac=f) for f in (0.40, 0.36, 0.33,
                                                         0.30)
    ]).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    want_x, want_t = steps.make_synth_fn(handler)(gen, {"image": vols})
    want_next = torch.rand(4, generator=gen)
    for index in range(2):
        shard = steps.DataShard(None, 2, index)
        gen = torch.Generator().manual_seed(9)
        sl = slice(2 * index, 2 * index + 2)
        x, t = steps.make_synth_fn(handler, shard=shard)(
            gen, {"image": vols[sl]})
        assert torch.equal(x, want_x[sl])
        for a, b in zip(t, want_t):
            assert torch.equal(a, b[sl])
        assert torch.equal(torch.rand(4, generator=gen), want_next)


def _model_params(root, csv, name, **kw):
    """The settings of the JAX package's 2-process test
    (``tests/test_distributed.py``), at the learning rate of
    ``examples/UNetSPDO/FlapRecSP2O.ini`` (1e-4). At 1e-3 (this test at
    that rate), epoch 2's ``ce_sk`` moves by 3.1e-5: Adam's first update,
    ``lr * g / |g|``, turns the f32 noise of the weights whose gradients
    sit at the noise of the BatchNorm statistics' summation order (4e-9
    to 4e-8) into steps of up to ``lr``."""
    return dict(
        train_flag=True, test_flag=False, name=name, model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        n_epochs=2, batch_size=2, dice_lambda=1.0, ce_lambda=1.0,
        optimizer="adam", learning_rate=1e-4, conv_impl="chain",
        compute_dtype="float32", workspace_path=str(root / f"ws_{name}"),
        train_files_csv=csv, validation_files_csv=csv, autosave_epochs=0,
        save_dice_plots=True, n_workers=1, log_every=0, seed=0, **kw)


def _model_rank(rank, root, csv):
    from ctunet_tpu_torch import Model
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.data.atlas import register_atlas

    torch.set_num_threads(1)
    register_atlas((32, 32, 32), spherical_shell((32, 32, 32)))
    m = Model(params=_model_params(root, csv, f"dp{rank}", distributed=True,
                                   mesh_data=2))
    return dict(history={k: [v for _, v in vals]
                         for k, vals in m.writer.history.items()},
                local_batch=m.data["train_loader"].batch_size
                // m.data["train_loader"].num_processes,
                steps=m.state.step, workspace=m.params["workspace_path"],
                model_path=m.params["model_path"])


def test_two_rank_model_history_matches_single_process(tmp_path):
    from ctunet_tpu_torch import Model
    from ctunet_tpu_torch.data import make_dataset, spherical_shell
    from ctunet_tpu_torch.data.atlas import register_atlas

    csv = make_dataset(str(tmp_path / "data"), n=4, shape=(32, 32, 32),
                       seed=11)
    register_atlas((32, 32, 32), spherical_shell((32, 32, 32)))
    ranks = parallel.spawn(_model_rank, 2, (tmp_path, csv))
    ref = Model(params=_model_params(tmp_path, csv, "ref"))
    want = {k: [v for _, v in vals] for k, vals in ref.writer.history.items()}
    assert ref.state.step == 4
    for r, got in enumerate(ranks):
        assert got["local_batch"] == 1 and got["steps"] == 4
        assert set(got["history"]) == set(want)
        print(f"rank {r}: largest history delta by key",
              {k: float(np.max(np.abs(np.subtract(got["history"][k], w))))
               for k, w in want.items()})
        for k, w in want.items():
            # the loss terms within 1e-5; a Dice coefficient of argmax masks
            # moves by a whole voxel where a near-tie flips (2.7e-5 of the
            # flap's Dice here), so within 1e-4
            atol = 1e-4 if "dice_coef" in k else 1e-5
            np.testing.assert_allclose(got["history"][k], w, rtol=0,
                                       atol=atol, err_msg=f"rank {r} {k}")
    # rank 0 alone writes the checkpoint and the events
    for r, got in enumerate(ranks):
        events = glob.glob(os.path.join(got["workspace"], "runs", "*", "*"))
        assert os.path.exists(got["model_path"]) == (r == 0)
        assert bool(events) == (r == 0), events
