"""PyTorch port, the optimizer against ``ctunet_tpu.steps.make_optimizer``.

Fixed gradients from a numpy seed go through the optax chain and through
``ctunet_tpu_torch.steps.Optimizer``; parameters must agree after every
step to rtol 1e-6 (f32 arithmetic in the same order), with an atol for
entries near zero of 1e-8, or for the Adam family 2e-5 of the learning rate:
optax's f32 ``1 - b2**count`` goes through XLA's ``powf``, which is an ulp
off the correctly rounded power, and near count 1 that moves an update by
up to 1e-5 of its size. The plateau scale is held against
``optax.contrib.reduce_on_plateau`` on a made-up loss series.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctunet_tpu import steps as jsteps
from ctunet_tpu_torch import steps as tsteps

SHAPES = ((3, 3, 3, 4, 5), (7,))


def _series(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(
        np.float32) for s in SHAPES] for _ in range(n_steps)]
    return params, grads


def _run_jax(cfg, params, grads, losses):
    opt = jsteps.make_optimizer(cfg)
    p = [jnp.asarray(a) for a in params]
    state = opt.init(p)
    out = []
    for g, loss in zip(grads, losses):
        updates, state = opt.update([jnp.asarray(a) for a in g], state, p,
                                    value=jnp.float32(loss))
        p = optax.apply_updates(p, updates)
        out.append([np.asarray(a) for a in p])
    return out


def _run_port(cfg, params, grads, losses):
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = tsteps.make_optimizer(cfg, p)
    out = []
    for g, loss in zip(grads, losses):
        for pi, gi in zip(p, g):
            pi.grad = torch.from_numpy(gi.copy())
        opt.step(value=torch.tensor(loss))
        out.append([pi.detach().numpy().copy() for pi in p])
    return out, opt


def _atol(case: str) -> float:
    adam = CASES[case].get("optimizer", "adam").startswith("adam")
    return 2e-5 * CASES[case].get("learning_rate", 1e-4) if adam else 1e-8


CASES = {
    "adam": dict(optimizer="adam", learning_rate=1e-2),
    "adam_l2": dict(optimizer="adam", learning_rate=1e-2, weight_decay=0.05),
    "adamw": dict(optimizer="adamw", learning_rate=1e-2, weight_decay=0.05),
    "rmsprop": dict(optimizer="rmsprop", learning_rate=1e-3, momentum=0.9,
                    weight_decay=0.01),
    "rmsprop_plain": dict(optimizer="rmsprop", learning_rate=1e-3),
    "sgd": dict(optimizer="sgd", learning_rate=1e-2, momentum=0.9,
                weight_decay=0.01),
    "sgd_plain": dict(optimizer="sgd", learning_rate=1e-2),
    "default": dict(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_optax(case):
    params, grads = _series(5)
    losses = [1.0] * 5
    want = _run_jax(CASES[case], params, grads, losses)
    got, _ = _run_port(CASES[case], params, grads, losses)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=_atol(case),
                                       err_msg=f"{case} step {step + 1}")


def test_amsgrad_is_optax_not_torch():
    """optax takes the running maximum of the bias-corrected second moment,
    ``torch.optim.Adam(amsgrad=True)`` of the raw one: equal at step 1,
    apart from step 2 on when the gradient shrinks."""
    params, grads = _series(3, seed=1)
    grads = [[g * s for g in gs] for gs, s in zip(grads, (1.0, 0.1, 0.1))]
    got, _ = _run_port(CASES["adam"], params, grads, [1.0] * 3)
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = torch.optim.Adam(p, lr=1e-2, amsgrad=True)
    theirs = []
    for g in grads:
        for pi, gi in zip(p, g):
            pi.grad = torch.from_numpy(gi.copy())
        opt.step()
        theirs.append([pi.detach().numpy().copy() for pi in p])
    np.testing.assert_allclose(got[0][0], theirs[0][0], rtol=1e-5, atol=1e-7)
    assert np.abs(got[2][0] - theirs[2][0]).max() > 1e-4


def _loss_series():
    # improves, stalls for 12 steps, improves by less than rtol, stalls on
    s = [2.0, 1.5, 1.2] + [1.2] * 12 + [1.19995] + [1.3] * 14 + [0.5] * 3
    return [np.float32(v) for v in s]


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_plateau_scale_matches_optax(name):
    losses = _loss_series()
    cfg = dict(optimizer=name, learning_rate=1e-2, scheduler=True)
    params, grads = _series(len(losses), seed=2)
    want = _run_jax(cfg, params, grads, losses)
    got, opt = _run_port(cfg, params, grads, losses)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=_atol(name),
                                       err_msg=f"step {step + 1}")
    assert opt.param_groups[0]["plateau"]["scale"] == pytest.approx(1e-2)


def test_plateau_scale_sequence_and_torch_difference():
    """The scale sequence itself, against optax's transform alone; torch's
    ``ReduceLROnPlateau`` reduces one step later (``> patience``)."""
    losses = _loss_series()
    tx = optax.contrib.reduce_on_plateau(factor=0.1, patience=10, rtol=1e-4,
                                         atol=0.0, cooldown=0, min_scale=0.0)
    state = tx.init(jnp.zeros(()))
    want = []
    for v in losses:
        _, state = tx.update(jnp.ones(()), state, value=v)
        want.append(float(state.scale))
    st = dict(best=float("inf"), bad=0, scale=1.0, cooldown=0)
    got = [tsteps.Optimizer._plateau_scale(st, float(v)) for v in losses]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the 10th bad step (index 12) already runs at the reduced scale
    assert got[11] == 1.0 and got[12] == pytest.approx(0.1)
    p = torch.nn.Parameter(torch.zeros(1))
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        torch.optim.SGD([p], lr=1.0))
    theirs = []
    for v in losses:
        sched.step(float(v))
        theirs.append(sched.get_last_lr()[0])
    assert theirs[12] == 1.0 and theirs[13] == pytest.approx(0.1)


def test_scheduler_needs_the_loss_and_unknown_name_raises():
    p = [torch.nn.Parameter(torch.zeros(2))]
    p[0].grad = torch.ones(2)
    opt = tsteps.make_optimizer(dict(scheduler=True), p)
    with pytest.raises(ValueError, match="value=loss"):
        opt.step()
    with pytest.raises(KeyError, match="Unknown optimizer"):
        tsteps.make_optimizer(dict(optimizer="lion"), p)


@pytest.mark.parametrize("case", ["adam", "rmsprop", "sgd"])
def test_state_dict_round_trip_continues_the_run(case):
    """Moments, count and plateau state survive ``state_dict``: a restored
    optimizer goes on exactly where the saved one stood."""
    cfg = dict(CASES[case], scheduler=True)
    params, grads = _series(8, seed=3)
    losses = [1.0] * 8
    full, _ = _run_port(cfg, params, grads, losses)
    half, opt = _run_port(cfg, params, grads[:4], losses[:4])
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in half[-1]]
    opt2 = tsteps.make_optimizer(cfg, p)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.param_groups[0]["count"] == 4
    for g in grads[4:]:
        for pi, gi in zip(p, g):
            pi.grad = torch.from_numpy(gi.copy())
        opt2.step(value=torch.tensor(1.0))
    for a, b in zip(p, full[-1]):
        np.testing.assert_array_equal(a.detach().numpy(), b)
