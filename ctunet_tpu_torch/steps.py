"""Train and eval steps, and the optimizer.

Counterpart of ``ctunet_tpu/steps.py``: a step fuses the on-device target
synthesis (virtual craniectomy), the atlas-channel stack, the forward and
backward in the compute dtype, the loss and the optimizer update. PyTorch
runs eagerly, so a step is a plain function; where the JAX step returns a
new state, this one updates the model's parameters, its BatchNorm buffers
and the optimizer state in place and returns the same ``TrainState``.

The optimizer is the port's own (:class:`Optimizer`): the JAX package builds
its update from optax transforms whose arithmetic differs from
``torch.optim`` (see the class), and the port is held against the JAX
package. ``b_fg_crop_train`` cuts every sample to a static foreground
window on the device before the synthesis (:func:`make_fg_crop_fn`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

@dataclasses.dataclass
class TrainState:
    """What a step carries: the model (parameters and BatchNorm
    statistics), the optimizer (its moments, count and plateau scale) and
    the step count."""

    model: torch.nn.Module
    optimizer: "Optimizer"
    step: int = 0


def _net_input(images: torch.Tensor, atlas: Optional[torch.Tensor],
               compute_dtype) -> torch.Tensor:
    """Stack the (synthesized) image and the optional atlas as trailing
    channels. ``images``: ``(B, D, H, W)``; ``atlas``: ``(D, H, W)``
    constant, ``(B, D, H, W)`` per-sample crops, or None."""
    chans = [images]
    if atlas is not None:
        chans.append(atlas if atlas.ndim == images.ndim
                     else atlas[None].expand(images.shape))
    return torch.stack(chans, -1).to(compute_dtype)


def _crop_start(gen: torch.Generator, shape, patch):
    maxs = [max(0, s - p) for s, p in zip(shape, patch)]
    u = torch.rand(3, generator=gen, device=gen.device).tolist()
    return [min(int(ui * (m + 1.0)), m) for ui, m in zip(u, maxs)]


def _slice(volume: torch.Tensor, start, patch) -> torch.Tensor:
    return volume[tuple(slice(s, s + p) for s, p in zip(start, patch))]


def random_crop(gen: torch.Generator, volume: torch.Tensor,
                patch) -> torch.Tensor:
    """Random crop of a ``(D, H, W)`` volume to ``patch``
    (``steps.py:50-62``)."""
    return _slice(volume, _crop_start(gen, volume.shape, patch), patch)


def make_crop_fn(train_patch, atlas: Optional[torch.Tensor]):
    """Batched random cropping with atlas alignment (``steps.py:65-105``):
    ``crop(gen, batch) -> (batch', atlas')``, every volume of a sample
    (image and, if present, flap) and the atlas sliced at the same
    per-sample offsets, so the prior stays registered."""
    patch = tuple(int(p) for p in train_patch)

    def crop(gen, batch):
        images = batch["image"]
        starts = [_crop_start(gen, images.shape[1:], patch)
                  for _ in range(images.shape[0])]
        out = dict(batch)
        for key in ("image", "flap"):
            if key in batch:
                out[key] = torch.stack([_slice(v, s, patch) for v, s in
                                        zip(batch[key], starts)])
        atlas_b = (None if atlas is None else
                   torch.stack([_slice(atlas, s, patch) for s in starts]))
        return out, atlas_b

    return crop


def make_fg_crop_fn(crop_size, atlas: Optional[torch.Tensor],
                    margin: int = 16, multiple: int = 16):
    """Batched foreground cropping with atlas alignment
    (``steps.py:108-182``), on the device and without a host round trip:
    per sample, the first nonzero index of each axis profile less
    ``margin``, snapped down to ``multiple`` and clamped so the static
    ``crop_size`` window stays on the canvas, gives the offsets; image,
    flap and atlas are gathered at them. The foreground is image OR flap
    (in pairs mode the flap fills the defect outside the broken skull's
    box). ``crop(gen, batch) -> (batch', atlas')``; ``batch'`` carries
    ``fg_lost``, each sample's foreground voxels outside its window."""
    size = tuple(int(s) for s in crop_size)

    def starts_of(fg):  # (B, D, H, W) bool -> (B, 3) int64
        offs = []
        for ax in range(3):
            other = tuple(i for i in range(1, 4) if i != ax + 1)
            prof = fg.to(torch.uint8).amax(dim=other)
            lo = torch.argmax(prof, -1)  # the first nonzero; 0 when empty
            lo = (torch.clamp(lo - margin, min=0) // multiple) * multiple
            offs.append(torch.clamp(lo, max=fg.shape[ax + 1] - size[ax]))
        return torch.stack(offs, -1)

    def gather(v, starts):
        """``v`` ``(B, D, H, W)`` (or ``(D, H, W)``, shared) -> each
        sample's window ``(B, *size)``."""
        out = []
        for i, st in enumerate(starts):
            w = v if v.ndim == 3 else v[i]
            for ax in range(3):
                idx = st[ax] + torch.arange(size[ax], device=w.device)
                w = w.index_select(ax, idx)
            out.append(w)
        return torch.stack(out)

    def crop(gen, batch):
        del gen  # deterministic given the data
        images = batch["image"]
        fg = images != 0
        if "flap" in batch:
            fg = fg | (batch["flap"] != 0)
        starts = starts_of(fg)
        out = dict(batch)
        out["image"] = gather(images, starts)
        if "flap" in batch:
            out["flap"] = gather(batch["flap"], starts)
        fg_i = fg.to(torch.int32)
        out["fg_lost"] = (fg_i.sum((1, 2, 3))
                          - gather(fg_i, starts).sum((1, 2, 3)))
        atlas_b = None if atlas is None else gather(atlas, starts)
        return out, atlas_b

    return crop


def fg_crop_size_for(volumes, canvas_shape, margin: int = 16,
                     multiple: int = 16):
    """The static window covering every volume's foreground plan
    (``steps.py:185-206``): the elementwise max of the ``plan_crop`` sizes
    of the ``(D, H, W)`` numpy ``volumes``, or None when one volume gains
    nothing from cropping or the window is the canvas."""
    from .ops import foreground

    sizes = None
    for vol in volumes:
        plan = foreground.plan_crop(vol, margin=margin, multiple=multiple)
        if plan is None:
            return None
        sizes = (plan[1] if sizes is None
                 else tuple(max(a, b) for a, b in zip(sizes, plan[1])))
    if sizes is None or all(s >= c for s, c in zip(sizes, canvas_shape)):
        return None
    return tuple(min(s, c) for s, c in zip(sizes, canvas_shape))


def make_synth_fn(handler, from_pairs: bool = False) -> Callable:
    """Batched on-device synthesis: ``(gen, batch) -> (images, targets)``
    with ``images`` ``(B, D, H, W)`` and the target ``(B, D, H, W, 2)``, or
    a tuple of them for the double-output handlers (``steps.py:209-223``).
    """

    def synth(gen, batch):
        images = batch["image"]
        if from_pairs:
            pairs = [handler.targets_from_pair(i, f)
                     for i, f in zip(images, batch["flap"])]
        else:
            pairs = [handler.synthesize(gen, i) for i in images]
        xs, targets = zip(*pairs)
        if isinstance(targets[0], tuple):
            return torch.stack(xs), tuple(torch.stack(t)
                                          for t in zip(*targets))
        return torch.stack(xs), torch.stack(targets)

    return synth


def _prepare(model, atlas, train_patch, fg_crop_size=None,
             fg_margin: int = 16):
    """The atlas on the model's device and the step's crop; the
    foreground window snaps to the model's pool multiple
    ``2 ** model.n_blocks`` (16, or 32 for the 5-block family)."""
    assert not (train_patch and fg_crop_size), (
        "train_patch and fg_crop_size are mutually exclusive")
    if atlas is not None:
        atlas = torch.as_tensor(np.asarray(atlas, np.float32),
                                device=next(model.parameters()).device)
    crop = None if train_patch is None else make_crop_fn(train_patch, atlas)
    if fg_crop_size is not None:
        crop = make_fg_crop_fn(fg_crop_size, atlas, margin=fg_margin,
                               multiple=2 ** model.n_blocks)
    return atlas, crop


def _cut(crop, gen, batch, atlas):
    """Apply the step's crop: ``(batch', atlas', fg_lost or None)``."""
    if crop is None:
        return batch, atlas, None
    batch, atlas = crop(gen, batch)
    return batch, atlas, batch.pop("fg_lost", None)


def make_train_step(model, handler, loss_cfg: Dict[str, Any], atlas=None,
                    compute_dtype=torch.bfloat16, from_pairs: bool = False,
                    train_patch=None, fg_crop_size=None,
                    fg_margin: int = 16):
    """Build the training step (``steps.py:226-312``).

    ``step(state, batch, gen) -> (state, terms)`` with ``batch``
    ``{'image': (B,D,H,W) f32[, 'flap': ...]}`` on the device and ``gen``
    the ``torch.Generator`` of the synthesis draws. With ``train_patch``
    the volumes (and the atlas, at matched offsets) are randomly cropped
    before synthesis; with ``fg_crop_size`` (exclusive with it) they are
    cut to that static foreground window (:func:`make_fg_crop_fn`, planned
    with ``fg_margin`` and the model's pool multiple, 16 or 32) and the
    terms gain
    ``fg_lost_voxels``, the batch's largest count of foreground voxels
    outside the window. ``terms`` are detached scalars on the device.
    """
    if not (loss_cfg.get("ce_lambda") or loss_cfg.get("dice_lambda")):
        raise ValueError(
            "Both ce_lambda and dice_lambda are unset/zero: the training "
            "loss would be empty. Set f_dice_lambda / f_ce_lambda in the "
            "config (the reference example INIs set both to 1).")
    synth = make_synth_fn(handler, from_pairs)
    atlas_c, crop = _prepare(model, atlas, train_patch, fg_crop_size,
                             fg_margin)

    def step(state: TrainState, batch, gen):
        batch, atlas_x, fg_lost = _cut(crop, gen, batch, atlas_c)
        with torch.no_grad():
            images, targets = synth(gen, batch)
            x = _net_input(images, atlas_x, compute_dtype)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(x)
        loss, terms = handler.compute_losses(out, targets, loss_cfg)
        loss.backward()
        state.optimizer.step(value=loss.detach())
        state.step += 1
        terms = {k: v.detach() for k, v in terms.items()}
        if fg_lost is not None:
            terms["fg_lost_voxels"] = fg_lost.max()
        return state, terms

    return step


def make_eval_step(model, handler, loss_cfg: Dict[str, Any], atlas=None,
                   compute_dtype=torch.bfloat16, from_pairs: bool = False,
                   train_patch=None, fg_crop_size=None,
                   fg_margin: int = 16):
    """Validation step: synthesize targets, forward on the running
    BatchNorm statistics, losses (``steps.py:315-358``); the crops as in
    :func:`make_train_step`.
    ``step(state, batch, gen) -> (terms, (out, targets))``."""
    synth = make_synth_fn(handler, from_pairs)
    atlas_c, crop = _prepare(model, atlas, train_patch, fg_crop_size,
                             fg_margin)

    @torch.no_grad()
    def step(state: TrainState, batch, gen):
        batch, atlas_x, fg_lost = _cut(crop, gen, batch, atlas_c)
        images, targets = synth(gen, batch)
        x = _net_input(images, atlas_x, compute_dtype)
        model.eval()
        out = model(x)
        _, terms = handler.compute_losses(out, targets, loss_cfg)
        if fg_lost is not None:
            terms = dict(terms, fg_lost_voxels=fg_lost.max())
        return terms, (out, targets)

    return step


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------

_PLATEAU = dict(factor=0.1, patience=10, rtol=1e-4, atol=0.0, cooldown=0,
                min_scale=0.0)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` rounded as optax rounds it, in f32: at count 1
    and ``decay`` 0.999 that is 1.3e-5 off the exact 0.001. (optax's power
    goes through XLA's ``powf``, which can be another ulp off, so the two
    packages agree to about 1e-5 of an update here, not to the bit.)"""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


class Optimizer(torch.optim.Optimizer):
    """The update of ``ctunet_tpu.steps.make_optimizer``, transform by
    transform as optax (0.2.6) computes it, in place on f32 parameters.

    ``name``:

    - ``adam``: ``optax.amsgrad``, with L2 decay added to the gradient
      first when ``weight_decay`` is set. The running maximum is taken of
      the **bias-corrected** second moment (``nu_max = max(nu_max,
      nu_hat)``); ``torch.optim.Adam(amsgrad=True)`` takes it of the raw
      moment and corrects afterwards, so the two differ from step 2 on;
    - ``adamw``: the same direction plus decoupled ``weight_decay * p``,
      then the learning rate;
    - ``rmsprop``: ``nu`` starts at 0, ``g * rsqrt(nu + eps)`` with eps
      inside the root (torch adds it outside), the learning rate, then the
      momentum trace on the scaled update;
    - ``sgd``: momentum trace ``t = g + momentum * t``, then the learning
      rate.

    ``scheduler``: ``optax.contrib.reduce_on_plateau`` with torch's
    ``ReduceLROnPlateau`` defaults, stepped per batch with the batch loss
    (``step(value=loss)``, quirk Q4). It scales the update, not a stored
    learning rate, applies a new scale in the step that found the plateau,
    and reduces when the count of bad steps **equals** ``patience`` (torch
    waits for one more).

    Count, plateau state and hyper-parameters live in the param group, the
    moments in ``state``, so ``state_dict()`` carries all of them.
    """

    def __init__(self, params, name: str = "adam", lr: float = 1e-4,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 scheduler: bool = False, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, rms_decay: float = 0.9):
        name = name.lower()
        if name not in ("adam", "adamw", "rmsprop", "sgd"):
            raise KeyError(f"Unknown optimizer '{name}'")
        plateau = (dict(best=float("inf"), bad=0, scale=1.0, cooldown=0)
                   if scheduler else None)
        super().__init__(params, dict(
            name=name, lr=lr, weight_decay=weight_decay, momentum=momentum,
            b1=b1, b2=b2, eps=eps, rms_decay=rms_decay, count=0,
            plateau=plateau))

    @staticmethod
    def _plateau_scale(st: Dict[str, Any], value: float) -> float:
        """One ``reduce_on_plateau`` update (accumulation size 1), in f32
        like optax; returns the scale to apply now."""
        f32 = np.float32
        c = _PLATEAU
        best = f32(st["best"])
        improved = f32(value) < f32(1 - c["rtol"]) * best - f32(c["atol"])
        if improved:
            st["best"] = float(f32(value))
        bad = 0 if improved else st["bad"] + 1
        if st["cooldown"] > 0:
            st["bad"] = 0
            st["cooldown"] -= 1
            return st["scale"]
        hit = bad == c["patience"]
        st["bad"] = 0 if hit else bad
        if hit:
            st["scale"] = float(max(f32(st["scale"]) * f32(c["factor"]),
                                    f32(c["min_scale"])))
        st["cooldown"] = c["cooldown"] if hit else 0
        return st["scale"]

    @torch.no_grad()
    def step(self, value=None):
        """Apply one update from the parameters' ``.grad``. ``value``: the
        batch loss, read by the plateau scheduler when it is on."""
        for group in self.param_groups:
            group["count"] += 1
            n, name = group["count"], group["name"]
            lr, wd, mom = group["lr"], group["weight_decay"], group["momentum"]
            scale = 1.0
            if group["plateau"] is not None:
                if value is None:
                    raise ValueError("the plateau scheduler needs "
                                     "step(value=loss)")
                scale = self._plateau_scale(group["plateau"], float(value))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if wd and name != "adamw":
                    g = g + wd * p
                if name in ("adam", "adamw"):
                    if not st:
                        st.update(mu=torch.zeros_like(p),
                                  nu=torch.zeros_like(p),
                                  nu_max=torch.zeros_like(p))
                    b1, b2 = group["b1"], group["b2"]
                    st["mu"] = (1 - b1) * g + b1 * st["mu"]
                    st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                    mu_hat = st["mu"] / _bias_correction(b1, n)
                    nu_hat = st["nu"] / _bias_correction(b2, n)
                    st["nu_max"] = torch.maximum(st["nu_max"], nu_hat)
                    u = mu_hat / (torch.sqrt(st["nu_max"]) + group["eps"])
                    if name == "adamw":
                        u = u + wd * p
                    u = -lr * u
                elif name == "rmsprop":
                    if not st:
                        st.update(nu=torch.zeros_like(p),
                                  trace=torch.zeros_like(p))
                    d = group["rms_decay"]
                    st["nu"] = (1 - d) * (g * g) + d * st["nu"]
                    u = -lr * (torch.rsqrt(st["nu"] + group["eps"]) * g)
                    st["trace"] = u + mom * st["trace"]
                    u = st["trace"]
                else:  # sgd
                    if mom:
                        if not st:
                            st.update(trace=torch.zeros_like(p))
                        st["trace"] = g + mom * st["trace"]
                        g = st["trace"]
                    u = -lr * g
                p.add_(scale * u if scale != 1.0 else u)


def make_optimizer(params_cfg: Dict[str, Any], parameters) -> Optimizer:
    """Build the optimizer from the reference config keys
    (``steps.py:399-447``; ref ``Model.initialize_optimizer``,
    ``Model.py:510-546``)."""
    return Optimizer(
        parameters, name=params_cfg.get("optimizer") or "adam",
        lr=params_cfg.get("learning_rate") or 1e-4,
        weight_decay=params_cfg.get("weight_decay") or 0.0,
        momentum=params_cfg.get("momentum") or 0.0,
        scheduler=bool(params_cfg.get("scheduler")))
