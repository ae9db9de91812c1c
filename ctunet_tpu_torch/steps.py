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

Data parallelism (``shard``, a :class:`DataShard`): each data rank of a
multi-process run steps on its slice of the global batch. The BatchNorm
statistics are the global batch's (``models/unet.py::sync_batch_stats``),
the gradients are averaged over the data ranks before the optimizer, the
terms are the global batch's, and every random draw a sample gets is the
one it gets in the single-process batch: the synthesis stream skips the
draws of the other ranks' samples (:func:`skip_synthesis_draws`; no draw
depends on voxel values, so a sample's draws depend on its shape alone).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .ops.kernels import adam as adam_kernel
from .utils.profiling import count, span


class DataShard(NamedTuple):
    """This rank's place among the ``size`` data ranks of ``group``: it
    holds samples ``index * b .. (index + 1) * b`` of each global batch of
    ``size * b``."""

    group: Any
    size: int
    index: int


def _global_samples(shard: Optional[DataShard], b: int):
    """``(number of samples in the global batch, first sample of this
    rank's slice)`` for a local batch of ``b``."""
    if shard is None:
        return b, 0
    return shard.size * b, shard.index * b


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


def make_crop_fn(train_patch, atlas: Optional[torch.Tensor],
                 shard: Optional[DataShard] = None):
    """Batched random cropping with atlas alignment (``steps.py:65-105``):
    ``crop(gen, batch) -> (batch', atlas')``, every volume of a sample
    (image and, if present, flap) and the atlas sliced at the same
    per-sample offsets, so the prior stays registered. With ``shard`` the
    offsets of the whole global batch are drawn and this rank's kept."""
    patch = tuple(int(p) for p in train_patch)

    def crop(gen, batch):
        images = batch["image"]
        b = images.shape[0]
        total, first = _global_samples(shard, b)
        starts = [_crop_start(gen, images.shape[1:], patch)
                  for _ in range(total)][first:first + b]
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


def skip_synthesis_draws(gen: torch.Generator, handler, like: torch.Tensor,
                         n: int, offsets: Dict[Any, int]) -> None:
    """Advance ``gen`` past the draws ``handler.synthesize`` makes for
    ``n`` samples shaped like ``like``, without synthesizing them.

    On the card the Philox generator jumps: each draw advances its offset
    by an amount fixed by the draw's size, so one synthesis on a scratch
    generator measures a sample's advance once per shape (kept in
    ``offsets``). The CPU generator (Mersenne Twister) cannot jump, so
    there the samples are synthesized on a blank volume and dropped."""
    if n == 0:
        return
    if gen.device.type != "cuda":
        blank = torch.zeros_like(like)
        for _ in range(n):
            handler.synthesize(gen, blank)
        return
    key = (tuple(like.shape), like.dtype)
    if key not in offsets:
        probe = torch.Generator(device=gen.device)
        start = probe.get_offset()
        handler.synthesize(probe, torch.zeros_like(like))
        offsets[key] = probe.get_offset() - start
    gen.set_offset(gen.get_offset() + n * offsets[key])


def make_synth_fn(handler, from_pairs: bool = False,
                  shard: Optional[DataShard] = None) -> Callable:
    """Batched on-device synthesis: ``(gen, batch) -> (images, targets)``
    with ``images`` ``(B, D, H, W)`` and the target ``(B, D, H, W, 2)``, or
    a tuple of them for the double-output handlers (``steps.py:209-223``).
    With ``shard`` the stream skips the draws of the samples before and
    after this rank's slice of the global batch
    (:func:`skip_synthesis_draws`), so this rank's samples get the draws
    of the single-process batch.
    """
    offsets: Dict[Any, int] = {}

    def synth(gen, batch):
        images = batch["image"]
        if from_pairs:
            pairs = [handler.targets_from_pair(i, f)
                     for i, f in zip(images, batch["flap"])]
        else:
            b = images.shape[0]
            total, first = _global_samples(shard, b)
            skip_synthesis_draws(gen, handler, images[0], first, offsets)
            pairs = [handler.synthesize(gen, v) for v in images]
            skip_synthesis_draws(gen, handler, images[0], total - first - b,
                                 offsets)
        xs, targets = zip(*pairs)
        if isinstance(targets[0], tuple):
            return torch.stack(xs), tuple(torch.stack(t)
                                          for t in zip(*targets))
        return torch.stack(xs), torch.stack(targets)

    return synth


def _prepare(model, atlas, train_patch, fg_crop_size=None,
             fg_margin: int = 16, shard: Optional[DataShard] = None):
    """The atlas on the model's device and the step's crop; the
    foreground window snaps to the model's pool multiple
    ``2 ** model.n_blocks`` (16, or 32 for the 5-block family)."""
    assert not (train_patch and fg_crop_size), (
        "train_patch and fg_crop_size are mutually exclusive")
    if atlas is not None:
        atlas = torch.as_tensor(np.asarray(atlas, np.float32),
                                device=next(model.parameters()).device)
    crop = (None if train_patch is None
            else make_crop_fn(train_patch, atlas, shard))
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
                    fg_margin: int = 16,
                    shard: Optional[DataShard] = None):
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
    With ``shard`` the step is one data rank's part of the global batch's
    step (module docstring): gradients averaged over the data ranks at one
    point, before the optimizer, for every ``conv_impl``.

    Spans (``utils/profiling.py``): ``ctunet.train.step`` around its
    phases ``ctunet.train.synthesis`` (the crop, the synthesis, the network
    input; timed on the device too on the card), ``.forward``, ``.loss``,
    ``.backward`` (with the data ranks' gradient average) and
    ``.optimizer``.
    """
    if not (loss_cfg.get("ce_lambda") or loss_cfg.get("dice_lambda")):
        raise ValueError(
            "Both ce_lambda and dice_lambda are unset/zero: the training "
            "loss would be empty. Set f_dice_lambda / f_ce_lambda in the "
            "config (the reference example INIs set both to 1).")
    synth = make_synth_fn(handler, from_pairs, shard)
    atlas_c, crop = _prepare(model, atlas, train_patch, fg_crop_size,
                             fg_margin, shard)

    cuda = next(model.parameters()).device.type == "cuda"

    def step(state: TrainState, batch, gen):
        with span("ctunet.train.step"):
            with span("ctunet.train.synthesis", device=cuda):
                batch, atlas_x, fg_lost = _cut(crop, gen, batch, atlas_c)
                with torch.no_grad():
                    images, targets = synth(gen, batch)
                    x = _net_input(images, atlas_x, compute_dtype)
            with span("ctunet.train.forward"):
                model.train()
                state.optimizer.zero_grad(set_to_none=True)
                out = model(x)
            with span("ctunet.train.loss"):
                loss, terms = handler.compute_losses(out, targets, loss_cfg)
            with span("ctunet.train.backward"):
                loss.backward()
                if shard is not None:
                    average_gradients(model.parameters(), shard)
            with span("ctunet.train.optimizer"):
                terms = {k: v.detach() for k, v in terms.items()}
                if fg_lost is not None:
                    terms["fg_lost_voxels"] = fg_lost.max()
                if shard is not None:
                    terms = global_terms(terms, shard)
                state.optimizer.step(value=terms["epoch_loss"])
                state.step += 1
        return state, terms

    return step


def make_eval_step(model, handler, loss_cfg: Dict[str, Any], atlas=None,
                   compute_dtype=torch.bfloat16, from_pairs: bool = False,
                   train_patch=None, fg_crop_size=None,
                   fg_margin: int = 16,
                   shard: Optional[DataShard] = None):
    """Validation step: synthesize targets, forward on the running
    BatchNorm statistics, losses (``steps.py:315-358``); the crops and
    ``shard`` as in :func:`make_train_step` (the terms are the global
    batch's; ``(out, targets)`` this rank's).
    ``step(state, batch, gen) -> (terms, (out, targets))``."""
    synth = make_synth_fn(handler, from_pairs, shard)
    atlas_c, crop = _prepare(model, atlas, train_patch, fg_crop_size,
                             fg_margin, shard)

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
        if shard is not None:
            terms = global_terms(terms, shard)
        return terms, (out, targets)

    return step


def average_gradients(parameters, shard: DataShard) -> None:
    """Replace each parameter's ``.grad`` by its mean over the data ranks:
    one all-reduce per gradient dtype of the gradients laid end to end.
    Each rank's gradient is its share of the gradient of the sum of the
    ranks' losses (the BatchNorm all-reduce carries the others' terms), so
    the mean is the gradient of the global batch's mean loss."""
    import torch.distributed as dist

    by_dtype: Dict[torch.dtype, list] = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=shard.group)
        flat /= shard.size
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def global_terms(terms: Dict[str, torch.Tensor],
                 shard: DataShard) -> Dict[str, torch.Tensor]:
    """The global batch's scalar terms from each rank's: every loss and
    metric term is a mean over equal slices, so their mean over the data
    ranks (f32); ``fg_lost_voxels``, a largest count, their max."""
    import torch.distributed as dist

    keys = [k for k in terms if k != "fg_lost_voxels"]
    means = torch.stack([terms[k].float() for k in keys])
    dist.all_reduce(means, group=shard.group)
    out = dict(zip(keys, means / shard.size))
    if "fg_lost_voxels" in terms:
        worst = terms["fg_lost_voxels"].clone()
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=shard.group)
        out["fg_lost_voxels"] = worst
    return out


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


def kernel_leaf(p, name: str) -> bool:
    """Whether :class:`Optimizer` updates leaf ``p`` (one with a grad)
    through the multi-tensor kernel: under ``adam`` or ``adamw``, an f32
    leaf off the CPU. The CPU (the path held against optax), bf16 and f16
    leaves with their weak-type roundings, ``rmsprop`` and ``sgd`` take
    the per-leaf :meth:`Optimizer._update`."""
    return (name in ("adam", "adamw") and not p.is_cpu
            and p.dtype == torch.float32)


class Optimizer(torch.optim.Optimizer):
    """The update of ``ctunet_tpu.steps.make_optimizer``, transform by
    transform as optax (0.2.6) computes it, in place on the parameters.

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

    A parameter held in bf16 or f16 (``param_dtype``) keeps its moments in
    its dtype (optax's ``zeros_like(params)``) and is updated in it with
    JAX's promotions: each Python constant (the decays, ``eps``, the
    learning rate) is rounded to the parameter's dtype first, as a weak
    type is; each bias correction is computed in f32 and then rounded to
    it (``optax.tree.bias_correction``); the plateau's f32 scale promotes
    the update to f32, added to the parameter in f32 and rounded back
    (``optax.apply_updates``). Small updates then round away, as in JAX.

    Count, plateau state and hyper-parameters live in the param group, the
    moments in ``state``, so ``state_dict()`` carries all of them.

    Executor: under ``adam`` and ``adamw`` the f32 leaves on the card
    (:func:`kernel_leaf`) are updated together by one multi-tensor kernel
    (``ops/kernels/adam.py``), with the same f32 arithmetic bit for bit and
    the moments in place; every other leaf by :meth:`_update`, one at a
    time. Each step counts its leaves of each kind
    (``ctunet.train.optimizer.fused_leaves`` and ``.plain_leaves``).
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
        fused = plain = 0
        for group in self.param_groups:
            group["count"] += 1
            n, name = group["count"], group["name"]
            scale = 1.0
            if group["plateau"] is not None:
                if value is None:
                    raise ValueError("the plateau scheduler needs "
                                     "step(value=loss)")
                scale = self._plateau_scale(group["plateau"], float(value))
            leaves = []
            for p in group["params"]:
                if p.grad is None:
                    continue
                if kernel_leaf(p, name):
                    leaves.append(p)
                else:
                    self._update(p, group, n, name, scale)
                    plain += 1
            if leaves:
                self._update_leaves(leaves, group, n, name, scale)
                fused += len(leaves)
        count("ctunet.train.optimizer.fused_leaves", fused)
        count("ctunet.train.optimizer.plain_leaves", plain)

    def _update_leaves(self, leaves, group, n: int, name: str,
                       scale: float) -> None:
        """:meth:`_update` of the f32 ``adam`` / ``adamw`` leaves on the
        card, all in one multi-tensor kernel, the moments in place."""
        states = []
        for p in leaves:
            st = self.state[p]
            if not st:
                st.update(mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                          nu_max=torch.zeros_like(p))
            states.append(st)
        b1, b2 = group["b1"], group["b2"]
        k = adam_kernel.constants(
            name, group["lr"], b1, b2, group["eps"], group["weight_decay"],
            _bias_correction(b1, n), _bias_correction(b2, n), scale)
        adam_kernel.adam_mt(leaves, [p.grad for p in leaves],
                            [st["mu"] for st in states],
                            [st["nu"] for st in states],
                            [st["nu_max"] for st in states], k)

    def _update(self, p, group, n: int, name: str, scale: float) -> None:
        if p.dtype == torch.float32:
            def c(v):  # an f32 operation rounds a Python float to f32
                return v
        else:
            def c(v):  # a weak-typed constant, rounded to p's dtype
                return torch.tensor(v, dtype=p.dtype)
        lr, wd, mom = group["lr"], group["weight_decay"], group["momentum"]
        g = p.grad
        st = self.state[p]
        if wd and name != "adamw":
            g = g + c(wd) * p
        if name in ("adam", "adamw"):
            if not st:
                st.update(mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                          nu_max=torch.zeros_like(p))
            b1, b2 = group["b1"], group["b2"]
            st["mu"] = c(1 - b1) * g + c(b1) * st["mu"]
            st["nu"] = c(1 - b2) * (g * g) + c(b2) * st["nu"]
            mu_hat = st["mu"] / c(_bias_correction(b1, n))
            nu_hat = st["nu"] / c(_bias_correction(b2, n))
            st["nu_max"] = torch.maximum(st["nu_max"], nu_hat)
            u = mu_hat / (torch.sqrt(st["nu_max"]) + c(group["eps"]))
            if name == "adamw":
                u = u + c(wd) * p
            u = c(-lr) * u
        elif name == "rmsprop":
            if not st:
                st.update(nu=torch.zeros_like(p), trace=torch.zeros_like(p))
            d = group["rms_decay"]
            st["nu"] = c(1 - d) * (g * g) + c(d) * st["nu"]
            u = c(-lr) * (torch.rsqrt(st["nu"] + c(group["eps"])) * g)
            st["trace"] = u + c(mom) * st["trace"]
            u = st["trace"]
        else:  # sgd
            if mom:
                if not st:
                    st.update(trace=torch.zeros_like(p))
                st["trace"] = g + c(mom) * st["trace"]
                g = st["trace"]
            u = c(-lr) * g
        if scale == 1.0:
            p.add_(u)
        elif p.dtype == torch.float32:
            p.add_(scale * u)
        else:  # the f32 scale promotes the update; one rounding back
            p.copy_(p.float() + scale * u.float())


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
