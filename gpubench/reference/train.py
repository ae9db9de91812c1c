"""Plain PyTorch float32 reference of one training step of the
double-output flap problem: the virtual craniectomy that makes a training
pair from a complete skull, the U-Net of :mod:`unet` in training mode, the
losses and the optimizer update.

- Synthesis (``ctunet``'s ``SkullRandomHole`` then ``SaltAndPepper``):
  a nonzero voxel drawn uniformly (one 32-bit score per voxel, the largest
  nonzero one wins), a size in ``[min(shape) // 5 - 1, max(shape) // 3.5)``,
  a shape (sphere, box, or a cube with two cylinders) cut out of the
  binary skull, which gives the broken skull and the flap; then, with
  probability 0.5, salt and pepper at a density drawn in ``[0, 0.05)``.
  The draws are made from the ``torch.Generator`` the caller hands in, in
  the order, shapes and dtypes that the package under test draws them, so
  that one seed gives both sides the same holes and noise.
- Losses, as the original trainer composes them (its quirk kept: the
  cross entropy takes the heads' outputs as logits): per head, the mean
  softmax cross entropy against the target's class, and the
  squared-denominator Dice loss of the softmaxed head against the one-hot
  target (eps 1e-7), all weighted 1.
- Optimizer: Adam in its AMSGrad form as optax computes it: the running
  maximum is taken of the bias-corrected second moment.
- BatchNorm's running statistics: after each step ``(1 - m) * running +
  m * batch`` with ``m`` = 0.1 (the published model's momentum), the
  batch's variance biased as the model normalises with it.

``q``: the operand rounding of :func:`unet.forward` (a control).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import unet

Tensor = torch.Tensor
DICE_EPS = 1e-7
BN_MOMENTUM = 0.1


def _grid(shape, device):
    d, h, w = shape
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device)  # noqa: E731
    return ar(d)[:, None, None], ar(h)[None, :, None], ar(w)[None, None, :]


def hole_keep(shape, center: Tensor, size: Tensor, c_diam: Tensor,
              p_type: Tensor, device) -> Tensor:
    """1 outside the drawn shape, 0 inside: a sphere (type 0, L2 distance
    <= size), a box (type 1, Chebyshev distance <= size) or a flap
    (type 2: a cube of side ``size`` with two cylinders of radius
    ``c_diam`` and axis z at its two x-extremes, offset ``-size / 2`` in
    y, on coordinates scaled by ``(n - 1) / n``)."""
    zz, yy, xx = _grid(shape, device)
    dz, dy, dx = zz - center[0], yy - center[1], xx - center[2]
    sphere = dz * dz + dy * dy + dx * dx <= size * size
    box = torch.maximum(torch.maximum(dz.abs(), dy.abs()), dx.abs()) <= size
    dims = torch.tensor(shape, dtype=torch.float32, device=device)
    sc = (dims - 1.0) / dims
    cz, cy, cx = center[0] * sc[0], center[1] * sc[1], center[2] * sc[2]
    half = size / 2.0
    in_z = (zz - cz).abs() <= half
    cube = in_z & ((yy - cy).abs() <= half) & ((xx - cx).abs() <= half)
    ey = (center[1] - half) * sc[1]
    ex1, ex2 = (center[2] - half) * sc[2], (center[2] + half) * sc[2]
    r2 = c_diam * c_diam
    cyl1 = in_z & ((yy - ey) ** 2 + (xx - ex1) ** 2 <= r2)
    cyl2 = in_z & ((yy - ey) ** 2 + (xx - ex2) ** 2 <= r2)
    flap = cube | cyl1 | cyl2
    inside = torch.where(p_type == 0, sphere,
                         torch.where(p_type == 1, box, flap))
    return 1.0 - inside.float()


def synthesize(gen: torch.Generator, volume: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """``(broken skull with noise, full skull, flap)`` of one complete
    skull ``(D, H, W)``, all f32 on its device."""
    dev, shape = volume.device, tuple(volume.shape)
    full = (volume > 0).float()
    scores = torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                           dtype=torch.int64)
    nz = full > 0
    idx = torch.argmax(torch.where(nz, scores, torch.zeros_like(scores))
                       .reshape(-1))
    _, h, w = shape
    center = torch.stack([idx // (h * w), (idx // w) % h, idx % w]).float()
    min_r = min(shape) // 5 - 1
    max_r = int(max(min_r, max(shape) // 3.5))
    size = torch.randint(min_r, max(max_r, min_r + 1), (), generator=gen,
                         device=dev).float()
    u = torch.rand(3, generator=gen, device=dev)
    p_type = torch.clamp((u[0] * 3).long(), max=2)
    c_diam = (0.25 + 0.75 * u[1]) * size / 4.0
    cut = (u[2] <= 1.0) & nz.any()
    keep = hole_keep(shape, center, size, c_diam, p_type, dev)
    keep = torch.where(cut, keep, torch.ones_like(keep))
    broken, flap = full * keep, full * (1.0 - keep)
    # salt and pepper: applied with probability 0.5, density in [0, 0.05),
    # a tenth of it salt; two 16-bit uniforms a voxel from one 32-bit draw
    u = torch.rand(2, generator=gen, device=dev)
    bits = torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                         dtype=torch.int64)
    density = u[0] * 0.05
    u_black = (bits & 0xFFFF).float() / 65536.0
    u_white = (bits >> 16).float() / 65536.0
    black = (u_black > density * 0.9).float()
    white = 1.0 - (u_white > density * 0.1).float()
    noisy = torch.maximum(broken * black, white)
    broken = torch.where(u[1] <= 0.5, noisy, broken)
    return broken, full, flap


def dice_loss(probs: Tensor, onehot: Tensor) -> Tensor:
    b = probs.shape[0]
    p, m = probs.reshape(b, -1), onehot.reshape(b, -1)
    num = (p * m).sum(1)
    den = (p * p).sum(1) + (m * m).sum(1)
    return 1.0 - 2.0 * ((num + DICE_EPS) / (den + DICE_EPS)).mean()


def losses(full_p: Tensor, flap_p: Tensor, full_t: Tensor,
           flap_t: Tensor) -> Tensor:
    """The summed loss of both heads against the binary targets
    ``(B, D, H, W)``."""
    total = 0.0
    for pred, tgt in ((full_p, full_t), (flap_p, flap_t)):
        onehot = F.one_hot(tgt.long(), 2).float()
        ce = -torch.gather(F.log_softmax(pred, -1), -1,
                           tgt.long()[..., None]).mean()
        total = total + ce + dice_loss(torch.softmax(pred, -1), onehot)
    return total


class Adam:
    """optax's AMSGrad over a dict of f32 leaves, updated in place."""

    def __init__(self, params: Dict[str, Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.n = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]):
        self.n += 1
        c1, c2 = 1.0 - self.b1 ** self.n, 1.0 - self.b2 ** self.n
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / c2)
            params[k] -= self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu_max[k]) + self.eps)


def run_steps(params: Dict[str, Tensor], atlas: Tensor, volumes: List[Tensor],
              gen: torch.Generator, n_blocks: int, head: str, lr: float,
              q: Callable = unet._same,
              stats: Optional[Dict[str, Tensor]] = None):
    """Train ``params`` (a dict of f32 leaves, updated in place) for one
    step on each ``(D, H, W)`` complete skull of ``volumes`` at batch 1,
    and the running statistics ``stats`` (``<unit>/bn/mean`` and
    ``/var``, updated in place) where given.
    Returns ``(losses, first_grads)``: each step's loss and the first
    step's gradient of every leaf."""
    opt = Adam(params, lr)
    out_losses, first = [], None
    for vol in volumes:
        with torch.no_grad():
            broken, full, flap = synthesize(gen, vol)
            x = torch.stack([broken, atlas], -1)[None]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        seen: Dict[str, tuple] = {}
        full_p, flap_p = unet.forward(leaves, None, x, n_blocks, head, q,
                                      seen)
        if stats is not None:
            with torch.no_grad():
                for name, (mean, var) in seen.items():
                    for key, new in (("mean", mean), ("var", var)):
                        old = stats[f"{name}/bn/{key}"]
                        stats[f"{name}/bn/{key}"] = (
                            (1.0 - BN_MOMENTUM) * old + BN_MOMENTUM * new)
        loss = losses(full_p, flap_p, full[None], flap[None])
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        del full_p, flap_p, x
        out_losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
    return out_losses, first
