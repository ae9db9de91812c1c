"""Generic 3D U-Net family as PyTorch ``nn.Module``s, eval and train mode.

Counterpart of ``ctunet_tpu/models/unet.py``. In eval mode with the default
settings (f32, ``conv_impl = "xla"``) it is the numerical reference of the
port: the serving engines (``engine.py``, ``engine_q.py``) are held against
this forward. In train mode it is the graph the trainer differentiates. It
reproduces the effective graph of the reference model zoo
(``ctunet/pytorch/models.py:158-261``):

- quirk Q1: with ``fc_layer=None`` (every shipped variant) the reference
  computes the center block and then discards it (``models.py:241``), so the
  decoder consumes the last pooled feature map directly. No center block is
  built here; the dead ``cblock.*`` keys of a reference checkpoint are
  dropped on load (``checkpoint.py``);
- decoder widths follow ``unet.py:599-634``: block ``u{idx}`` upsamples its
  whole input with a ConvTranspose(k2, s2) of the same width, then two conv
  units to ``i_size * 2**i`` channels; its output is concatenated with the
  encoder skip ``d[i]`` for the next block;
- the final skip concat is never built: ``last_conv`` is one
  ``Conv3d(2*i_size, out, 1)`` in the reference, applied here weight-split
  over the pair (``unet.py:619-639``).

Submodule names and parameter shapes are the reference's state_dict
(``d_blocks.{i}.block``, ``u_blocks.{j}.block``, ``last_conv``; conv weights
``(O, I, 3, 3, 3)``), so a reference ``.pt`` loads with ``load_state_dict``.
Unlike the reference the modules run channels-last, ``(B, D, H, W, C)`` in,
inside and out, like ``ctunet_tpu``: that is the layout of the port's
kernels, so no transpose stands between two layers.

``UNet.configure(conv_impl, compute_dtype)`` selects how the k=3 convs run
and where the compute dtype rounds (``unet.py:124-129``): parameters are
held in ``param_dtype`` (f32 unless ``models.build_model`` is given
another) and cast per call, so their gradients come back in it; the
BatchNorm scale, shift and statistics are f32. There is no autocast.
``conv_impl``:

=========  ============================================================
``chain``  K6 forward/dgrad + tap-dot wgrad (``ops/chain_conv_train.py``)
``pallas`` the same function: on the TPU another kernel (K5) computed it
``xla``    ``F.conv3d`` (cuDNN on the card), the default
``xla_dw`` ``xla``: a TPU wgrad formulation with the same values
``plain``  ``chain`` on the kernel's plain version, on any device
=========  ============================================================
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chain_conv_train import conv3d_chain_train
from ..parallel.distributed import all_reduce_mean

CONV_IMPLS = ("xla", "xla_dw", "pallas", "chain", "plain")


class Conv3d(nn.Conv3d):
    """Conv3d(k3 or k5, SAME, stride 1) on channels-last tensors, computed
    by ``conv_impl`` in ``compute_dtype``, the bias (the legacy family's)
    added after the conv (``PackedConv``, ``unet.py:92-136``). ``chain``
    takes the hand conv at k=3 and ``F.conv3d`` at k=5, as the JAX
    package's ``chain`` takes the XLA conv there
    (``ctunet_tpu/ops/chain_conv_train.py:72-73``)."""

    conv_impl = "xla"
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        w = self.weight.to(self.compute_dtype)
        k = w.shape[-1]
        if self.conv_impl in ("pallas", "plain") or (
                self.conv_impl == "chain" and k == 3):
            y = conv3d_chain_train(x, w.permute(2, 3, 4, 1, 0),
                                   plain=self.conv_impl == "plain")
        else:
            # NCDHW view of the channels-last tensor (channels_last_3d
            # strides: no copy), and back
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=k // 2)
            y = y.permute(0, 2, 3, 4, 1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm over the trailing channel axis with flax's semantics
    (``unet.py:42-89``): f32 statistics, ``var = E[x^2] - E[x]^2`` (biased),
    running update ``0.9 * old + 0.1 * new`` with the biased variance
    (``nn.BatchNorm3d`` would store the unbiased one), and the
    normalization ``x * inv + shift`` in the activation's dtype. Buffers
    and parameters are ``nn.BatchNorm3d``'s, so state_dicts interchange.

    ``data_group``: ``(process group, size)`` of the data ranks of a
    multi-process run (:func:`sync_batch_stats`), or None. With it, the
    train-mode mean and ``E[x^2]`` are averaged over the ranks by a
    differentiable all-reduce: the statistics of the global batch, as XLA
    SPMD computes them over a batch sharded on the JAX mesh's data axis
    (``torch.nn.SyncBatchNorm`` would keep the unbiased running variance and
    refuses CPU tensors)."""

    data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            if self.data_group is None:
                var = (xf * xf).mean(axes) - mean * mean
            else:
                stats = all_reduce_mean(torch.stack([mean, (xf * xf).mean(
                    axes)]), *self.data_group)
                mean = stats[0]
                var = stats[1] - mean * mean
            with torch.no_grad():
                m = 1.0 - self.momentum  # torch's momentum weighs the new
                self.running_mean.mul_(m).add_(self.momentum * mean)
                self.running_var.mul_(m).add_(self.momentum * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)


def sync_batch_stats(model: nn.Module, group=None, size: int = 1) -> None:
    """Average every :class:`BatchNorm`'s train-mode statistics of
    ``model`` over the ``size`` ranks of ``group`` (``size`` 1: each
    process its own batch, the single-process behaviour)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = (group, size) if size > 1 else None


class ConvTranspose2x(nn.ConvTranspose3d):
    """ConvTranspose3d(k2, s2, bias) on channels-last tensors as one matmul
    and a depth-to-space reshape (``_ConvT2x2``, ``unet.py:176-214``):
    ``out[2z+a, 2y+b, 2x+c, o] = sum_i x[z,y,x,i] W[i,o,a,b,c] + bias[o]``.
    """

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.to(self.compute_dtype)
        y = torch.einsum("nzyxi,ioabc->nzaybxco", x.to(self.compute_dtype), k)
        n, d, _, h, _, w, _, co = y.shape
        y = y.reshape(n, 2 * d, 2 * h, 2 * w, co)
        return y + self.bias.to(y.dtype)


def _repeat2(t: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of ``(B, D, H, W, C)``."""
    b, d, h, w, c = t.shape
    t = t[:, :, None, :, None, :, None, :].expand(b, d, 2, h, 2, w, 2, c)
    return t.reshape(b, 2 * d, 2 * h, 2 * w, c)


class _MaxPool2(torch.autograd.Function):
    """2x2x2 max pool whose backward splits the gradient evenly among the
    elements that tie for the maximum (``_maxpool2_bwd``,
    ``unet.py:469-507``, the non-packed branch; the packed one is a TPU
    layout of the same function). Binary skulls tie almost everywhere;
    ``F.max_pool3d`` would route the whole gradient to the first."""

    @staticmethod
    def forward(ctx, x):
        b, d, h, w, c = x.shape
        y = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).amax((2, 4, 6))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        b, d, h, w, c = x.shape
        eq = (x == _repeat2(y)).float()
        ties = eq.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).sum((2, 4, 6))
        return (eq * _repeat2(g.float() / ties)).to(x.dtype)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(kernel 2, stride 2) on ``(B, D, H, W, C)``; odd extents
    floor (``_maxpool``, ``unet.py:513-528``)."""
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        x = x[:, : d - d % 2, : h - h % 2, : w - w % 2]
    return _MaxPool2.apply(x.contiguous())


def _conv_unit(cin: int, cout: int):
    """Conv3d(k3, SAME, no bias) + BatchNorm + ReLU (``models.py:9-49``)."""
    return [Conv3d(cin, cout, 3, padding=1, bias=False),
            BatchNorm(cout, eps=1e-5, momentum=0.1), nn.ReLU()]


class UNetBlock(nn.Module):
    """Two conv units; an up block prepends ConvTranspose3d(k2, s2, bias).

    ``block`` indices match the reference: down ``0,1,2,3,4,5`` =
    (conv, bn, relu) x 2; up ``0`` = convT, then (conv, bn, relu) x 2 at
    ``1..6``. ``dropout_p > 0`` drops whole channels in train mode
    (``unet.py:274-280``, torch ``Dropout3d``).
    """

    def __init__(self, cin: int, cout: int, up_block: bool = False,
                 dropout_p: float = 0.0):
        super().__init__()
        layers = _conv_unit(cin, cout) + _conv_unit(cout, cout)
        if up_block:
            layers.insert(0, ConvTranspose2x(cin, cin, 2, stride=2))
        self.block = nn.Sequential(*layers)
        self.dropout_p = float(dropout_p)

    def forward(self, x):
        x = self.block(x)
        if self.dropout_p > 0 and self.training:
            keep = torch.rand(x.shape[0], 1, 1, 1, x.shape[-1],
                              device=x.device) >= self.dropout_p
            x = x * (keep.to(x.dtype) / (1.0 - self.dropout_p))
        return x


class UNet(nn.Module):
    """Generic U-Net (``models.py:158-261``), concat skips, sigmoid head."""

    def __init__(self, input_channels: int = 1, out_channels: int = 2,
                 n_blocks: int = 4, i_size: int = 8, dropout_p: float = 0.0):
        super().__init__()
        self.n_blocks = n_blocks
        self.compute_dtype = torch.float32
        widths = [i_size * 2 ** i for i in range(n_blocks)]
        self.d_blocks = nn.ModuleList()
        cin = input_channels
        for w in widths:
            self.d_blocks.append(UNetBlock(cin, w, dropout_p=dropout_p))
            cin = w
        self.u_blocks = nn.ModuleList()
        for idx in range(n_blocks):
            i = n_blocks - 1 - idx
            self.u_blocks.append(UNetBlock(cin, widths[i], up_block=True,
                                           dropout_p=dropout_p))
            cin = 2 * widths[i]
        self.last_conv = nn.Conv3d(cin, out_channels, 1)

    def configure(self, conv_impl: str = "xla",
                  compute_dtype: torch.dtype = torch.float32) -> "UNet":
        """Select the conv implementation and the compute dtype of every
        layer (the trainer's ``conv_impl`` and ``compute_dtype`` keys)."""
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r}: one of {CONV_IMPLS}")
        self.compute_dtype = compute_dtype
        for m in self.modules():
            if isinstance(m, Conv3d):
                m.conv_impl, m.compute_dtype = conv_impl, compute_dtype
            elif isinstance(m, ConvTranspose2x):
                m.compute_dtype = compute_dtype
        return self

    def forward_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> pre-sigmoid (B, D, H, W, out_channels)."""
        h = x
        skips = []
        for blk in self.d_blocks:
            h = blk(h)
            skips.append(h)
            h = maxpool2(h)
        for idx, blk in enumerate(self.u_blocks):
            u = blk(h)
            skip = skips[self.n_blocks - 1 - idx]
            h = torch.cat([u, skip], -1) if idx < self.n_blocks - 1 else None
        # weight-split 1x1 head over (last decoder output, first skip)
        dt = self.compute_dtype
        ca = u.shape[-1]
        k = self.last_conv.weight[:, :, 0, 0, 0].t().to(dt)  # (Ca+Cb, out)
        return (u.to(dt) @ k[:ca] + skip.to(dt) @ k[ca:]
                + self.last_conv.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.forward_logits(x))
