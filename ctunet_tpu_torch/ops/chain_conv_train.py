"""Training conv on the Hopper conv kernel K6: forward and input gradient
are kernel launches, the weight gradient is 27 tap-shifted contractions.

Counterpart of ``ctunet_tpu/ops/chain_conv_train.py::conv3d_chain_train``
(``conv_impl = "chain"``) and of ``ops/packed_conv.py::conv3d_pallas``
(``conv_impl = "pallas"``, the same function on another TPU kernel):

- **forward**: ``ops.kernels.conv3d.conv3d_bias_act`` per sample with a zero
  bias and no ReLU (BatchNorm and ReLU stay outside);
- **dL/dx**: for a SAME stride-1 conv, ``dx = conv(g, flip(W).swap(i, o))``,
  the same kernel on ``g``; skipped when the input needs no gradient (the
  network input);
- **dL/dW**: ``dw[a,b,c] = x_shifted(a,b,c)^T @ g`` over all voxels, outside
  any kernel as in the JAX package (``chain_conv_train.py:120-155``). ``x``
  and ``g`` are each zero-padded once in H and W and flattened; a tap is
  then a contiguous slice of the flat ``x`` at a constant offset, and the
  zeros of the padded ``g`` cancel every read that wraps around a row. No
  per-tap copy and no f32 copy of the operands is made. The contraction is
  one batched matmul per tap with one depth plane per batch entry in the
  operands' dtype (f32 accumulation inside the matmul), and the per-plane
  partial sums are added in f32.

``dx`` is cast to ``x.dtype`` and ``dw`` to ``kernel.dtype``
(``chain_conv_train.py:181``). The TPU gate of the JAX module (pack, the
512-lane limit) does not exist here: every k=3 SAME stride-1 conv takes
this path, and nothing falls back to a library convolution.

On CPU tensors the kernel wrapper runs its plain version; ``plain=True``
asks for the plain version on any device (the reference run that the chip
check holds the kernel path against).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import conv3d as kc


def flip_swap(kernel: torch.Tensor) -> torch.Tensor:
    """``(3,3,3,Ci,Co)`` -> spatially flipped, channels swapped
    ``(3,3,3,Co,Ci)``: the weights of the input gradient
    (``packed_conv.py:162-164``)."""
    return kernel.flip(0, 1, 2).transpose(3, 4).contiguous()


# The padded copies of dw_taps round their channel counts up to this many,
# so that a bf16 voxel's channels fill whole 16-byte words and every tap's
# slice starts on one (what the library's tensor-core matmuls load).
CHANNEL_ALIGN = 8


def dw_taps(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of one sample: ``x`` ``(D,H,W,Ci)``, ``g``
    ``(D,H,W,Co)`` -> f32 ``(3,3,3,Ci,Co)``."""
    d, h, w, ci = x.shape
    co = g.shape[-1]
    pi, po = -ci % CHANNEL_ALIGN, -co % CHANNEL_ALIGN
    plane = (h + 2) * (w + 2)
    # two planes of depth padding keep every tap's slice inside the buffer
    xp = F.pad(x, (0, pi, 1, 1, 1, 1, 2, 2)).reshape(-1, ci + pi)
    gp = F.pad(g, (0, po, 1, 1, 1, 1)).reshape(d, plane, co + po)
    taps = []
    for a in range(3):
        for b in range(3):
            for c in range(3):
                off = (a + 1) * plane + (b - 1) * (w + 2) + (c - 1)
                xs = xp[off: off + d * plane].view(d, plane, ci + pi)
                part = torch.bmm(xs.transpose(1, 2), gp)  # (D, Ci, Co)
                taps.append(part.float().sum(0))
    return torch.stack(taps)[:, :ci, :co].reshape(3, 3, 3, ci, co)


class _Conv3dChainTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, plain):
        x = x.contiguous()
        kernel = kernel.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.plain = plain
        return _conv_batch(x, kernel, plain)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_batch(g, flip_swap(kernel).to(g.dtype), ctx.plain
                             ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = sum(dw_taps(x[i], g[i]) for i in range(x.shape[0]))
            dw = dw.to(kernel.dtype)
        return dx, dw, None


def _conv_batch(x: torch.Tensor, kernel: torch.Tensor, plain: bool):
    conv = kc.conv3d_bias_act_plain if plain else kc.conv3d_bias_act
    zero = torch.zeros(kernel.shape[-1], dtype=torch.float32, device=x.device)
    outs = [conv(x[i], kernel, zero, False) for i in range(x.shape[0])]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def conv3d_chain_train(x: torch.Tensor, kernel: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
    """SAME stride-1 k3 conv of ``x`` ``(B,D,H,W,Ci)`` with the raw
    ``kernel`` ``(3,3,3,Ci,Co)`` of the same dtype -> ``(B,D,H,W,Co)``,
    differentiable in both."""
    if tuple(kernel.shape[:3]) != (3, 3, 3) or kernel.shape[3] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit input "
                         f"{tuple(x.shape)} (3x3x3 kernels only)")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel {kernel.dtype} and input {x.dtype} differ")
    return _Conv3dChainTrain.apply(x, kernel, plain)
