"""Training conv on the Hopper conv kernels K6 (k=3) and K5 (k=5): forward
and input gradient are kernel launches, the weight gradient is k^3
tap-shifted contractions.

Counterpart of ``ctunet_tpu/ops/chain_conv_train.py::conv3d_chain_train``
(``conv_impl = "chain"``, k=3) and of ``ops/packed_conv.py::conv3d_pallas``
(``conv_impl = "pallas"``, k=3 and k=5, ``packed_conv.py:122-212``: the same
function on another TPU kernel):

- **forward**: ``ops.kernels.conv3d.conv3d_bias_act`` (k=3) or
  ``conv3d5_bias_act`` (k=5) per sample with a zero bias and no ReLU
  (bias, BatchNorm and ReLU stay outside);
- **dL/dx**: for a SAME stride-1 conv, ``dx = conv(g, flip(W).swap(i, o))``,
  the same kernel on ``g``; skipped when the input needs no gradient (the
  network input);
- **dL/dW**: ``dw[a,b,c] = x_shifted(a,b,c)^T @ g`` over all voxels, outside
  any kernel as in the JAX package (``chain_conv_train.py:120-155``,
  ``packed_conv.py:184-209``). ``x`` and ``g`` are each zero-padded once by
  ``k // 2`` in H and W and flattened; a tap is then a contiguous slice of
  the flat ``x`` at a constant offset, and the zeros of the padded ``g``
  cancel every read that wraps around a row. No per-tap copy and no f32
  copy of the operands is made. The contraction is one batched matmul per
  tap with one depth plane per batch entry in the operands' dtype (f32
  accumulation inside the matmul), and the per-plane partial sums are
  added in f32.

``dx`` is cast to ``x.dtype`` and ``dw`` to ``kernel.dtype``
(``chain_conv_train.py:181``). The TPU gates of the JAX modules (pack, the
512-lane limit, the XLA fallback of shapes too small for the TPU tiling)
do not exist here: every k=3 or k=5 SAME stride-1 conv takes this path,
and nothing falls back to a library convolution.

On CPU tensors the kernel wrappers run their plain versions; ``plain=True``
asks for the plain versions on any device (the reference run that the chip
check holds the kernel path against).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import conv3d as kc
from .kernels.build import traced


def flip_swap(kernel: torch.Tensor) -> torch.Tensor:
    """``(k,k,k,Ci,Co)`` -> spatially flipped, channels swapped
    ``(k,k,k,Co,Ci)``: the weights of the input gradient
    (``packed_conv.py:162-164``)."""
    return kernel.flip(0, 1, 2).transpose(3, 4).contiguous()


# The padded copies of dw_taps round their channel counts up to this many,
# so that a bf16 voxel's channels fill whole 16-byte words and every tap's
# slice starts on one (what the library's tensor-core matmuls load).
CHANNEL_ALIGN = 8


@traced
def dw_taps(x: torch.Tensor, g: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Weight gradient of one sample of a SAME k-conv: ``x`` ``(D,H,W,Ci)``,
    ``g`` ``(D,H,W,Co)`` -> f32 ``(k,k,k,Ci,Co)``. A profiler span named
    ``dw_taps`` holds its ``bmm``s (``utils/profiling.py``)."""
    d, h, w, ci = x.shape
    co = g.shape[-1]
    half = k // 2
    pi, po = -ci % CHANNEL_ALIGN, -co % CHANNEL_ALIGN
    row = w + 2 * half
    plane = (h + 2 * half) * row
    # 2 * half planes of depth padding keep every tap's slice inside the
    # buffer
    xp = F.pad(x, (0, pi, half, half, half, half, 2 * half, 2 * half)
               ).reshape(-1, ci + pi)
    gp = F.pad(g, (0, po, half, half, half, half)).reshape(d, plane, co + po)
    taps = []
    for a in range(k):
        for b in range(k):
            for c in range(k):
                off = (a + half) * plane + (b - half) * row + (c - half)
                xs = xp[off: off + d * plane].view(d, plane, ci + pi)
                part = torch.bmm(xs.transpose(1, 2), gp)  # (D, Ci, Co)
                taps.append(part.float().sum(0))
    return torch.stack(taps)[:, :ci, :co].reshape(k, k, k, ci, co)


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
            k = kernel.shape[0]
            dw = sum(dw_taps(x[i], g[i], k) for i in range(x.shape[0]))
            dw = dw.to(kernel.dtype)
        return dx, dw, None


def _conv_batch(x: torch.Tensor, kernel: torch.Tensor, plain: bool):
    if kernel.shape[0] == 5:
        conv = kc.conv3d5_bias_act_plain if plain else kc.conv3d5_bias_act
    else:
        conv = kc.conv3d_bias_act_plain if plain else kc.conv3d_bias_act
    zero = torch.zeros(kernel.shape[-1], dtype=torch.float32, device=x.device)
    outs = [conv(x[i], kernel, zero, False) for i in range(x.shape[0])]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def conv3d_chain_train(x: torch.Tensor, kernel: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
    """SAME stride-1 conv of ``x`` ``(B,D,H,W,Ci)`` with the raw
    ``kernel`` ``(k,k,k,Ci,Co)``, k 3 or 5, of the same dtype ->
    ``(B,D,H,W,Co)``, differentiable in both."""
    k = kernel.shape[0]
    if (k not in (3, 5) or tuple(kernel.shape[:3]) != (k, k, k)
            or kernel.shape[3] != x.shape[-1]):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit input "
                         f"{tuple(x.shape)} (3x3x3 or 5x5x5 kernels only)")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel {kernel.dtype} and input {x.dtype} differ")
    return _Conv3dChainTrain.apply(x, kernel, plain)
