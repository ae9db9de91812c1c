"""K1 (Conv3D k3 + folded BN + ReLU) and K2 (2x2x2 max pool) for Hopper.

Counterpart of ``ctunet_tpu/ops/pallas/conv3d.py``: ``conv3d_chain_split``
and ``maxpool2_chain``, the two conv-module kernels of the bf16 serving
path. The CUDA sources are ``csrc/conv3d.cu`` and ``csrc/maxpool.cu``; the
TPU chain layout (W packed into lanes, halo rows, ones-channel) is not
carried over: both functions take and return dense channels-last volumes.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU. ``<wrapper>.launches``
counts kernel launches, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into a per-channel (scale, bias), in f32
    (``conv3d.py:97-103``)."""
    inv = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    return inv, bn_bias.float() - bn_mean.float() * inv


def fold_conv_unit(conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var,
                   dtype=torch.bfloat16):
    """Conv3d(k3) + BatchNorm3d weights -> the kernel's operands.

    ``conv_w`` is torch ``(O, I, 3, 3, 3)``. Returns ``(w, bias)`` with
    ``w = conv_w * scale`` folded in f32 and then cast to ``dtype``, laid
    out tap-major ``(3, 3, 3, I, O)``, and ``bias`` f32 ``(O,)`` — the
    rounding of the JAX engine (``engine.py:77-86``, ``conv3d.py:815-816,
    1124``: bf16 weights, f32 bias added to the f32 accumulator).
    """
    inv, bn_bias = fold_bn(bn_w, bn_b, bn_mean, bn_var)
    w = conv_w.float().permute(2, 3, 4, 1, 0) * inv
    cb = (torch.zeros_like(inv) if conv_b is None else conv_b.float())
    return w.to(dtype).contiguous(), (cb * inv + bn_bias).contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on cpu or cuda, "
                         f"got {x.device}")


# --------------------------------------------------------------------------
# K1: Conv3D(k3, SAME) + folded BN + ReLU
# --------------------------------------------------------------------------


def conv3d_bn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: ``F.conv3d`` in f32 on the (already rounded)
    inputs, + bias, ReLU, cast back to ``x.dtype``.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(3, 3, 3, Ci, Co)``; ``bias``:
        ``(Co,)`` f32.
    """
    xf = x.float().permute(3, 0, 1, 2)[None]
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=1)[0].permute(1, 2, 3, 0)
    return torch.relu(y + bias.float()).to(x.dtype)


def conv3d_bn_relu(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """K1 on ``x`` ``(D, H, W, Ci)`` with folded ``w`` ``(3, 3, 3, Ci, Co)``
    and f32 ``bias`` ``(Co,)`` -> ``(D, H, W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d.cu``
    kernel (bf16 only) on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_bn_relu_plain(x, w, bias)
    _require_cuda(x, "conv3d_bn_relu")
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    _check(x, "x", torch.bfloat16)
    _check(w, "w", torch.bfloat16, (3, 3, 3, ci, co), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    out = torch.empty((d, h, wd, co), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("conv3d", "ctunet_conv3d_bn_relu",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, *build.stream_args(x))
    build.check(rc, "conv3d_bn_relu")
    conv3d_bn_relu.launches += 1
    return out


conv3d_bn_relu.launches = 0


# --------------------------------------------------------------------------
# K2: MaxPool 2x2x2, stride 2
# --------------------------------------------------------------------------


def maxpool2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: ``F.max_pool3d(kernel 2, stride 2)`` on
    ``(D, H, W, C)`` (odd extents floor)."""
    y = F.max_pool3d(x.permute(3, 0, 1, 2)[None], 2)
    return y[0].permute(1, 2, 3, 0).contiguous()


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """K2 on ``(D, H, W, C)`` -> ``(D//2, H//2, W//2, C)``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/maxpool.cu``
    kernel (bf16 only) on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    _require_cuda(x, "maxpool2")
    d, h, w, c = x.shape
    _check(x, "x", torch.bfloat16)
    out = torch.empty((d // 2, h // 2, w // 2, c), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("maxpool", "ctunet_maxpool2",
                        [_P, _P, _I, _I, _I, _I, _I, _P])
    rc = fn(x.data_ptr(), out.data_ptr(), d, h, w, c, *build.stream_args(x))
    build.check(rc, "maxpool2")
    maxpool2.launches += 1
    return out


maxpool2.launches = 0
