"""K1 (Conv3D k3 + folded BN + ReLU) and K2 (2x2x2 max pool) for Hopper,
with their int8 modes K1q (requantizing int8 conv) and K2q (int8 pool), K6
(Conv3D k3 + bias + optional ReLU in bf16 or f32, the training conv) and
K5 (the same at k5, the legacy family's conv).

Counterpart of ``ctunet_tpu/ops/pallas/conv3d.py``: ``conv3d_chain_split``
(bf16 and ``scale=``/``zp=`` int8 modes), ``conv3d_chain_q`` (the full-tap
int8 form, K4a), ``maxpool2_chain``, ``conv3d_chain`` (K6: forward and
input gradient of the training conv, ``ops/chain_conv_train.py``, and the
``sparse`` serving route) and ``conv3d_fused`` at k=5 (K5). The CUDA
sources are ``csrc/conv3d.cu``, ``csrc/conv3d_k5.cu``,
``csrc/conv3d_q.cu`` and ``csrc/maxpool.cu``; the TPU chain and W-packed
layouts (W packed into lanes, halo rows, ones-channel) are not carried
over: every function takes and returns dense channels-last volumes.

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
    """Conv3d(k3 or k5) + BatchNorm3d weights -> the kernel's operands.

    ``conv_w`` is torch ``(O, I, k, k, k)``. Returns ``(w, bias)`` with
    ``w = conv_w * scale`` folded in f32 and then cast to ``dtype``, laid
    out tap-major ``(k, k, k, I, O)``, and ``bias`` f32 ``(O,)``:
    ``conv_b * scale + bn_shift`` — the rounding of the JAX engine
    (``engine.py:77-86``, ``conv3d.py:71-72,223,815-816,1124``: bf16
    weights, f32 bias added to the f32 accumulator).
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
    """Plain PyTorch K1: K6's plain version with the ReLU on."""
    return conv3d_bias_act_plain(x, w, bias, True)


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
# K6: Conv3D(k3, SAME) + bias + optional ReLU, bf16 or f32
# --------------------------------------------------------------------------


def conv3d_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain PyTorch K6: ``F.conv3d`` in f32 on the (already rounded)
    inputs, + bias, ReLU when ``relu``, cast back to ``x.dtype``.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(3, 3, 3, Ci, Co)``; ``bias``:
        ``(Co,)`` f32.
    """
    xf = x.float().permute(3, 0, 1, 2)[None]
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=1)[0].permute(1, 2, 3, 0) + bias.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def conv3d_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """K6 on ``x`` ``(D, H, W, Ci)`` with ``w`` ``(3, 3, 3, Ci, Co)`` of
    ``x``'s dtype (bf16 or f32) and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv(x, w) + bias)`` accumulated in f32, ``act``
    the ReLU when ``relu`` else the identity.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d.cu``
    kernel on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_bias_act_plain(x, w, bias, relu)
    _require_cuda(x, "conv3d_bias_act")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    _check(x, "x", x.dtype)
    _check(w, "w", x.dtype, (3, 3, 3, ci, co), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    out = torch.empty((d, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("conv3d", "ctunet_conv3d_bias_act",
                        [_P] * 4 + [_I] * 8 + [_P])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, int(x.dtype == torch.float32), int(bool(relu)),
            *build.stream_args(x))
    build.check(rc, "conv3d_bias_act")
    conv3d_bias_act.launches += 1
    return out


conv3d_bias_act.launches = 0


# --------------------------------------------------------------------------
# K5: Conv3D(k5, SAME) + bias + optional ReLU, bf16 or f32
# --------------------------------------------------------------------------

# dz-plane staging holds 25*Ci*8 f32 weights in one block's shared memory
K5_MAX_CI = 232448 // (25 * 8 * 4)


def conv3d5_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """Plain PyTorch K5: ``F.conv3d`` with ``padding=2`` in f32 on the
    (already rounded) inputs, + bias, ReLU when ``relu``, cast back to
    ``x.dtype`` once.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(5, 5, 5, Ci, Co)``; ``bias``:
        ``(Co,)`` f32.
    """
    xf = x.float().permute(3, 0, 1, 2)[None]
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=2)[0].permute(1, 2, 3, 0) + bias.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def conv3d5_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """K5 on ``x`` ``(D, H, W, Ci)`` with ``w`` ``(5, 5, 5, Ci, Co)`` of
    ``x``'s dtype (bf16 or f32) and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv5(x, w) + bias)`` accumulated in f32,
    ``act`` the ReLU when ``relu`` (the legacy engine's conv units, BN
    folded into ``w`` and ``bias`` by :func:`fold_conv_unit`) else the
    identity.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d_k5.cu``
    kernel on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return conv3d5_bias_act_plain(x, w, bias, relu)
    _require_cuda(x, "conv3d5_bias_act")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    if ci > K5_MAX_CI:
        raise ValueError(f"conv3d5_bias_act: Ci={ci} > {K5_MAX_CI}, the "
                         "widest input whose weight plane fits a block")
    _check(x, "x", x.dtype)
    _check(w, "w", x.dtype, (5, 5, 5, ci, co), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    out = torch.empty((d, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("conv3d_k5", "ctunet_conv3d5_bias_act",
                        [_P] * 4 + [_I] * 8 + [_P])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, int(x.dtype == torch.float32), int(bool(relu)),
            *build.stream_args(x))
    build.check(rc, "conv3d5_bias_act")
    conv3d5_bias_act.launches += 1
    return out


conv3d5_bias_act.launches = 0


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


# --------------------------------------------------------------------------
# K1q: int8 Conv3D(k3, SAME) + requant epilogue
# --------------------------------------------------------------------------


def fma_requant(acc: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """``f32(acc) * scale + bias`` rounded once to f32, as the Pallas int8
    epilogues compute it (XLA fuses their multiply-add) and the int8
    kernels do (``__fmaf_rn``). f64 holds the product of two f32 values
    exactly; only the sum may round before the cast to f32, which can then
    differ from one rounding only when the f64 sum lands exactly on an f32
    midpoint."""
    return (acc.float().double() * scale.double() + bias.double()).float()


def conv3d_q_requant_plain(x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           zp: bool = True) -> torch.Tensor:
    """Plain PyTorch K1q: the int32 accumulator exactly (``F.conv3d`` in
    f64 on the int8 values, padded with the layout's fill: -128 in ``zp``
    mode, 0 otherwise; f32 is not exact past 2^24), then the epilogue of
    ``conv3d.py:1001-1013`` / ``:1597-1612`` (:func:`fma_requant`).

    :param x: int8 ``(D, H, W, Ci)``; ``w``: int8 ``(3, 3, 3, Ci, Co)``;
        ``scale``/``bias``: f32 ``(Co,)``.
    :returns: int8 ``(D, H, W, Co)``.
    """
    xf = F.pad(x.double().permute(3, 0, 1, 2)[None], (1,) * 6,
               value=-128.0 if zp else 0.0)
    acc = F.conv3d(xf, w.double().permute(4, 3, 0, 1, 2))[0]
    res = torch.clamp_min(fma_requant(acc.permute(1, 2, 3, 0), scale, bias),
                          0.0)
    res = (torch.clamp_max(res, 255.0) - 128.0 if zp
           else torch.clamp_max(res, 127.0))
    return torch.round(res).to(torch.int8)


def conv3d_q_requant(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, zp: bool = True) -> torch.Tensor:
    """K1q on int8 ``x`` ``(D, H, W, Ci)`` with int8 ``w``
    ``(3, 3, 3, Ci, Co)`` and f32 requant ``scale``/``bias`` ``(Co,)`` ->
    int8 ``(D, H, W, Co)``: ``round(min(relu(fma(acc, scale, bias)), 255)
    - 128)`` in ``zp`` mode (out-of-volume taps read -128), else
    ``round(min(relu(.), 127))`` (they read 0).

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d_q.cu``
    kernel on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_q_requant_plain(x, w, scale, bias, zp)
    _require_cuda(x, "conv3d_q_requant")
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    _check(x, "x", torch.int8)
    _check(w, "w", torch.int8, (3, 3, 3, ci, co), x.device)
    _check(scale, "scale", torch.float32, (co,), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    out = torch.empty((d, h, wd, co), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("conv3d_q", "ctunet_conv3d_q_requant",
                        [_P] * 5 + [_I] * 7 + [_P])
    rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d, h, wd, ci, co, int(zp), *build.stream_args(x))
    build.check(rc, "conv3d_q_requant")
    conv3d_q_requant.launches += 1
    return out


conv3d_q_requant.launches = 0


# --------------------------------------------------------------------------
# K2q: int8 MaxPool 2x2x2, stride 2
# --------------------------------------------------------------------------


def maxpool2_q_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2q: the max over each 2x2x2 block of an int8
    ``(D, H, W, C)`` volume (odd extents floor), by reshape and ``amax``
    (``F.max_pool3d`` takes no int8)."""
    d, h, w = (s // 2 for s in x.shape[:3])
    c = x.shape[3]
    y = x[:2 * d, :2 * h, :2 * w].reshape(d, 2, h, 2, w, 2, c)
    return y.amax(dim=(1, 3, 5)).contiguous()


def maxpool2_q(x: torch.Tensor) -> torch.Tensor:
    """K2q on int8 ``(D, H, W, C)`` -> ``(D//2, H//2, W//2, C)``.

    CPU tensor: the plain version. CUDA tensor: the int8 instantiation of
    ``csrc/maxpool.cu`` on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return maxpool2_q_plain(x)
    _require_cuda(x, "maxpool2_q")
    d, h, w, c = x.shape
    _check(x, "x", torch.int8)
    out = torch.empty((d // 2, h // 2, w // 2, c), dtype=torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("maxpool", "ctunet_maxpool2_q",
                        [_P, _P, _I, _I, _I, _I, _I, _P])
    rc = fn(x.data_ptr(), out.data_ptr(), d, h, w, c, *build.stream_args(x))
    build.check(rc, "maxpool2_q")
    maxpool2_q.launches += 1
    return out


maxpool2_q.launches = 0
