"""K3: fused upsample + conv (ConvT(k2,s2) o Conv3D(k3) + folded BN + ReLU),
and its int8 mode K3q (requantizing, zero-point).

Counterpart of ``ctunet_tpu/ops/pallas/upconv.py::upconv_fused_chain_split``
(bf16, and int8 ``scale2=``/``zp=``) and of ``upconv_fused_chain`` (the
full-tap form, K4b, whose int8 integers are the same).
The decoder's ConvTranspose(k2, s2) and the first conv unit after it are
both linear, so they compose into one response ``R[4, 4, 4, Cin_aug, Co]``
applied to the HALF-resolution inputs: ``out[v] = sum_u R[v-2u+1] in[u]``
(:func:`composite_response`, the port's copy of ``upconv.py:48-113``). That
is a k4/s2/p1 transposed convolution, which gives the plain version
exactly. The convT bias rides an input channel that is 1 inside the volume
and 0 outside (``upconv.py:18-22``), so its contribution near the borders
depends on position.

In bf16, K3 runs the tensor-core kernel :func:`~.upsample_tc.upconv_tc`
(``csrc/upconv_tc.cu``, shared with K7a/K7b; each launch also counts on
``upconv_tc``); the CUDA-core kernel ``csrc/upconv.cu`` it launched before
stays reachable as :func:`upconv_bn_relu_direct` for timing beside it. K3q
runs ``csrc/upconv_q.cu``.

Input channels of ``R``: ``[a (ca) | ones | b (cb) | zero]`` as
:func:`augment_upconv_kernel` lays them out; the zero column (operand b's
ones lane on the TPU) contributes nothing and is dropped from the operands
the kernel takes (:func:`split_response`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .conv3d import _check, _require_cuda, fma_requant, fold_bn
from .upsample_tc import upconv_tc

_P, _I = ctypes.c_void_p, ctypes.c_int


def augment_upconv_kernel(kk: np.ndarray, bb: np.ndarray,
                          ca: Optional[int] = None):
    """Append the convT bias as a ones-driven input column.

    ``kk``: flax transpose-kernel layout ``(2, 2, 2, Ct, Cin)``. Single
    operand (``ca=None``): ``[k | bias-col]``. Dual operand (operand a has
    ``ca`` channels, then operand b): ``[k_a | bias-col | k_b | zero-col]``.
    Returns ``(kT_aug, ci_split)``, ``ci_split`` the lane where operand b
    starts (None for one operand).
    """
    kk = np.asarray(kk, np.float32)
    bcol = np.broadcast_to(
        np.asarray(bb, np.float32)[None, None, None, :, None],
        kk.shape[:4] + (1,),
    ).copy()
    if ca is None:
        return np.concatenate([kk, bcol], -1), None
    zcol = np.zeros_like(bcol)
    kT_aug = np.concatenate([kk[..., :ca], bcol, kk[..., ca:], zcol], -1)
    return kT_aug, ca + 1


def composite_response(kT: np.ndarray, w0: np.ndarray,
                       scale0: Optional[np.ndarray] = None) -> np.ndarray:
    """Composite responses ``R[rz, ry, rx, ci, co]`` (r in [-1, 2] -> r+1),
    computed in f64 and returned as f32.

    :param kT: convT weights ``(2, 2, 2, Ct, Cin)`` with the bias column
        appended (:func:`augment_upconv_kernel`).
    :param w0: conv weights ``(3, 3, 3, Ct, Co)``; ``scale0`` optional BN
        fold per output channel.
    """
    kT = np.asarray(kT, np.float64)
    w0 = np.asarray(w0, np.float64)
    if scale0 is not None:
        w0 = w0 * np.asarray(scale0, np.float64)[None, None, None, None, :]
    cin, co = kT.shape[4], w0.shape[4]
    R = np.zeros((4, 4, 4, cin, co), np.float64)
    # convT writes 2u+a; the conv tap d reads v+d-1 = 2u+a -> r = a-d+1
    for az in range(2):
        for ay in range(2):
            for ax in range(2):
                for dz in range(3):
                    for dy in range(3):
                        for dx in range(3):
                            R[az - dz + 2, ay - dy + 2, ax - dx + 2] += (
                                np.einsum("ti,to->io", kT[az, ay, ax],
                                          w0[dz, dy, dx]))
    return R.astype(np.float32)


def prepare_upconv(up_w, up_b, conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var,
                   ca: Optional[int], dtype=torch.bfloat16):
    """Decoder block weights -> K3 operands ``(wa, wb, wone, bias)``.

    ``up_w`` torch ConvTranspose3d ``(Cin, Ct, 2, 2, 2)``, ``conv_w``
    ``(Co, Ct, 3, 3, 3)``; ``ca`` is the first operand's channel count when
    the block input is ``cat(a, b)``, else None. The composite is built in
    f64, cast to f32 and then to ``dtype`` (``upconv.py:91-113, 529-533``);
    ``bias`` is the folded conv bias in f32.
    """
    kk = up_w.detach().cpu().float().permute(2, 3, 4, 1, 0).numpy()
    kT_aug, _ = augment_upconv_kernel(kk, up_b.detach().cpu().numpy(), ca)
    inv, bn_bias = fold_bn(bn_w.cpu(), bn_b.cpu(), bn_mean.cpu(),
                           bn_var.cpu())
    w0 = conv_w.detach().cpu().float().permute(2, 3, 4, 1, 0).numpy()
    R = torch.from_numpy(composite_response(kT_aug, w0, inv.numpy()))
    wa, wone, wb = split_response(R, ca)
    cb = torch.zeros_like(inv) if conv_b is None else conv_b.cpu().float()
    return (wa.to(dtype), None if wb is None else wb.to(dtype),
            wone.to(dtype), (cb * inv + bn_bias).contiguous())


def split_response(R: torch.Tensor, ca: Optional[int]):
    """``R[..., Cin_aug, Co]`` -> ``(wa, wone, wb)``: operand a's rows, the
    ones-channel row ``(4, 4, 4, Co)`` and operand b's rows (None for one
    operand); the trailing zero row of the dual layout is dropped."""
    n_a = R.shape[3] - 1 if ca is None else ca
    wa = R[..., :n_a, :].contiguous()
    wone = R[..., n_a, :].contiguous()
    wb = (None if ca is None
          else R[..., n_a + 1: R.shape[3] - 1, :].contiguous())
    return wa, wone, wb


def upconv_bn_relu_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                         wa: torch.Tensor, wb: Optional[torch.Tensor],
                         wone: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: ``F.conv_transpose3d(x_aug, R, stride=2,
    padding=1)`` in f32, + bias, ReLU, cast to ``a.dtype``, with
    ``x_aug = cat(a, 1, b)`` and ``R = cat(wa, wone, wb)`` on the channel
    axis (exact: ``out[v] = sum_u R[v-2u+1] in[u]`` is that transposed
    conv).

    :param a: ``(D2, H2, W2, Ca)``; ``b``: ``(D2, H2, W2, Cb)`` or None.
    :returns: ``(2*D2, 2*H2, 2*W2, Co)``.
    """
    parts = [a.float(), torch.ones_like(a[..., :1], dtype=torch.float32)]
    ws = [wa.float(), wone.float()[..., None, :]]
    if b is not None:
        parts.append(b.float())
        ws.append(wb.float())
    x = torch.cat(parts, -1).permute(3, 0, 1, 2)[None]
    R = torch.cat(ws, 3).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x, R, stride=2, padding=1)[0].permute(1, 2, 3, 0)
    return torch.relu(y + bias.float()).to(a.dtype)


def upconv_bn_relu(a: torch.Tensor, b: Optional[torch.Tensor],
                   wa: torch.Tensor, wb: Optional[torch.Tensor],
                   wone: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3 on half-resolution ``a`` (and skip ``b``) -> full resolution.

    CPU tensor: the plain version. CUDA tensor: the tensor-core kernel
    :func:`~.upsample_tc.upconv_tc` (``csrc/upconv_tc.cu``, bf16 only) on the
    current stream, or an error.
    """
    if a.device.type == "cpu":
        return upconv_bn_relu_plain(a, b, wa, wb, wone, bias)
    out = upconv_tc(a, b, wa, wb, wone, bias, k3=True)
    if out.numel():  # an empty volume launches nothing
        upconv_bn_relu.launches += 1
    return out


upconv_bn_relu.launches = 0


def upconv_bn_relu_direct(a: torch.Tensor, b: Optional[torch.Tensor],
                          wa: torch.Tensor, wb: Optional[torch.Tensor],
                          wone: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """K3 on the CUDA cores (``csrc/upconv.cu``, bf16), the kernel
    :func:`upconv_bn_relu` launched before ``upconv_tc``: kept for timing
    beside it (``chip_smoke.py`` phase 2); the plain version on CPU
    tensors. Counts no launches."""
    if a.device.type == "cpu":
        return upconv_bn_relu_plain(a, b, wa, wb, wone, bias)
    _require_cuda(a, "upconv_bn_relu_direct")
    d2, h2, w2, ca = a.shape
    co = wa.shape[-1]
    cb = 0 if b is None else b.shape[-1]
    _check(a, "a", torch.bfloat16)
    _check(wa, "wa", torch.bfloat16, (4, 4, 4, ca, co), a.device)
    _check(wone, "wone", torch.bfloat16, (4, 4, 4, co), a.device)
    _check(bias, "bias", torch.float32, (co,), a.device)
    if b is not None:
        _check(b, "b", torch.bfloat16, (d2, h2, w2, cb), a.device)
        _check(wb, "wb", torch.bfloat16, (4, 4, 4, cb, co), a.device)
    out = torch.empty((2 * d2, 2 * h2, 2 * w2, co), dtype=torch.bfloat16,
                      device=a.device)
    if out.numel() == 0:
        return out
    fn = build.function("upconv", "ctunet_upconv_bn_relu",
                        [_P] * 7 + [_I] * 7 + [_P])
    rc = fn(a.data_ptr(), None if b is None else b.data_ptr(),
            wa.data_ptr(), None if wb is None else wb.data_ptr(),
            wone.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d2, h2, w2, ca, cb, co, *build.stream_args(a))
    build.check(rc, "upconv_bn_relu_direct")
    return out


# --------------------------------------------------------------------------
# K3q: int8 fused upsample + conv, requant epilogue, per-parity bias
# --------------------------------------------------------------------------


def upconv_q_requant_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                           wa: torch.Tensor, wb: Optional[torch.Tensor],
                           wone: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor,
                           zp: bool = True) -> torch.Tensor:
    """Plain PyTorch K3q: the int32 accumulator exactly, as the k4/s2/p1
    transposed conv of ``x_aug = cat(a, 127, b)`` (the ones lane holds 127
    inside the volume) in f64, with one layer of the layout's fill (-128 in
    ``zp`` mode, else 0) around the half-resolution volume in EVERY lane;
    then the epilogue of ``upconv.py:431-441`` (one rounding,
    :func:`~.conv3d.fma_requant`) with the bias row of each output voxel's
    parity.

    :param a: int8 ``(D2, H2, W2, Ca)``; ``b``: int8 ``(D2, H2, W2, Cb)``
        or None; ``wa``/``wb``: int8 ``(4, 4, 4, C, Co)``; ``wone``: int8
        ``(4, 4, 4, Co)``; ``scale``: f32 ``(Co,)``; ``bias``: f32
        ``(8, Co)``, row ``4*pz + 2*py + px`` for output parity (pz, py, px).
    :returns: int8 ``(2*D2, 2*H2, 2*W2, Co)``.
    """
    fill = -128.0 if zp else 0.0
    parts = [a.double(), torch.full_like(a[..., :1], 127, dtype=torch.float64)]
    ws = [wa.double(), wone.double()[..., None, :]]
    if b is not None:
        parts.append(b.double())
        ws.append(wb.double())
    x = F.pad(torch.cat(parts, -1).permute(3, 0, 1, 2)[None], (1,) * 6,
              value=fill)
    R = torch.cat(ws, 3).permute(3, 4, 0, 1, 2)
    acc = F.conv_transpose3d(x, R, stride=2, padding=1)[0, :, 2:-2, 2:-2,
                                                          2:-2]
    d2, h2, w2 = a.shape[:3]
    co = acc.shape[0]
    res = fma_requant(acc.permute(1, 2, 3, 0).reshape(d2, 2, h2, 2, w2, 2, co),
                      scale, bias.reshape(1, 2, 1, 2, 1, 2, co))
    res = torch.clamp_min(res, 0.0).reshape(2 * d2, 2 * h2, 2 * w2, co)
    if zp:
        return (torch.round(torch.clamp_max(res, 255.0)) - 128.0).to(
            torch.int8)
    return torch.round(torch.clamp_max(res, 127.0)).to(torch.int8)


def upconv_q_requant(a: torch.Tensor, b: Optional[torch.Tensor],
                     wa: torch.Tensor, wb: Optional[torch.Tensor],
                     wone: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, zp: bool = True) -> torch.Tensor:
    """K3q on int8 half-resolution ``a`` (and skip ``b``) -> int8 full
    resolution (arguments as :func:`upconv_q_requant_plain`).

    CPU tensor: the plain version. CUDA tensor: the ``csrc/upconv_q.cu``
    kernel on the current stream, or an error.
    """
    if a.device.type == "cpu":
        return upconv_q_requant_plain(a, b, wa, wb, wone, scale, bias, zp)
    _require_cuda(a, "upconv_q_requant")
    d2, h2, w2, ca = a.shape
    co = wa.shape[-1]
    cb = 0 if b is None else b.shape[-1]
    _check(a, "a", torch.int8)
    _check(wa, "wa", torch.int8, (4, 4, 4, ca, co), a.device)
    _check(wone, "wone", torch.int8, (4, 4, 4, co), a.device)
    _check(scale, "scale", torch.float32, (co,), a.device)
    _check(bias, "bias", torch.float32, (8, co), a.device)
    if b is not None:
        _check(b, "b", torch.int8, (d2, h2, w2, cb), a.device)
        _check(wb, "wb", torch.int8, (4, 4, 4, cb, co), a.device)
    out = torch.empty((2 * d2, 2 * h2, 2 * w2, co), dtype=torch.int8,
                      device=a.device)
    if out.numel() == 0:
        return out
    fn = build.function("upconv_q", "ctunet_upconv_q_requant",
                        [_P] * 8 + [_I] * 8 + [_P])
    rc = fn(a.data_ptr(), None if b is None else b.data_ptr(),
            wa.data_ptr(), None if wb is None else wb.data_ptr(),
            wone.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d2, h2, w2, ca, cb, co, int(zp),
            *build.stream_args(a))
    build.check(rc, "upconv_q_requant")
    upconv_q_requant.launches += 1
    return out


upconv_q_requant.launches = 0
