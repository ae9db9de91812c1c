"""K7a/K7b: ConvTranspose3d(k2, s2) + bias with depth-to-space, on one
operand or on the channel concat of two, for Hopper.

Counterpart of ``ctunet_tpu/ops/pallas/convt.py``: ``conv_transpose_k2s2``
(K7a) and ``conv_transpose_k2s2_dual`` (K7b, the weight-split form that
never builds the concat). The CUDA source is ``csrc/convt.cu``. The TPU
kernels emit a W-packed-by-2 layout that ``unpack2`` reshapes; here the
output is the dense ``(2D, 2H, 2W, Co)`` volume. The function
(``convt.py:34-62,128-143``, no spatial flip):

``out[2z+a, 2y+b, 2x+c, o] = bias[o] + sum_i A[z,y,x,i] Wa[a,b,c,i,o]
+ sum_j B[z,y,x,j] Wb[a,b,c,j,o]``

with bf16 operands and weights, f32 accumulation and the f32 bias added
before one rounding. Weights are tap-major ``(2, 2, 2, Cin, Co)`` like the
conv kernels' (:func:`convt_weights` from the torch layout).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU;
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .conv3d import _check, _require_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int


def convt_weights(weight: torch.Tensor, bias: torch.Tensor,
                  ca: Optional[int] = None, dtype=torch.bfloat16):
    """torch ``ConvTranspose3d(k2, s2)`` weights ``(Cin, Co, 2, 2, 2)`` +
    bias -> the kernels' operands ``(wa, wb, bias)``: tap-major
    ``(2, 2, 2, C, Co)`` in ``dtype`` (rounded once from f32, as the JAX
    engine casts the flax kernel), split at input channel ``ca`` for the
    dual form (``wb`` is None without ``ca``), and the bias in f32."""
    w = weight.float().permute(2, 3, 4, 0, 1).to(dtype)
    if ca is None:
        return w.contiguous(), None, bias.float().contiguous()
    return (w[..., :ca, :].contiguous(), w[..., ca:, :].contiguous(),
            bias.float().contiguous())


def convt_k2s2_plain(a: torch.Tensor, b: Optional[torch.Tensor],
                     wa: torch.Tensor, wb: Optional[torch.Tensor],
                     bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7a (``b`` None) / K7b: an f32 einsum on the (already
    rounded) operands, + bias, one rounding to ``a.dtype``.

    :param a: ``(D, H, W, Ca)``; ``b``: ``(D, H, W, Cb)`` or None;
        ``wa``/``wb``: ``(2, 2, 2, C, Co)``; ``bias``: ``(Co,)`` f32.
    :returns: ``(2D, 2H, 2W, Co)``.
    """
    y = torch.einsum("zyxi,abcio->zaybxco", a.float(), wa.float())
    if b is not None:
        y = y + torch.einsum("zyxi,abcio->zaybxco", b.float(), wb.float())
    d, _, h, _, w, _, co = y.shape
    y = y.reshape(2 * d, 2 * h, 2 * w, co) + bias.float()
    return y.to(a.dtype)


def _launch(a, b, wa, wb, bias, what: str) -> torch.Tensor:
    _require_cuda(a, what)
    d, h, w, ca = a.shape
    co = wa.shape[-1]
    _check(a, "a", torch.bfloat16)
    _check(wa, "wa", torch.bfloat16, (2, 2, 2, ca, co), a.device)
    _check(bias, "bias", torch.float32, (co,), a.device)
    if b is not None:
        cb = b.shape[3]
        _check(b, "b", torch.bfloat16, (d, h, w, cb), a.device)
        _check(wb, "wb", torch.bfloat16, (2, 2, 2, cb, co), a.device)
    out = torch.empty((2 * d, 2 * h, 2 * w, co), dtype=torch.bfloat16,
                      device=a.device)
    if out.numel() == 0:
        return out
    if b is None:
        fn = build.function("convt", "ctunet_convt_k2s2",
                            [_P] * 4 + [_I] * 6 + [_P])
        rc = fn(a.data_ptr(), wa.data_ptr(), bias.data_ptr(), out.data_ptr(),
                d, h, w, ca, co, *build.stream_args(a))
    else:
        fn = build.function("convt", "ctunet_convt_k2s2_dual",
                            [_P] * 6 + [_I] * 7 + [_P])
        rc = fn(a.data_ptr(), b.data_ptr(), wa.data_ptr(), wb.data_ptr(),
                bias.data_ptr(), out.data_ptr(), d, h, w, ca, cb, co,
                *build.stream_args(a))
    build.check(rc, what)
    return out


def convt_k2s2(a: torch.Tensor, wa: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """K7a: ConvT(k2, s2) + bias of ``a`` ``(D, H, W, Ca)`` bf16 with
    ``wa`` ``(2, 2, 2, Ca, Co)`` bf16 -> ``(2D, 2H, 2W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/convt.cu``
    kernel on the current stream, or an error.
    """
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, None, wa, None, bias)
    out = _launch(a, None, wa, None, bias, "convt_k2s2")
    convt_k2s2.launches += 1
    return out


convt_k2s2.launches = 0


def convt_k2s2_dual(a: torch.Tensor, b: torch.Tensor, wa: torch.Tensor,
                    wb: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K7b: ConvT(k2, s2) + bias of ``cat(a, b)`` without the concat: ``a``
    ``(D, H, W, Ca)``, ``b`` ``(D, H, W, Cb)`` bf16, weights split at
    ``Ca`` (:func:`convt_weights`) -> ``(2D, 2H, 2W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/convt.cu``
    kernel on the current stream, or an error.
    """
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, b, wa, wb, bias)
    out = _launch(a, b, wa, wb, bias, "convt_k2s2_dual")
    convt_k2s2_dual.launches += 1
    return out


convt_k2s2_dual.launches = 0
