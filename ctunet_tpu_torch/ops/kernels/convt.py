"""K7a/K7b: ConvTranspose3d(k2, s2) + bias with depth-to-space, on one
operand or on the channel concat of two, for Hopper.

Counterpart of ``ctunet_tpu/ops/pallas/convt.py``: ``conv_transpose_k2s2``
(K7a) and ``conv_transpose_k2s2_dual`` (K7b, the weight-split form that
never builds the concat). In bf16 both run the tensor-core kernel
:func:`~.upsample_tc.upconv_tc` (``csrc/upconv_tc.cu``, shared with K3),
in f32 :func:`convt_f32`, which launches the split-tf32 tensor-core kernel
:func:`~.upsample_tc.upconv_tc_f32` (``csrc/upconv_tc_f32.cu``, shared
with K3 in f32); the CUDA-core kernel ``csrc/convt.cu`` they launched
before stays reachable, bf16 and f32, as :func:`convt_k2s2_direct` /
:func:`convt_k2s2_dual_direct` for timing beside them.
The TPU kernels emit a W-packed-by-2 layout that ``unpack2`` reshapes;
here the output is the dense ``(2D, 2H, 2W, Co)`` volume. The function
(``convt.py:34-62,128-143``, no spatial flip):

``out[2z+a, 2y+b, 2x+c, o] = bias[o] + sum_i A[z,y,x,i] Wa[a,b,c,i,o]
+ sum_j B[z,y,x,j] Wb[a,b,c,j,o]``

with operands and weights of one dtype (bf16 or f32), f32 accumulation and
the f32 bias added before one rounding (none in f32). Weights are
tap-major ``(2, 2, 2, Cin, Co)`` like the conv kernels'
(:func:`convt_weights` from the torch layout).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU;
``<wrapper>.launches`` counts kernel launches (each also counts on
``upconv_tc`` in bf16, on ``convt_f32`` and ``upconv_tc_f32`` in f32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .conv3d import _check, _require_cuda
from .upsample_tc import upconv_tc, upconv_tc_f32

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


def _launch_direct(a, b, wa, wb, bias, what: str) -> torch.Tensor:
    """One launch of the CUDA-core kernel ``csrc/convt.cu`` on bf16 or f32
    operands (``ctunet_convt_k2s2[_dual]``, ``_f32`` in f32)."""
    _require_cuda(a, what)
    dt = a.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: expected bfloat16 or float32, got {dt}")
    d, h, w, ca = a.shape
    co = wa.shape[-1]
    _check(a, "a", dt)
    _check(wa, "wa", dt, (2, 2, 2, ca, co), a.device)
    _check(bias, "bias", torch.float32, (co,), a.device)
    if b is not None:
        cb = b.shape[3]
        _check(b, "b", dt, (d, h, w, cb), a.device)
        _check(wb, "wb", dt, (2, 2, 2, cb, co), a.device)
    out = torch.empty((2 * d, 2 * h, 2 * w, co), dtype=dt, device=a.device)
    if out.numel() == 0:
        return out
    f32 = "_f32" if dt == torch.float32 else ""
    if b is None:
        fn = build.function("convt", "ctunet_convt_k2s2" + f32,
                            [_P] * 4 + [_I] * 6 + [_P])
        rc = fn(a.data_ptr(), wa.data_ptr(), bias.data_ptr(), out.data_ptr(),
                d, h, w, ca, co, *build.stream_args(a))
    else:
        fn = build.function("convt", "ctunet_convt_k2s2_dual" + f32,
                            [_P] * 6 + [_I] * 7 + [_P])
        rc = fn(a.data_ptr(), b.data_ptr(), wa.data_ptr(), wb.data_ptr(),
                bias.data_ptr(), out.data_ptr(), d, h, w, ca, cb, co,
                *build.stream_args(a))
    build.check(rc, what)
    return out


@build.traced
def convt_f32(a: torch.Tensor, b: Optional[torch.Tensor], wa: torch.Tensor,
              wb: Optional[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
    """K7a's (``b`` None) and K7b's f32 kernel: f32 ``a`` ``(D, H, W, Ca)``,
    ``b`` ``(D, H, W, Cb)``, ``wa``/``wb`` ``(2, 2, 2, C, Co)`` and
    ``bias`` ``(Co,)`` -> f32 ``(2D, 2H, 2W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the split-tf32
    tensor-core kernel :func:`~.upsample_tc.upconv_tc_f32`
    (``csrc/upconv_tc_f32.cu``, which reads ``a`` and ``b`` by two
    pointers) on the current stream, or an error.
    """
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, b, wa, wb, bias)
    _require_cuda(a, "convt_f32")
    if a.dtype != torch.float32:
        raise TypeError(f"convt_f32: float32 only, got {a.dtype}")
    out = upconv_tc_f32(a, b, wa, wb, None, bias, k3=False)
    if out.numel():  # an empty volume launches nothing
        convt_f32.launches += 1
    return out


convt_f32.launches = 0


@build.traced
def convt_k2s2(a: torch.Tensor, wa: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """K7a: ConvT(k2, s2) + bias of ``a`` ``(D, H, W, Ca)`` with ``wa``
    ``(2, 2, 2, Ca, Co)`` of ``a``'s dtype (bf16 or f32) ->
    ``(2D, 2H, 2W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the tensor-core kernel
    :func:`~.upsample_tc.upconv_tc` (``csrc/upconv_tc.cu``) in bf16,
    :func:`convt_f32` (the split-tf32 ``csrc/upconv_tc_f32.cu``) in f32, on
    the current stream, or an error.
    """
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, None, wa, None, bias)
    if a.dtype == torch.float32:
        out = convt_f32(a, None, wa, None, bias)
    else:
        out = upconv_tc(a, None, wa, None, None, bias, k3=False)
    if out.numel():  # an empty volume launches nothing
        convt_k2s2.launches += 1
    return out


convt_k2s2.launches = 0


@build.traced
def convt_k2s2_dual(a: torch.Tensor, b: torch.Tensor, wa: torch.Tensor,
                    wb: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K7b: ConvT(k2, s2) + bias of ``cat(a, b)`` without the concat: ``a``
    ``(D, H, W, Ca)``, ``b`` ``(D, H, W, Cb)`` (bf16 or f32), weights split
    at ``Ca`` (:func:`convt_weights`) -> ``(2D, 2H, 2W, Co)``.

    CPU tensor: the plain version. CUDA tensor: the tensor-core kernel
    :func:`~.upsample_tc.upconv_tc` (``csrc/upconv_tc.cu``) in bf16,
    :func:`convt_f32` (the split-tf32 ``csrc/upconv_tc_f32.cu``) in f32, on
    the current stream, or an error.
    """
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, b, wa, wb, bias)
    if a.dtype == torch.float32:
        out = convt_f32(a, b, wa, wb, bias)
    else:
        out = upconv_tc(a, b, wa, wb, None, bias, k3=False)
    if out.numel():  # an empty volume launches nothing
        convt_k2s2_dual.launches += 1
    return out


convt_k2s2_dual.launches = 0


def convt_k2s2_direct(a: torch.Tensor, wa: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """K7a on the CUDA cores (``csrc/convt.cu``, bf16 or f32), the kernel
    :func:`convt_k2s2` launched before ``upconv_tc`` (bf16) and
    ``upconv_tc_f32`` (f32): kept for timing beside them; the plain version
    on CPU tensors. Counts no launches."""
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, None, wa, None, bias)
    return _launch_direct(a, None, wa, None, bias, "convt_k2s2_direct")


def convt_k2s2_dual_direct(a: torch.Tensor, b: torch.Tensor,
                           wa: torch.Tensor, wb: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """K7b on the CUDA cores (``csrc/convt.cu``, bf16 or f32), the kernel
    :func:`convt_k2s2_dual` launched before ``upconv_tc`` (bf16) and
    ``upconv_tc_f32`` (f32): kept for timing beside them; the plain version
    on CPU tensors. Counts no launches."""
    if a.device.type == "cpu":
        return convt_k2s2_plain(a, b, wa, wb, bias)
    return _launch_direct(a, b, wa, wb, bias, "convt_k2s2_dual_direct")
