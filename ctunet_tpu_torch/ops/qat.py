"""Quantization-aware fine-tuning (QAT) for the int8 serving engine: a
fake-quantized forward that simulates ``engine_q``'s int8 arithmetic in the
differentiable graph.

Counterpart of ``ctunet_tpu/ops/qat.py``; ``tools/qat_tune_torch.py``
drives it (distillation towards the frozen float model). What it
simulates, as the JAX module does:

- per-channel activation quantization at every conv unit's output,
  ``fq(y) = clip(round(y / s), 0, 255) * s`` with the calibrated
  ``s = max / 255`` (the engine's requant epilogue and its saturation),
  with a clipped straight-through gradient: 1 inside ``[0, 255 s]``, 0
  where the activation saturates (:func:`_fq_act`);
- per-channel weight quantization of each conv unit with the engine's
  folding: BatchNorm's scale folded into the kernel, the input's
  activation scales folded per input channel, then ``k = 127 / max|w_s|``
  per output channel, gradient straight through (:func:`_fq_weight`);
- BatchNorm frozen to its running statistics;
- no rounding at the max pool (exact under per-channel scales) nor in the
  decoder's ConvT weights (the engine's composite upsample+conv weights
  are the one rounding not simulated).

The forward values keep JAX's expressions, not shortcuts: the
straight-through value is ``yf + (q - yf).detach()``, which rounds
differently from ``q`` in f32; the weight is rounded as ``round(w_s * k)``
clipped, then divided by ``k``, then by ``s_in``; ``torch.round`` rounds
half to even as ``jnp.round`` does. The convolution is ``F.conv3d`` in the
compute dtype: the JAX module's is ``packed_conv3d``, an XLA convolution
in every ``conv_impl``, not a Pallas kernel; the ConvT is the same einsum.

Weights are the port's state_dict names (``models/unet.py``); a mapping
whose values are the model's parameters (``state_dict(keep_vars=True)``)
gives gradients to the model.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_EPS_BN = 1e-5
_EPS = 1e-8

# The model-family table QAT serves, the port's copy of
# ``ctunet_tpu/models/packed_resident.py:59-66`` (head: None = the plain
# 3-channel sigmoid output, "double" = the (full skull, flap) encodings,
# "double_softmax" = both additionally softmaxed).
CONFIGS: Dict[str, Dict[str, Any]] = {
    "UNet4b2i3o": dict(n_blocks=4, i_size=7, head=None),
    "UNet5b2i3o": dict(n_blocks=5, i_size=4, head=None),
    "UNet4b1i3o": dict(n_blocks=4, i_size=7, head=None),
    "UNetSP": dict(n_blocks=4, i_size=7, head="double"),
    "UNetSPSmall": dict(n_blocks=5, i_size=4, head="double_softmax"),
    "UNetDO": dict(n_blocks=4, i_size=7, head="double"),
}


def supports(model_class: str) -> bool:
    return model_class in CONFIGS


def _f32(s, device) -> Tensor:
    return torch.as_tensor(np.asarray(s, np.float32) if not isinstance(
        s, Tensor) else s, dtype=torch.float32, device=device)


def _fq_act(y: Tensor, s) -> Tensor:
    """The engine's requant epilogue in float: round, clamp to [0, 255],
    with the clipped straight-through gradient (zero where ``y > 255 s``:
    a full STE lets fine-tuning push activations past the pinned scales
    unseen, which collapsed the plain forward in the JAX package's
    measurements)."""
    s = _f32(s, y.device)
    yf = y.float()
    q = torch.clamp(torch.round(yf / s), 0.0, 255.0) * s
    in_range = yf <= 255.0 * s  # post-ReLU: the lower bound never binds
    out = torch.where(in_range, yf + (q - yf).detach(), q.detach())
    return out.to(y.dtype)


def _fq_weight(w_eff: Tensor, s_in) -> Tensor:
    """The engine's per-output-channel weight quantization in float,
    straight-through. ``w_eff``: the BN-folded kernel ``(k, k, k, Ci,
    Co)``; ``s_in``: the input's per-channel activation scales. Returns
    the dequantized kernel."""
    w = w_eff.float()
    s = _f32(s_in, w.device)[None, None, None, :, None]
    w_s = w * s
    amax = w_s.abs().amax(dim=(0, 1, 2, 3)).detach()
    k = torch.where(amax > 0, 127.0 / torch.clamp(amax, min=_EPS),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(w_s * k), -127.0, 127.0) / k
    w_q = q / s
    return (w + (w_q - w).detach()).to(w_eff.dtype)


def _conv(x: Tensor, kernel: Tensor) -> Tensor:
    """SAME stride-1 conv of channels-last ``x`` with a tap-major
    ``(k, k, k, Ci, Co)`` kernel, in their dtype."""
    k = kernel.shape[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                 padding=k // 2)
    return y.permute(0, 2, 3, 4, 1)


def _unit(x: Tensor, sd: Mapping[str, Tensor], prefix: str, conv_idx: int,
          s_in, s_out, dtype, fq: bool) -> Tensor:
    """Conv + frozen BN + ReLU of the unit at ``prefix.conv_idx``, with the
    engine's fake quantization where a scale is given (a sparse scales
    dict quantizes a subset of the units)."""
    bn = f"{prefix}.{conv_idx + 1}"
    inv = (torch.rsqrt(sd[f"{bn}.running_var"].float() + _EPS_BN)
           * sd[f"{bn}.weight"].float())
    shift = sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * inv
    kernel = sd[f"{prefix}.{conv_idx}.weight"].permute(2, 3, 4, 1, 0)
    w_eff = kernel.float() * inv
    if fq and s_in is not None:
        w_eff = _fq_weight(w_eff, s_in)
    y = _conv(x.to(dtype), w_eff.to(dtype))
    y = torch.clamp(y + shift.to(y.dtype), min=0)
    if fq and s_out is not None:
        return _fq_act(y, s_out)
    return y


def _maxpool(x: Tensor) -> Tensor:
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).amax((2, 4, 6))


def _convt2x2(x: Tensor, weight: Tensor, bias: Tensor, dtype) -> Tensor:
    """ConvTranspose(k2, s2) of channels-last ``x`` with the torch weight
    ``(Ci, Co, 2, 2, 2)``: one einsum and a depth-to-space reshape."""
    y = torch.einsum("nzyxi,ioabc->nzaybxco", x.to(dtype), weight.to(dtype))
    nb, d, _, h, _, w, _, co = y.shape
    return y.reshape(nb, 2 * d, 2 * h, 2 * w, co) + bias.to(dtype)


class QATModel:
    """The fake-quantized forward of a generic-family model
    (:data:`CONFIGS`), over the port's state_dict names. ``scales`` None is
    capture mode: the plain forward, recording each unit's per-channel
    output maximum (:meth:`captured_scales`)."""

    def __init__(self, model_class: str,
                 scales: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16):
        if not supports(model_class):
            raise ValueError(f"QAT: unsupported model {model_class}")
        self.cfg = CONFIGS[model_class]
        self.scales = scales
        self.dtype = dtype
        self._captured: Dict[str, Tensor] = {}

    def _record(self, name: str, y: Tensor) -> Tensor:
        if self.scales is None:
            self._captured[name] = y.detach().float().abs().amax(
                dim=(0, 1, 2, 3))
        return y

    def captured_scales(self) -> Dict[str, np.ndarray]:
        """Per-unit output scales ``max / 255`` of the last capture-mode
        call, as f32 numpy arrays."""
        return {k: np.maximum(v.cpu().numpy().astype(np.float32), _EPS)
                / np.float32(255.0) for k, v in self._captured.items()}

    def apply(self, sd: Mapping[str, Tensor], x: Tensor):
        """``(B, D, H, W, C)`` -> the model's outputs under fake
        quantization (BatchNorm frozen)."""
        cfg = self.cfg
        n, head = cfg["n_blocks"], cfg["head"]
        fq = self.scales is not None
        sc = self.scales or {}
        dtype = self.dtype
        h = x.to(dtype)
        # entry: binary skull and atlas channels quantize exactly at 1/255
        s_cur = np.full((x.shape[-1],), 1.0 / 255.0, np.float32)
        skips = []
        for i in range(n):
            for j, conv_idx in enumerate((0, 3)):
                tag = f"d{i}.{j}"
                h = _unit(h, sd, f"d_blocks.{i}.block", conv_idx, s_cur,
                          sc.get(tag), dtype, fq)
                self._record(tag, h)
                s_cur = sc.get(tag)
            skips.append((h, s_cur))
            h = _maxpool(h)  # scales unchanged: max is monotonic

        a = h
        for idx in range(n):
            p = f"u_blocks.{idx}.block"
            cat = a if idx == 0 else torch.cat([a, skips[n - idx][0]], -1)
            h = _convt2x2(cat, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"], dtype)
            # unit 0 consumes the ConvT output unquantized (the engine fuses
            # ConvT o conv0 into one int8 composite); its output is
            # fake-quantized
            tag0, tag1 = f"u{idx}.0", f"u{idx}.1"
            h = _unit(h, sd, p, 1, None, sc.get(tag0), dtype, fq)
            self._record(tag0, h)
            h = _unit(h, sd, p, 4, sc.get(tag0), sc.get(tag1), dtype, fq)
            self._record(tag1, h)
            a = h

        # head: float math on the (fake-)quantized operands, like the
        # engine's scale-folded matmuls and f32 sigmoid
        b0, _ = skips[0]
        lk = sd["last_conv.weight"][:, :, 0, 0, 0].t().to(dtype)
        ca = a.shape[-1]
        out = a @ lk[:ca] + b0 @ lk[ca:] + sd["last_conv.bias"].to(dtype)
        out = torch.sigmoid(out)
        if head is None:
            return out
        m_full = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]],
                              dtype=out.dtype, device=out.device)
        m_flap = torch.tensor([[0.0, 0.0], [-1.0, 1.0], [0.0, 0.0]],
                              dtype=out.dtype, device=out.device)
        full = out @ m_full
        fl = out @ m_flap + torch.tensor([1.0, 0.0], dtype=out.dtype,
                                         device=out.device)
        if head == "double_softmax":
            return torch.softmax(full, -1), torch.softmax(fl, -1)
        return full, fl


def calibrate_unit_scales(model_class: str, sd: Mapping[str, Tensor],
                          calib_batch, dtype: torch.dtype = torch.bfloat16
                          ) -> Dict[str, np.ndarray]:
    """Per-unit output activation scales (``max / 255``) from one forward
    of ``calib_batch`` ``(B, D, H, W, C)`` (a tensor on the weights'
    device, or a numpy array, moved there)."""
    dev = next(iter(sd.values())).device
    cap = QATModel(model_class, scales=None, dtype=dtype)
    with torch.no_grad():
        cap.apply(sd, torch.as_tensor(np.asarray(calib_batch)
                                      if not isinstance(calib_batch, Tensor)
                                      else calib_batch).to(dev))
    return cap.captured_scales()
