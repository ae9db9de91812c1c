"""Serving engine: the U-Net forward on the port's Hopper kernels, in bf16
or f32 (``compute_dtype``).

Counterpart of ``ctunet_tpu/engine.py::build_predict`` (``:279-636``) for
the generic 4-block family and ``_build_legacy_predict`` (``:766-828``) for
the legacy k=5 family. Weights are prepared once, at build time, and the
forward runs per volume on dense channels-last tensors.

Generic family (UNetSP, UNetDO, UNet4b2i3o, UNet4b1i3o):

- encoder level i: K1 (conv unit 0) -> K1 (conv unit 1) -> K2 (pool);
- decoder level idx: K3 (ConvT(k2,s2) of ``cat(a, skip)`` fused with conv
  unit 0, from the half-resolution operands) -> K1 (conv unit 1);
- head: the 1x1 ``last_conv`` weight-split over (last decoder output,
  first skip) as two small matmuls in the compute dtype, sigmoid in f32,
  then the two 3x2 maps of the double-output head (``engine.py:405-484``).

For UNetSP at 224x304x304 that is 12 K1, 4 K2 and 4 K3 launches per
volume; the upconv composite is built in f64, rounded to f32 and then to
the compute dtype.

Legacy family (recAE_v2_fixed, UNet4_2IC; :func:`build_legacy_predict`):

- encoder level i: K5 -> K5 -> K2; the live center: K5 -> K5;
- decoder block 1: K7a (ConvT(k2,s2) of the center output) -> K5 -> K5;
  blocks 2..4: K7b (ConvT of ``cat(previous block output, skip)``, never
  concatenated) -> K5 -> K5;
- head: ``last_conv`` weight-split over (block 4 output, first skip) as
  two small matmuls plus the bias in the compute dtype, softmax in f32
  (``engine.py:814-820``).

That is 18 K5, 4 K2, 1 K7a and 3 K7b launches per volume. Weight rounding
follows the JAX engine: conv weights are folded with BN in f32 and then
cast to the compute dtype, biases (``conv_bias * scale + bn_shift`` where
the conv has a bias) stay f32; ConvT weights are cast once.

Both dtypes run on the card, as the JAX engine runs its Pallas kernels in
``compute_dtype``: in bf16 the convs and upsamplings launch the
tensor-core kernels (``conv3d_tc``, ``upconv_tc``); in f32 ``conv3d_f32``
(K1), ``conv3d5_f32`` (K5), ``upconv_f32`` (K3) and ``convt_f32``
(K7a/K7b) launch the split-tf32 tensor-core kernels (``conv3d_tc_f32``,
``upconv_tc_f32``), all f32-accurate; K2 in either dtype launches the
row-streaming pool (``maxpool2_rows``). The heads' matmuls run in the compute dtype through
``torch.matmul``.

The code is the same on both devices. For CUDA tensors each kernel wrapper
launches its kernel or raises; for CPU tensors it runs its plain PyTorch
version. ``plain=True`` asks for the plain versions on any device (the
reference run that the chip check compares masks with).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .device import resolve_device
from .models.variants import B_FLAP, M_FLAP, M_FULL
from .ops.kernels import conv3d as kc
from .ops.kernels import convt as kt
from .ops.kernels import upconv as ku

# Structural config per ported model (``ctunet_tpu/engine.py:37-48``).
ENGINE_CONFIGS = {
    "UNet4b2i3o": dict(n_blocks=4, head=None, family="generic"),
    "UNet4b1i3o": dict(n_blocks=4, head=None, family="generic"),
    "UNetSP": dict(n_blocks=4, head="double", family="generic"),
    "UNetDO": dict(n_blocks=4, head="double", family="generic"),
    "recAE_v2_fixed": dict(n_blocks=4, head="softmax", family="legacy"),
    "UNet4_2IC": dict(n_blocks=4, head="softmax", family="legacy"),
}

# Families ctunet_tpu's engine serves that the port does not serve yet.
NOT_PORTED = {
    "UNet5b2i3o": "ROADMAP Queue 1 item 4 (5-block pack-exhausted tail)",
    "UNetSPSmall": "ROADMAP Queue 1 item 4 (5-block pack-exhausted tail)",
}


def conv_operands(sd, prefix: str, conv_idx: int, dtype, device):
    """K1 / K5 operands ``(w, bias)`` of the conv unit at
    ``prefix.conv_idx`` (its BatchNorm at ``conv_idx + 1``)."""
    bn = conv_idx + 1
    w, b = kc.fold_conv_unit(
        sd[f"{prefix}.{conv_idx}.weight"], sd.get(f"{prefix}.{conv_idx}.bias"),
        sd[f"{prefix}.{bn}.weight"], sd[f"{prefix}.{bn}.bias"],
        sd[f"{prefix}.{bn}.running_mean"], sd[f"{prefix}.{bn}.running_var"],
        dtype,
    )
    return w.to(device), b.to(device)


def upconv_operands(sd, j: int, ca: Optional[int], dtype, device):
    """K3 operands ``(wa, wb, wone, bias)`` of decoder block ``j`` (its
    convT fused with its first conv unit); ``ca``: channels of operand a
    when the block input is ``cat(a, skip)``."""
    p = f"u_blocks.{j}.block"
    ops = ku.prepare_upconv(
        sd[f"{p}.0.weight"], sd[f"{p}.0.bias"], sd[f"{p}.1.weight"],
        sd.get(f"{p}.1.bias"), sd[f"{p}.2.weight"], sd[f"{p}.2.bias"],
        sd[f"{p}.2.running_mean"], sd[f"{p}.2.running_var"], ca, dtype,
    )
    return tuple(None if t is None else t.to(device) for t in ops)


def build_predict(
    model_class: str,
    state_dict: Dict[str, torch.Tensor],
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    plain: bool = False,
    record: Optional[Callable[[torch.Tensor], None]] = None,
    sparse: int = 0,
) -> Callable:
    """Build ``predict(images)`` for ``(B, D, H, W, C)`` inputs.

    :param state_dict: the port's model weights (``checkpoint.load_any``).
    :param device: ``None``/``"cuda"`` (the default: raises without a
        card) or ``"cpu"``.
    :param plain: run the plain PyTorch versions of K1-K3 on ``device``.
    :param record: called on every tensor the JAX engine passes through its
        ``halo_fn`` hook, in the same order (``ctunet_tpu/engine.py:536-615``):
        the entry, then per encoder level unit 0, unit 1 and the pool, then
        per decoder level the fused upconv output and unit 1. Dense
        ``(D, H, W, C)`` tensors without the JAX layout's ones channel; the
        int8 engine calibrates on this stream (``engine_q.calibrate``).
    :param sparse: generic family only. Non-zero routes every conv unit
        through K6
        (``conv3d_bias_act`` with the ReLU on and the folded bias) instead
        of K1, as the JAX engine's ``sparse`` sends them to ``conv3d_chain``
        (``ctunet_tpu/engine.py:170-185``). There the number is the group
        height of a constant-region skip, a TPU scheduling choice that
        changes no value; here any non-zero value selects the route.
    :returns: ``predict`` -> ``(full, flap)``, each ``(B, D, H, W, 2)`` in
        ``compute_dtype`` (double head), or ``(B, D, H, W, 3)``; for the
        legacy family ``(B, D, H, W, 2)`` softmax probabilities.
    """
    if model_class in NOT_PORTED:
        raise NotImplementedError(
            f"{model_class} is not served by the PyTorch port yet: "
            f"{NOT_PORTED[model_class]}")
    cfg = ENGINE_CONFIGS[model_class]
    device = resolve_device(device)
    if cfg["family"] == "legacy":
        if record is not None or sparse:
            raise NotImplementedError(
                "record and sparse serve the generic family's int8 "
                "calibration and K6 route; the legacy engine takes neither")
        return build_legacy_predict(state_dict, compute_dtype, device, plain)
    conv = kc.conv3d_bn_relu_plain if plain else kc.conv3d_bn_relu
    if sparse:
        k6 = kc.conv3d_bias_act_plain if plain else kc.conv3d_bias_act
        conv = lambda h, w, b: k6(h, w, b, True)  # noqa: E731
    pool = kc.maxpool2_plain if plain else kc.maxpool2
    upconv = ku.upconv_bn_relu_plain if plain else ku.upconv_bn_relu

    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    n = cfg["n_blocks"]
    enc = [[conv_operands(sd, f"d_blocks.{i}.block", c, compute_dtype,
                          device) for c in (0, 3)] for i in range(n)]
    # decoder block j's input is cat(previous block output, skip) for j > 0
    dec = []
    for j in range(n):
        ca = None if j == 0 else int(sd[f"u_blocks.{j - 1}.block.4.weight"]
                                     .shape[0])
        dec.append((upconv_operands(sd, j, ca, compute_dtype, device),
                    conv_operands(sd, f"u_blocks.{j}.block", 4,
                                  compute_dtype, device)))
    lk = sd["last_conv.weight"][:, :, 0, 0, 0].t()  # (Ca+Cb, out)
    ca_head = int(sd[f"u_blocks.{n - 1}.block.4.weight"].shape[0])
    lka = lk[:ca_head].to(device, compute_dtype).contiguous()
    lkb = lk[ca_head:].to(device, compute_dtype).contiguous()
    lb = sd["last_conv.bias"].to(device, compute_dtype)
    m_full = torch.tensor(M_FULL, device=device)
    m_flap = torch.tensor(M_FLAP, device=device)
    b_flap = torch.tensor(B_FLAP, device=device)

    def head(a, b):
        # in f32 these are full-f32 GEMMs on the card as long as the
        # caller leaves torch.backends.cuda.matmul.allow_tf32 at its
        # default (False); the engine sets no global flag
        lc = a @ lka + b @ lkb + lb
        out = torch.sigmoid(lc.float())
        if cfg["head"] is None:
            return out.to(compute_dtype)
        return ((out @ m_full).to(compute_dtype),
                (out @ m_flap + b_flap).to(compute_dtype))

    def forward_one(x: torch.Tensor):
        """One ``(D, H, W, C)`` volume through the kernels."""
        if any(s % 2 ** n for s in x.shape[:3]):
            raise ValueError(f"spatial shape {tuple(x.shape[:3])} must "
                             f"divide by {2 ** n} (pad the volume)")
        rec = record if record is not None else (lambda t: t)
        h = x.to(compute_dtype).contiguous()
        rec(h)
        skips = []
        for (w0, b0), (w1, b1) in enc:
            h = conv(h, w0, b0)
            rec(h)
            h = conv(h, w1, b1)
            rec(h)
            skips.append(h)
            h = pool(h)
            rec(h)
        a, b = h, None
        for idx, ((wa, wb, wone, bu), (w1, b1)) in enumerate(dec):
            a = upconv(a, b, wa, wb, wone, bu)
            rec(a)
            a = conv(a, w1, b1)
            rec(a)
            b = skips[n - 1 - idx]
        return head(a, b)

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        if images.device != device:
            raise ValueError(f"images on {images.device}, engine on {device}")
        outs = [forward_one(images[i]) for i in range(images.shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    return predict


def build_legacy_predict(state_dict: Dict[str, torch.Tensor],
                         compute_dtype: torch.dtype, device: torch.device,
                         plain: bool = False) -> Callable:
    """The legacy k=5 engine (``_build_legacy_predict``,
    ``ctunet_tpu/engine.py:766-828``) on K5, K2 and K7a/K7b; called by
    :func:`build_predict` for ``recAE_v2_fixed`` and ``UNet4_2IC``.

    :returns: ``predict`` -> ``(B, D, H, W, 2)`` softmax probabilities in
        ``compute_dtype``.
    """
    conv = kc.conv3d5_bias_act_plain if plain else kc.conv3d5_bias_act
    pool = kc.maxpool2_plain if plain else kc.maxpool2
    up1 = kt.convt_k2s2_plain if plain else (
        lambda a, b, wa, wb, bias: kt.convt_k2s2(a, wa, bias))
    up2 = kt.convt_k2s2_plain if plain else (
        lambda a, b, wa, wb, bias: kt.convt_k2s2_dual(a, b, wa, wb, bias))

    sd = {k: v.detach().cpu() for k, v in state_dict.items()}

    def units(name, idxs):
        return [conv_operands(sd, name, c, compute_dtype, device)
                for c in idxs]

    enc = [units(f"dblock{i + 1}", (0, 3)) for i in range(4)]
    center = units("cblock_center", (0, 3))
    dec = []
    for i in range(4):
        name = f"ublock{i + 1}"
        # block i > 0 upsamples cat(previous block output, skip)
        ca = None if i == 0 else int(sd[f"ublock{i}.4.weight"].shape[0])
        ops = kt.convt_weights(sd[f"{name}.0.weight"], sd[f"{name}.0.bias"],
                               ca, compute_dtype)
        dec.append((tuple(None if t is None else t.to(device) for t in ops),
                    units(name, (1, 4))))
    lk = sd["last_conv.weight"][:, :, 0, 0, 0].t()  # (Ca+Cb, 2)
    ca_head = int(sd["ublock4.4.weight"].shape[0])
    lka = lk[:ca_head].to(device, compute_dtype).contiguous()
    lkb = lk[ca_head:].to(device, compute_dtype).contiguous()
    lb = sd["last_conv.bias"].to(device, compute_dtype)

    def forward_one(x: torch.Tensor) -> torch.Tensor:
        """One ``(D, H, W, C)`` volume through the kernels."""
        if any(s % 16 for s in x.shape[:3]):
            raise ValueError(f"spatial shape {tuple(x.shape[:3])} must "
                             "divide by 16 (pad the volume)")
        h = x.to(compute_dtype).contiguous()
        skips = []
        for (w0, b0), (w1, b1) in enc:
            h = conv(conv(h, w0, b0), w1, b1)
            skips.append(h)
            h = pool(h)
        (w0, b0), (w1, b1) = center
        a, b = conv(conv(h, w0, b0), w1, b1), None
        for i, ((wa, wb, bu), ((w0, b0), (w1, b1))) in enumerate(dec):
            a = (up1 if b is None else up2)(a, b, wa, wb, bu)
            a = conv(conv(a, w0, b0), w1, b1)
            b = skips[3 - i]
        lc = a @ lka + b @ lkb + lb  # full f32 in f32, as the generic head
        return torch.softmax(lc.float(), -1).to(compute_dtype)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        if images.device != device:
            raise ValueError(f"images on {images.device}, engine on {device}")
        return torch.stack([forward_one(images[i])
                            for i in range(images.shape[0])])

    return predict
