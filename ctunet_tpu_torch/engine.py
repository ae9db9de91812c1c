"""Serving engine: the U-Net forward on the port's Hopper kernels, in bf16
or f32 (``compute_dtype``).

Counterpart of ``ctunet_tpu/engine.py::build_predict`` (``:279-636``) for
the generic 4- and 5-block families and ``_build_legacy_predict``
(``:766-828``) for the legacy k=5 family. Weights are prepared once, at
build time, and the forward runs per volume on dense channels-last
tensors.

Generic family (UNetSP, UNetDO, UNet4b2i3o, UNet4b1i3o; 5 blocks:
UNetSPSmall, UNet5b2i3o):

- encoder level i: K1 (conv unit 0) -> K1 (conv unit 1) -> K2 (pool);
- decoder level idx: K3 (ConvT(k2,s2) of ``cat(a, skip)`` fused with conv
  unit 0, from the half-resolution operands) -> K1 (conv unit 1);
- head: the 1x1 ``last_conv`` weight-split over (last decoder output,
  first skip) as two small matmuls in the compute dtype, sigmoid in f32,
  then the two 3x2 maps of the double-output head (``engine.py:405-484``),
  inside the span ``ctunet.engine.heads`` (``utils/profiling.py``);
  ``double_softmax`` (UNetSPSmall) softmaxes both maps of the f32 sigmoid
  and returns them in f32, as the JAX engine's packed head does
  (``engine.py:463-484``: the head it takes whenever the last decoder
  level and the first skip share a pack, at every shape ``Model`` serves).

For UNetSP at 224x304x304 that is 12 K1, 4 K2 and 4 K3 launches per
volume, for UNetSPSmall 15 K1, 5 K2 and 5 K3; the upconv composite is
built in f64, rounded to f32 and then to the compute dtype. The JAX
engine's pack-exhausted tail (one standard-space pool and a decoder
repack, ``engine.py:549-556, 570-575``) lays the 5-block levels out in TPU
lanes; on dense channels-last volumes it is K2 and K3 at one more level.

Legacy family (recAE_v2_fixed, UNet4_2IC; :func:`build_legacy_predict`):

- encoder level i: K5 -> K5 -> K2; the live center: K5 -> K5;
- decoder block 1: K7a (ConvT(k2,s2) of the center output) -> K5 -> K5;
  blocks 2..4: K7b (ConvT of ``cat(previous block output, skip)``, never
  concatenated) -> K5 -> K5;
- head: ``last_conv`` weight-split over (block 4 output, first skip) as
  two small matmuls plus the bias in the compute dtype, softmax in f32
  (``engine.py:814-820``).

That is 18 K5, 4 K2, 1 K7a and 3 K7b launches per volume. The encoder
(with the centre) and the decoder each run inside a span timed on the
device (``ctunet.engine.encoder``, ``ctunet.engine.decoder``) beside the
heads' span. Weight rounding follows the JAX engine: conv weights are
folded with BN in f32 and then cast to the compute dtype, biases
(``conv_bias * scale + bn_shift`` where the conv has a bias) stay f32;
ConvT weights are cast once.

Both dtypes run on the card, as the JAX engine runs its Pallas kernels in
``compute_dtype``: in bf16 the convs and upsamplings launch the
tensor-core kernels (``conv3d_tc``, ``upconv_tc``); in f32 ``conv3d_f32``
(K1), ``conv3d5_f32`` (K5), ``upconv_f32`` (K3) and ``convt_f32``
(K7a/K7b) launch the split-tf32 tensor-core kernels (``conv3d_tc_f32``,
``upconv_tc_f32``), all f32-accurate; K2 in either dtype launches the
row-streaming pool (``maxpool2_rows``). The heads' matmuls run in the compute dtype through
``torch.matmul``.

Several ranks (``parallel/``): :func:`build_sharded_predict` splits one
volume's depth over the spatial ranks of a mesh (the neighbours' edge
planes joined on before every K1 and K3, their outputs cropped), and
:func:`build_dp_predict` serves each data rank's slice of a batch.

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
from .parallel.halo import crop, join
from .utils import profiling

# the span around the heads (the 1x1 last conv and the double head's maps),
# timed on the device too (utils/profiling.py)
HEADS_SPAN = "ctunet.engine.heads"
# the legacy engine's spans beside the heads', timed on the device too: the
# four encoder levels and the centre, then the four decoder blocks
ENCODER_SPAN = "ctunet.engine.encoder"
DECODER_SPAN = "ctunet.engine.decoder"

# Structural config per model (``ctunet_tpu/engine.py:37-48``).
ENGINE_CONFIGS = {
    "UNet4b2i3o": dict(n_blocks=4, head=None, family="generic"),
    "UNet5b2i3o": dict(n_blocks=5, head=None, family="generic"),
    "UNet4b1i3o": dict(n_blocks=4, head=None, family="generic"),
    "UNetSP": dict(n_blocks=4, head="double", family="generic"),
    "UNetSPSmall": dict(n_blocks=5, head="double_softmax",
                        family="generic"),
    "UNetDO": dict(n_blocks=4, head="double", family="generic"),
    "recAE_v2_fixed": dict(n_blocks=4, head="softmax", family="legacy"),
    "UNet4_2IC": dict(n_blocks=4, head="softmax", family="legacy"),
}


def supports(model_class: str) -> bool:
    """Whether an engine serves ``model_class`` (``engine.supports``)."""
    return model_class in ENGINE_CONFIGS


def pool_multiple(model_class: str) -> int:
    """Spatial divisibility a model needs, ``2 ** n_blocks``: 32 for the
    5-block family, 16 for the rest (``ctunet_tpu/trainer.py:53-56``)."""
    cfg = ENGINE_CONFIGS.get(model_class)
    return 2 ** cfg["n_blocks"] if cfg else 16


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


def double_head(out: torch.Tensor, head: Optional[str], compute_dtype,
                m_full, m_flap, b_flap):
    """The heads on the f32 sigmoid ``out`` ``(..., 3)``: itself (``None``)
    or the two 3x2 maps (``double``) in ``compute_dtype``, or both maps
    softmaxed in f32 (``double_softmax``; ``ctunet_tpu/engine.py:472-484``
    and ``engine_q.py:628-648``, both in f32)."""
    if head is None:
        return out.to(compute_dtype)
    full, flap = out @ m_full, out @ m_flap + b_flap
    if head == "double_softmax":
        return torch.softmax(full, -1), torch.softmax(flap, -1)
    return full.to(compute_dtype), flap.to(compute_dtype)


def build_predict(
    model_class: str,
    state_dict: Dict[str, torch.Tensor],
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    plain: bool = False,
    record: Optional[Callable[[torch.Tensor], None]] = None,
    sparse: int = 0,
    halo: Optional[Callable] = None,
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
    :param halo: generic family only. The volume is one depth slab of a
        larger one: ``halo(slabs)`` returns each slab's neighbouring planes
        (``parallel.halo_exchange_many``), joined on before every K1/K6
        input and both K3 inputs, their output planes cropped after
        (:func:`build_sharded_predict`).
    :returns: ``predict`` -> ``(full, flap)``, each ``(B, D, H, W, 2)`` in
        ``compute_dtype`` (double head) or softmax probabilities in f32
        (``double_softmax``), or ``(B, D, H, W, 3)``; for the legacy family
        ``(B, D, H, W, 2)`` softmax probabilities.
    """
    if model_class not in ENGINE_CONFIGS:
        raise KeyError(f"no engine config for {model_class}; one of "
                       f"{sorted(ENGINE_CONFIGS)}")
    cfg = ENGINE_CONFIGS[model_class]
    device = resolve_device(device)
    if cfg["family"] == "legacy":
        if record is not None or sparse or halo is not None:
            raise NotImplementedError(
                "record, sparse and halo serve the generic family's int8 "
                "calibration, K6 route and depth sharding; the legacy "
                "engine takes none of them")
        return build_legacy_predict(state_dict, compute_dtype, device, plain)
    conv = kc.conv3d_bn_relu_plain if plain else kc.conv3d_bn_relu
    if sparse:
        k6 = kc.conv3d_bias_act_plain if plain else kc.conv3d_bias_act
        conv = lambda h, w, b: k6(h, w, b, True)  # noqa: E731
    pool = kc.maxpool2_plain if plain else kc.maxpool2
    upconv = ku.upconv_bn_relu_plain if plain else ku.upconv_bn_relu
    if halo is not None:
        conv, upconv = _halo_conv(conv, halo), _halo_upconv(upconv, halo)

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
    cuda = device.type == "cuda"

    def head(a, b):
        # in f32 these are full-f32 GEMMs on the card as long as the
        # caller leaves torch.backends.cuda.matmul.allow_tf32 at its
        # default (False); the engine sets no global flag
        with profiling.span(HEADS_SPAN, device=cuda):
            lc = a @ lka + b @ lkb + lb
            return double_head(torch.sigmoid(lc.float()), cfg["head"],
                               compute_dtype, m_full, m_flap, b_flap)

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


def _halo_conv(conv: Callable, halo: Callable) -> Callable:
    """A K1/K6 on a depth slab: the neighbours' edge planes joined on, the
    output planes they give cropped; at a volume edge the kernel's own zero
    fill stands (SAME padding)."""

    def run(h, w, b):
        hh = halo([h])[0]
        return crop(hh, conv(join(hh, h), w, b))

    return run


def _halo_upconv(upconv: Callable, halo: Callable) -> Callable:
    """K3 on depth slabs: both half-resolution operands joined with their
    neighbours' planes (one exchange), the two output planes of each joined
    plane cropped. Nothing is padded at a volume edge: a zero plane there
    would come out as the ConvT's bias, not as SAME padding."""

    def run(a, b, wa, wb, wone, bias):
        slabs = [a] if b is None else [a, b]
        hs = halo(slabs)
        j = [join(hh, t) for hh, t in zip(hs, slabs)]
        return crop(hs[0], upconv(j[0], j[1] if b is not None else None,
                                  wa, wb, wone, bias), 2)

    return run


def build_sharded_predict(model_class: str,
                          state_dict: Dict[str, torch.Tensor], mesh,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          device=None) -> Callable:
    """One volume's depth split over the spatial ranks of ``mesh``
    (``ctunet_tpu/engine.py:639-700``): each rank runs the kernel engine
    of :func:`build_predict` on its depth slab, with the neighbouring
    ranks' edge planes joined on before every K1 input and both K3 inputs
    and their output planes cropped (``parallel/halo.py``), at the points
    where the JAX engine calls its ``halo_fn``. Pools need none: each
    slab's depth divides by ``2 ** n_blocks``.

    Returns ``predict(images)``: ``images`` ``(B, D, H, W, C)``, the same
    on every rank of the spatial group, on the host or the device, with D
    dividing by ``shards * 2 ** n_blocks``; only this rank's slab is moved
    to ``device``. It returns this rank's depth slab of the outputs, planes
    ``index * D / shards ..``. Every rank of the group must call it: the
    exchange is a collective. The legacy family raises
    ``NotImplementedError``, as in the JAX package.
    """
    from .parallel.halo import halo_exchange_many

    cfg = ENGINE_CONFIGS[model_class]
    if cfg["family"] != "generic":
        raise NotImplementedError(
            f"the sharded engine serves the generic U-Net family only, not "
            f"{model_class!r} (use build_dp_predict or sliding-window "
            "patches)")
    device = resolve_device(device)
    n, index, group = mesh.spatial, mesh.spatial_index, mesh.spatial_group
    fwd = build_predict(
        model_class, state_dict, compute_dtype, device,
        halo=lambda slabs: halo_exchange_many(slabs, group, n, index))
    multiple = n * 2 ** cfg["n_blocks"]

    def predict(images: torch.Tensor):
        d = images.shape[1]
        if d % multiple:
            raise ValueError(f"depth {d} must divide by shards x pool "
                             f"multiple = {multiple}")
        ds = d // n
        return fwd(images[:, index * ds:(index + 1) * ds].to(device))

    return predict


def build_dp_predict(model_class: str, state_dict: Dict[str, torch.Tensor],
                     mesh, compute_dtype: torch.dtype = torch.bfloat16,
                     device=None, int8_calib: Optional[torch.Tensor] = None
                     ) -> Callable:
    """Batch data-parallel serving over the data ranks of ``mesh``
    (``ctunet_tpu/engine.py:704-760``): each rank serves its slice of the
    batch on its own engine, bf16 or f32, generic or legacy family; no
    collective. With ``int8_calib`` (a ``(D, H, W, C)`` volume, the same on
    every rank) each rank serves the int8 engine
    (``engine_q.build_predict_q``) calibrated on it, so every rank holds
    the same integers; the legacy family then raises ``ValueError``, as in
    the JAX package.

    Returns ``predict(images)``: ``images`` ``(B, D, H, W, C)``, the same
    on every rank, on the host or the device, B dividing by the data ranks;
    only this rank's slice, volumes ``index * B / ranks ..``, is moved to
    ``device`` and served, and its outputs are returned (not the whole
    batch).
    """
    device = resolve_device(device)
    if int8_calib is not None:
        from . import engine_q

        fwd = engine_q.build_predict_q(
            model_class, state_dict, int8_calib.to(device), compute_dtype,
            device)
    else:
        fwd = build_predict(model_class, state_dict, compute_dtype, device)
    n, index = mesh.data, mesh.data_index

    def predict(images: torch.Tensor):
        b = images.shape[0]
        if b % n:
            raise ValueError(f"batch {b} must divide by {n} data ranks")
        per = b // n
        return fwd(images[index * per:(index + 1) * per].to(device))

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
    cuda = device.type == "cuda"

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
        with profiling.span(ENCODER_SPAN, device=cuda):
            for (w0, b0), (w1, b1) in enc:
                h = conv(conv(h, w0, b0), w1, b1)
                skips.append(h)
                h = pool(h)
            (w0, b0), (w1, b1) = center
            a, b = conv(conv(h, w0, b0), w1, b1), None
        with profiling.span(DECODER_SPAN, device=cuda):
            for i, ((wa, wb, bu), ((w0, b0), (w1, b1))) in enumerate(dec):
                a = (up1 if b is None else up2)(a, b, wa, wb, bu)
                a = conv(conv(a, w0, b0), w1, b1)
                b = skips[3 - i]
        with profiling.span(HEADS_SPAN, device=cuda):
            # full f32 in f32, as the generic head
            lc = a @ lka + b @ lkb + lb
            return torch.softmax(lc.float(), -1).to(compute_dtype)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        if images.device != device:
            raise ValueError(f"images on {images.device}, engine on {device}")
        return torch.stack([forward_one(images[i])
                            for i in range(images.shape[0])])

    return predict
