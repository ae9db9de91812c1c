"""Calibrated int8 serving engine: the U-Net forward on the int8 kernels.

Counterpart of ``ctunet_tpu/engine_q.py`` (post-training quantization with
zero-point activations) for the generic 4- and 5-block families, on dense
channels-last tensors and the port's kernels:

- encoder unit: K1q (``conv3d_q_requant``, zp mode), pool: K2q
  (``maxpool2_q``), decoder: K3q (``upconv_q_requant``, the composite
  ConvT(k2,s2) o conv unit 0) then K1q (unit 1) -- 12 K1q, 4 K2q and 4 K3q
  launches per volume for UNetSP, 15, 5 and 5 for UNetSPSmall (whose
  level-4 pool is the JAX engine's standard-space "std" pool: the same
  K2q on dense tensors);
- activations are stored as ``q = a/s - 128`` (int8, 255 levels of a
  post-ReLU value), per-channel scales ``s = max/255`` from one calibration
  forward of the bf16 engine (:func:`calibrate`); weights fold the BN scale
  and the input scales, then quantize per output channel to [-127, 127];
  the zero-point correction ``128 * sum(q_w) / k`` is folded into the
  requant bias from the QUANTIZED weights (``engine_q.py:142-153``);
- the head dequantizes by folding the per-channel scales (and their
  zero-point terms) into the 1x1 ``last_conv`` weights and bias, in f32;
  the entry quantization, the dequant/quant affines of the mixed-precision
  splits and the head are plain torch on the device, as the JAX package
  computes them in XLA outside Pallas.
- K1q runs ``conv3d_tc_q`` and K3q ``upconv_tc_q``, the int8 tensor-core
  kernels, at every ``split_taps`` and ``sparse`` setting: the JAX forms
  these select compute the same integers. The float units of the
  mixed-precision splits (``bf16_head``, ``bf16_tail``) run K1/K2/K3 in
  ``compute_dtype``: the tensor-core kernels in bf16, the f32 kernels in
  f32 (``engine.py``).

The JAX chain layout carries a ones lane in every tensor (q = 127 inside
the volume, the -128 fill outside); here it exists only inside K3q, whose
ones row is the quantized convT-bias response. Scales keep the JAX
package's ``export_scales`` format, ones lanes included (``_Q1``), so
scales and AdaQuant overrides pass between the two packages unchanged.

Quantized operands are built in numpy f32 in the JAX order
(``engine_q.py:154-173, 200-247``), so they are bit-equal to the JAX values
before packing; given the same scales and overrides the int8 activations
are equal too (``tests/test_torch_port_int8_engine.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import engine
from .device import resolve_device
from .models.variants import B_FLAP, M_FLAP, M_FULL
from .ops.kernels import conv3d as kc
from .ops.kernels import upconv as ku

_EPS = 1e-8
_EPS_BN = 1e-5
_QMAX = 255.0
_Q1 = np.float32(1.0 / _QMAX)  # scale of an exact ones channel (q = 127)


class Unsupported(ValueError):
    """A model or shape the int8 engine does not serve. Raised while
    planning, before any kernel launch; ``Model`` then falls back to the
    next serving mode (AdaQuant -> plain int8 -> bf16)."""


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy(), np.float32)


def unit_np(sd, prefix: str, conv_idx: int):
    """One Conv+BN(+ReLU) unit as ``ctunet_tpu.engine._FusedUnit`` holds it:
    flax-layout ``w`` ``(3, 3, 3, Ci, Co)``, BN ``scale`` and folded
    ``bias`` (numpy f32, ``conv3d.py:97-103``)."""
    w = _np(sd[f"{prefix}.{conv_idx}.weight"]).transpose(2, 3, 4, 1, 0)
    bn = f"{prefix}.{conv_idx + 1}"
    cb = sd.get(f"{prefix}.{conv_idx}.bias")
    cb = np.zeros(w.shape[-1], np.float32) if cb is None else _np(cb)
    inv = _np(sd[f"{bn}.weight"]) / np.sqrt(_np(sd[f"{bn}.running_var"])
                                            + _EPS_BN)
    bn_b = _np(sd[f"{bn}.bias"]) - _np(sd[f"{bn}.running_mean"]) * inv
    return np.ascontiguousarray(w), inv, cb * inv + bn_b


def upconv_np(sd, j: int):
    """Decoder block ``j``'s ConvTranspose(k2, s2) in the flax
    transpose-kernel layout ``(2, 2, 2, Ct, Cin)`` and its bias."""
    p = f"u_blocks.{j}.block.0"
    kk = _np(sd[f"{p}.weight"]).transpose(2, 3, 4, 1, 0)
    return np.ascontiguousarray(kk), _np(sd[f"{p}.bias"])


def _grid(w_s: np.ndarray):
    """Per-output-channel int8 grid ``k = 127 / max|w_s|`` (1 for an
    all-zero channel) and the round-to-nearest integers."""
    amax = np.abs(w_s).max(axis=(0, 1, 2, 3))
    k = np.where(amax > 0, 127.0 / np.maximum(amax, _EPS), 1.0)
    return k, np.clip(np.round(w_s * k[None, None, None, None, :]), -127, 127)


def quant_conv(w, scale, bias, s_in, s_out, override=None):
    """int8 operands of one conv unit (``engine_q._quant_conv``, dense).

    :param w, scale, bias: :func:`unit_np`.
    :param s_in, s_out: per-channel activation scales, ones lanes included
        (the export format); the ones lanes carry zero weights and drop out.
    :param override: AdaQuant ``{"q", "k", "db"}`` for the real channels.
    :returns: ``(q_w, k, scale_ref, bias_ref)`` in numpy: int-valued f32
        ``(3, 3, 3, Ci, Co)``, the grid, and the f32 requant scale and bias
        with the zero-point correction from the quantized weights.
    """
    ci, co = w.shape[3], w.shape[4]
    w_eff = w * scale[None, None, None, None, :]
    w_s = w_eff * s_in[:ci].astype(np.float32)[None, None, None, :, None]
    k, q_w = _grid(w_s)
    bias = bias.copy()
    if override is not None:
        q_w[...] = override["q"]
        k = np.asarray(override["k"], np.float32).copy()
        bias = bias + np.asarray(override["db"], np.float32)
    corr = 128.0 * q_w.sum(axis=(0, 1, 2, 3)) / k  # exact zp correction
    scale_ref = (1.0 / (k * s_out[:co])).astype(np.float32)
    bias_ref = ((bias + corr) / s_out[:co]).astype(np.float32)
    return q_w, k, scale_ref, bias_ref


# R indices (per dimension) of the two composite taps that reach an output
# voxel of parity 0 and 1 (``upconv.py::_r_index``).
_PARITY_TAPS = ((3, 1), (2, 0))


def parity_bias(r_q: np.ndarray, base: np.ndarray,
                scale_ref: np.ndarray) -> np.ndarray:
    """K3q's requant bias, one f32 row per output parity
    ``4*pz + 2*py + px``: ``base + 128 * colsum * scale_ref`` with the
    column sums of the quantized composite ``r_q`` ``(4, 4, 4, Cin, Co)``
    over the 8 taps that reach that parity (``engine_q.py:219-247``)."""
    rows = []
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                sub = r_q[list(_PARITY_TAPS[pz])][:, list(_PARITY_TAPS[py])][
                    :, :, list(_PARITY_TAPS[px])]
                colsum = sub.sum(axis=(0, 1, 2, 3))  # integer-valued f32
                rows.append((base + 128.0 * colsum * scale_ref).astype(
                    np.float32))
    return np.stack(rows)


def quant_upconv(kk, bb, unit0, ca: Optional[int], s_a, s_b, s_out,
                 override=None):
    """int8 composite upsample+conv operands (``engine_q._quant_upconv``,
    dense).

    :param kk, bb: :func:`upconv_np`; ``unit0``: :func:`unit_np` of the
        block's first conv unit; ``ca``: operand a's channels when the
        block input is ``cat(a, skip)``, else None.
    :param s_a, s_b, s_out: activation scales with ones lanes (``s_b`` None
        for one operand).
    :returns: ``(r_q, k, scale_ref, bias8)``: the quantized composite
        ``(4, 4, 4, Cin_aug, Co)`` (rows ``[a | ones | b | zero]``, int-valued
        f32), its grid, the f32 requant scale ``(Co,)`` and one f32 bias row
        per output parity ``4*pz + 2*py + px`` ``(8, Co)``, each with the
        zero-point correction over the 8 taps reaching that parity.
    """
    w0, s0, b0 = unit0
    co = w0.shape[-1]
    kT_aug, _ = ku.augment_upconv_kernel(kk, bb, ca)
    s_in = s_a if ca is None else np.concatenate([s_a, s_b])
    # the JAX build adds conv unit 0's ones OUTPUT column (zero weights,
    # scale 1, bias 1): kept here so every array has the JAX shape
    w0a = np.concatenate([w0, np.zeros(w0.shape[:4] + (1,), np.float32)], 4)
    s0a = np.concatenate([s0, np.ones(1, np.float32)])
    b0a = np.concatenate([b0, np.ones(1, np.float32)])
    r = ku.composite_response(kT_aug, w0a, s0a)
    r_s = r * s_in.astype(np.float32)[None, None, None, :, None]
    k, r_q = _grid(r_s)
    if override is not None:
        r_q[..., :co] = override["q"]
        k[:co] = override["k"]
        b0a[:co] = b0a[:co] + np.asarray(override["db"], np.float32)
    scale_ref = (1.0 / (k * s_out)).astype(np.float32)
    bias8 = parity_bias(r_q, (b0a / s_out).astype(np.float32), scale_ref)
    return r_q[..., :co], k[:co], scale_ref[:co], bias8[:, :co].copy()


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column linear-interpolation quantile of ``a`` ``(N, C)`` (the
    ``jnp.quantile`` default) by ``kthvalue``: ``torch.quantile`` refuses
    more than 2^24 elements, and one channel at 224x304x304 has 20.7 M."""
    n = a.shape[0]
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    cols = a.t().contiguous()
    v_lo = torch.kthvalue(cols, lo + 1, dim=1).values
    v_hi = torch.kthvalue(cols, hi + 1, dim=1).values
    return v_lo + (v_hi - v_lo) * float(pos - lo)


def calibrate(model_class: str, state_dict, calib_volume: torch.Tensor,
              quantile: float = 1.0, device=None,
              plain: bool = False) -> List[np.ndarray]:
    """One bf16 engine forward over ``calib_volume``, recording the
    per-channel |activation| maxima of every tensor the engine's ``record``
    hook sees, in production order (``engine_q.calibrate``).

    :param calib_volume: ``(D, H, W, C)``: a volume, a foreground window
        or, in patch serving, the central patch (the JAX package's
        ``calibrate`` also takes a ``(K, ...)`` stack, which its serving
        loop never passes).
    :param quantile: 1.0 records maxima; below 1 the per-channel |t|
        quantile, floored at max/64 (``engine_q.py:104-113``). The port's
        quantile runs over the volume's voxels only; the JAX one also
        counts the chain layout's halo zeros and takes it per packed lane
        before reducing to channels, so clipped scales differ between the
        two (by how much is pinned in the tests).
    :returns: one f32 array ``(C,)`` per recorded tensor.
    """
    device = resolve_device(device)
    records: List[np.ndarray] = []

    def rec(t: torch.Tensor) -> None:
        a = t.abs().float().reshape(-1, t.shape[-1])
        r = a.amax(0)
        if quantile < 1.0:
            # a mostly-zero channel would collapse its quantile to ~0 and
            # saturate every real value: 64x caps the clip
            r = torch.maximum(_quantile(a, quantile), r / 64.0)
        records.append(r.cpu().numpy().astype(np.float32))

    fwd = engine.build_predict(model_class, state_dict, torch.bfloat16,
                               device, plain=plain, record=rec)
    fwd(calib_volume.to(device)[None])
    return records


def chan_scales(rec: np.ndarray) -> np.ndarray:
    """Activation scales from a per-channel max record: s = max/255."""
    return (np.maximum(rec, _EPS) / _QMAX).astype(np.float32)


def _ones(s: np.ndarray) -> np.ndarray:
    return np.concatenate([s, [_Q1]]).astype(np.float32)


def build_predict_q(
    model_class: str,
    state_dict: Dict[str, torch.Tensor],
    calib_volume: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    plain: bool = False,
    calib_quantile: float = 1.0,
    bf16_tail: float = 0,
    bf16_head: float = 0,
    round_opt: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    export_scales: Optional[Dict[str, Any]] = None,
    import_scales: Optional[Dict[str, Any]] = None,
    sparse: int = 0,
    split_taps: bool = True,
) -> Callable:
    """Build the int8 ``predict(images)`` for ``(B, D, H, W, C)`` inputs of
    ``calib_volume``'s spatial shape (``engine_q.build_predict_q``).

    :param calib_volume: ``(D, H, W, C)`` on the engine's device;
        calibrated with :func:`calibrate` (one bf16 engine forward in
        every ``compute_dtype``, as the JAX package calibrates) unless
        ``import_scales`` is given.
    :param plain: run the plain PyTorch versions of every kernel.
    :param bf16_tail: final decoder blocks served in ``compute_dtype`` (bf16
        or f32) on the float kernels (``.5``: the last int8 block's unit 1
        only).
    :param bf16_head: leading encoder blocks served in ``compute_dtype``
        (``.5``: the first unit only); a fully-float block's skip reaches
        the head unquantized.
    :param round_opt: AdaQuant overrides (:mod:`quant_opt`), by unit tag.
    :param export_scales: filled with the scales used, JAX export format.
    :param import_scales: scales in that format; skips the calibration.
    :param sparse: the JAX engine's constant-region skip (``sparse_gh`` of
        ``conv3d_chain_q``, ``ctunet_tpu/engine_q.py:343-344``): a TPU
        scheduling choice that changes no integer, so every value serves
        as 0 does.
    :param split_taps: a TPU packing choice (split vs full 27-tap MXU
        matrices, ``conv3d_chain_split`` vs ``conv3d_chain_q``); both give
        the same integers, and the same K1q/K3q kernels serve either value.
    :raises Unsupported: a shape whose pool levels are not all even: the
        JAX plan's refusal (``ctunet_tpu/engine_q.py:386-425``), whose
        encoder needs even D and H at every level and, at pack 1, an even
        packed width, i.e. an even W (packs are powers of two dividing W),
        and whose decoder repack then always re-aligns.
    :returns: ``predict`` -> ``(full, flap)`` in ``compute_dtype`` (double
        head) or in f32 (``double_softmax``), or ``(B, D, H, W, 3)``. It
        carries ``scales`` (the export
        dict), ``round_opt`` and ``layers`` (each unit tag's int8 operands).
    """
    if engine.ENGINE_CONFIGS.get(model_class, {}).get("family") != "generic":
        # the legacy k=5 family has no int8 path (ctunet_tpu's
        # build_predict_q raises a ValueError too): Model serves it in bf16
        raise Unsupported(f"int8 engine: no generic-family config for "
                          f"{model_class}")
    del split_taps, sparse  # each form computes the same integers
    cfg = engine.ENGINE_CONFIGS[model_class]
    device = resolve_device(device)
    n = cfg["n_blocks"]
    shape = tuple(int(s) for s in calib_volume.shape[-4:-1])
    cin0 = int(calib_volume.shape[-1])
    for i in range(n):
        lvl = tuple(s >> i for s in shape)
        if any(s % 2 for s in lvl):
            raise Unsupported(
                f"int8 engine needs even extents at pool level {i} "
                f"({'x'.join(map(str, lvl))}); falling back")

    tail_f = max(0.0, min(float(bf16_tail), float(n)))
    full_tail = int(tail_f)
    half_tail = (tail_f - full_tail) >= 0.5 and full_tail < n
    switch = n - full_tail  # first decoder idx served fully in float
    head_units = int(round(max(0.0, min(float(bf16_head), float(n))) * 2))
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    d_units = [[unit_np(sd, f"d_blocks.{i}.block", c) for c in (0, 3)]
               for i in range(n)]
    u_units = [[unit_np(sd, f"u_blocks.{j}.block", c) for c in (1, 4)]
               for j in range(n)]
    up_raw = [upconv_np(sd, j) for j in range(n)]

    records = None
    if import_scales is None:
        records = calibrate(model_class, sd, calib_volume, calib_quantile,
                            device, plain)
    cursor = iter(records or ())

    def tag_scales(tag: str, c: int) -> np.ndarray:
        """Output scales (ones lane last) of one produced tensor."""
        if records is None:
            v = import_scales[tag]
            s = np.array(v[1] if isinstance(v, tuple) else v, np.float32)
            assert s.shape == (c + 1,), (tag, s.shape, c)
        else:
            s = _ones(chan_scales(next(cursor)))
        s[-1] = _Q1
        return s

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    def conv_ops(unit, s_in, s_out, tag):
        q_w, _, s, b = quant_conv(*unit, s_in, s_out, ropt.get(tag))
        return dev(q_w, torch.int8), dev(s), dev(b)

    if records is None:
        s_entry = np.array(import_scales["entry"], np.float32)
        assert s_entry.shape == (cin0 + 1,)
    else:
        s_entry = _ones(chan_scales(next(cursor)))
    ropt = round_opt or {}
    scales: Dict[str, Any] = {"entry": s_entry}
    layers: Dict[str, tuple] = {}
    enc_s, skips_s = [], []
    s_cur = s_entry
    for i in range(n):
        s_u0 = tag_scales(f"d{i}.0", d_units[i][0][0].shape[-1])
        s_u1 = tag_scales(f"d{i}.1", d_units[i][1][0].shape[-1])
        for j, (s_in, s_out) in enumerate(((s_cur, s_u0), (s_u0, s_u1))):
            tag = f"d{i}.{j}"
            scales[tag] = (s_in, s_out)
            if 2 * i + j < head_units:
                layers[tag] = engine.conv_operands(
                    sd, f"d_blocks.{i}.block", 3 * j, compute_dtype, device)
            else:
                layers[tag] = conv_ops(d_units[i][j], s_in, s_out, tag)
        enc_s.append((s_u0, s_u1))
        skips_s.append(s_u1)
        if records is not None:
            next(cursor)  # the pool output: scales unchanged
        s_cur = s_u1

    s_a_list, s_up_list = [], []
    s_a = s_cur
    for idx in range(n):
        i = n - 1 - idx
        s_a_list.append(s_a)
        ca = None if idx == 0 else u_units[idx - 1][1][0].shape[-1]
        s_b = None if idx == 0 else skips_s[i + 1]
        s_up = tag_scales(f"u{idx}.0", u_units[idx][0][0].shape[-1])
        s_u1 = tag_scales(f"u{idx}.1", u_units[idx][1][0].shape[-1])
        s_up_list.append(s_up)
        scales[f"u{idx}.0"] = s_up
        scales[f"u{idx}.1"] = (s_up, s_u1)
        if idx < switch:
            r_q, _, s2, b8 = quant_upconv(*up_raw[idx], u_units[idx][0], ca,
                                          s_a, s_b, s_up,
                                          ropt.get(f"u{idx}.0"))
            wa, wone, wb = ku.split_response(torch.from_numpy(r_q), ca)
            layers[f"u{idx}.0"] = (
                dev(wa, torch.int8), None if wb is None else dev(wb, torch.int8),
                dev(wone, torch.int8), dev(s2), dev(b8))
        else:
            layers[f"u{idx}.0"] = engine.upconv_operands(
                sd, idx, ca, compute_dtype, device)
        if idx < switch and not (half_tail and idx == switch - 1):
            layers[f"u{idx}.1"] = conv_ops(u_units[idx][1], s_up, s_u1,
                                           f"u{idx}.1")
        else:
            layers[f"u{idx}.1"] = engine.conv_operands(
                sd, f"u_blocks.{idx}.block", 4, compute_dtype, device)
        s_a = s_u1
    if records is not None:
        assert next(cursor, None) is None, "calibration stream not consumed"
    if export_scales is not None:
        export_scales.update(scales)

    # ---- head: the 1x1 last_conv with the dequant scales folded in ------
    lc_k = _np(sd["last_conv.weight"])[:, :, 0, 0, 0].T  # (Ca+Cb, out)
    lc_b = _np(sd["last_conv.bias"])
    ca_f = u_units[-1][1][0].shape[-1]
    cb_f = d_units[0][1][0].shape[-1]
    m_a, m_b, bias3 = lc_k[:ca_f], lc_k[ca_f:ca_f + cb_f], lc_b
    if tail_f == 0:
        # int8 operand a = (q + 128) * s: fold s, and owe 128 * colsum
        m_a = m_a * s_a[:ca_f, None]
        bias3 = bias3 + 128.0 * m_a.sum(axis=0)
    if head_units < 2:
        m_b = m_b * skips_s[0][:cb_f, None]
        bias3 = bias3 + 128.0 * m_b.sum(axis=0)
    m_a, m_b, bias3 = dev(m_a), dev(m_b), dev(bias3)
    m_full, m_flap, b_flap = (torch.tensor(m, device=device)
                              for m in (M_FULL, M_FLAP, B_FLAP))

    def head(a, b):
        lc = a.float() @ m_a + b.float() @ m_b + bias3
        return engine.double_head(torch.sigmoid(lc), cfg["head"],
                                  compute_dtype, m_full, m_flap, b_flap)

    # ---- affines between int8 and float (``engine_q.py:565-590``) -------
    def to_int8(x, s):
        """q = round(clip(x / s, 0, 255)) - 128 (the inverse scale f32)."""
        inv = dev((1.0 / s[:x.shape[-1]]).astype(np.float32))
        return (torch.round(torch.clamp(x.float() * inv, 0.0, 255.0))
                - 128.0).to(torch.int8)

    def dequant(q, s):
        """a = q*s + 128*s in f32, then ``compute_dtype``."""
        v = s[:q.shape[-1]].astype(np.float32)
        return (q.float() * dev(v) + dev(128.0 * v)).to(compute_dtype)

    conv = kc.conv3d_bn_relu_plain if plain else kc.conv3d_bn_relu
    pool = kc.maxpool2_plain if plain else kc.maxpool2
    upconv = ku.upconv_bn_relu_plain if plain else ku.upconv_bn_relu
    conv_q = kc.conv3d_q_requant_plain if plain else kc.conv3d_q_requant
    pool_q = kc.maxpool2_q_plain if plain else kc.maxpool2_q
    upconv_q = ku.upconv_q_requant_plain if plain else ku.upconv_q_requant

    def forward_one(x: torch.Tensor):
        if tuple(x.shape) != shape + (cin0,):
            raise ValueError(f"engine built for {shape + (cin0,)}, got "
                             f"{tuple(x.shape)}")
        h = (x.to(compute_dtype).contiguous() if head_units
             else to_int8(x, s_entry))
        skips = []
        t = 0
        for i in range(n):
            for j in (0, 1):
                ops = layers[f"d{i}.{j}"]
                h = conv(h, *ops) if t < head_units else conv_q(h, *ops)
                t += 1
                if t == head_units and j == 0:
                    h = to_int8(h, enc_s[i][0])  # mid-block switch
            skips.append(h)
            if t == head_units and head_units == 2 * (i + 1):
                # block-boundary switch: the skip stays float, the pooled
                # path quantizes (int8 max of q == q of the float max)
                h = to_int8(h, enc_s[i][1])
            h = pool_q(h) if h.dtype == torch.int8 else pool(h)
        a, b, b_s = h, None, None
        for idx in range(n):
            i = n - 1 - idx
            if idx == switch and a.dtype == torch.int8:
                a = dequant(a, s_a_list[idx])
            up, u1 = layers[f"u{idx}.0"], layers[f"u{idx}.1"]
            if idx < switch:
                if b is not None and b.dtype != torch.int8:
                    b = to_int8(b, b_s)  # a float skip at an int8 consumer
                a = upconv_q(a, b, *up)
                if u1[0].dtype == torch.int8:
                    a = conv_q(a, *u1)
                else:  # half tail: unit 1 in float
                    a = conv(dequant(a, s_up_list[idx]), *u1)
            else:
                if b is not None and b.dtype == torch.int8:
                    b = dequant(b, b_s)
                a = conv(upconv(a, b, *up), *u1)
            b, b_s = skips[i], skips_s[i]
        return head(a, b)

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        if images.device != device:
            raise ValueError(f"images on {images.device}, engine on {device}")
        outs = [forward_one(images[i]) for i in range(images.shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    predict.scales = scales
    predict.round_opt = round_opt
    predict.layers = layers
    return predict


def build_predict_q_opt(
    model_class: str,
    state_dict: Dict[str, torch.Tensor],
    calib_volume: torch.Tensor,
    adaquant_steps: int = 250,
    adaquant_lr: float = 0.03,
    learn_scales: bool = False,
    calib_batch=None,
    **kw,
) -> Callable:
    """:func:`build_predict_q` with AdaQuant rounding
    (``engine_q.build_predict_q_opt``, ``ctunet_tpu/engine_q.py:843-890``):
    a first build exports the scales calibrated on ``calib_volume``,
    :func:`quant_opt.optimize_rounding` optimizes the integer weights with
    autograd on ``calib_batch`` (``(N, D, H, W, C)`` float volumes, a 4-D
    one a batch of one; ``calib_volume`` when None), and the served engine
    is rebuilt on ``calib_volume`` with the overrides and the (possibly
    refined) scales. The serving loop passes as ``calib_batch`` the
    volume's margin-16 foreground window whenever it is smaller than the
    serving input, cropped or whole. Needs autograd enabled.

    :raises Unsupported: for a model ``quant_opt`` does not simulate.
    """
    from . import quant_opt

    if not quant_opt.supports(model_class):
        raise Unsupported(f"quant_opt: unsupported model {model_class}")
    scales: Dict[str, Any] = {}
    build_predict_q(model_class, state_dict, calib_volume,
                    export_scales=scales, **kw)
    cb = (calib_volume.float() if calib_batch is None
          else torch.as_tensor(calib_batch, dtype=torch.float32))
    if cb.ndim == 4:  # a single volume -> a batch of one
        cb = cb[None]
    refined: Dict[str, Any] = {}
    ropt = quant_opt.optimize_rounding(
        model_class, state_dict, cb, scales,
        steps=adaquant_steps, lr=adaquant_lr, learn_scales=learn_scales,
        out_scales=refined, bf16_head=float(kw.get("bf16_head") or 0),
        device=kw.get("device"))
    return build_predict_q(model_class, state_dict, calib_volume,
                           round_opt=ropt, import_scales=refined, **kw)
