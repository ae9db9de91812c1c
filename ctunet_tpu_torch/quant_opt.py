"""AdaQuant: calibration-time weight-rounding optimization for the int8
engine (counterpart of ``ctunet_tpu/quant_opt.py::optimize_rounding``).

Sequential AdaQuant (Hubara et al. 2020, arXiv:2006.10518): unit by unit,
in forward order, the INTEGER weights and a float requant-bias delta of each
quantized producer -- the encoder units ``d{i}.{j}``, the decoder's
composite upsample+conv ``u{idx}.0`` and second units ``u{idx}.1`` -- are
optimized to minimize the unit-output MSE against the float forward,
evaluated on the activations the quantized network actually produces. The
rounding is a straight-through estimator over a continuous proxy that
starts at round-to-nearest; Adam keeps its best iterate, so the result is
never worse than RTN on the calibration objective.

The output is ``{tag: {"q", "k", "db"}}`` for
``engine_q.build_predict_q(round_opt=...)``, on the grids the engine uses
(``k = 127 / max|w_eff * s_in|``). ``learn_scales`` also refines each
unit's output activation scales (LSQ-style) and returns them through
``out_scales`` in the engine's export format.

Autograd runs in f32 on ``F.conv3d`` / ``F.conv_transpose3d`` (the JAX
package runs XLA's conv there, ``ops/packed_conv.py:102``), with TF32 off
for cuDNN and matmuls inside :func:`optimize_rounding` and restored after.
Tensors are NCDHW inside this module.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device
from .engine_q import _EPS, _EPS_BN, _QMAX, _np
from .ops.kernels import upconv as ku

# Model families the simulation covers (``models/packed_resident.py:59``).
_CONFIGS: Dict[str, Dict[str, Any]] = {
    "UNet4b2i3o": dict(n_blocks=4, i_size=7, head=None),
    "UNet5b2i3o": dict(n_blocks=5, i_size=4, head=None),
    "UNet4b1i3o": dict(n_blocks=4, i_size=7, head=None),
    "UNetSP": dict(n_blocks=4, i_size=7, head="double"),
    "UNetSPSmall": dict(n_blocks=5, i_size=4, head="double_softmax"),
    "UNetDO": dict(n_blocks=4, i_size=7, head="double"),
}


def supports(model_class: str) -> bool:
    return model_class in _CONFIGS


def unit_wb(sd, prefix: str, conv_idx: int):
    """BN-folded flax-layout kernel ``(3, 3, 3, Ci, Co)`` and bias of one
    unit, folded as ``quant_opt._unit_wb`` folds it (``rsqrt(var+eps)*g``)."""
    bn = f"{prefix}.{conv_idx + 1}"
    var = torch.as_tensor(_np(sd[f"{bn}.running_var"]))
    inv = torch.rsqrt(var + _EPS_BN).numpy() * _np(sd[f"{bn}.weight"])
    shift = _np(sd[f"{bn}.bias"]) - _np(sd[f"{bn}.running_mean"]) * inv
    w = _np(sd[f"{prefix}.{conv_idx}.weight"]).transpose(2, 3, 4, 1, 0)
    if f"{prefix}.{conv_idx}.bias" in sd:
        shift = shift + _np(sd[f"{prefix}.{conv_idx}.bias"]) * inv
    return np.ascontiguousarray(w * inv[None, None, None, None, :]), shift


def _grid(w_eff: np.ndarray, s_in: np.ndarray):
    """RTN grid of a folded kernel: ``w_s = w_eff * s_in``,
    ``k = 127 / max|w_s|`` per output channel (``engine_q._quant_conv``)."""
    w_s = w_eff * s_in.astype(np.float32)[None, None, None, :, None]
    amax = np.abs(w_s).max(axis=(0, 1, 2, 3))
    k = np.where(amax > 0, 127.0 / np.maximum(amax, _EPS), 1.0)
    return w_s, k.astype(np.float32)


def _rtn(w_s: np.ndarray, k: np.ndarray) -> np.ndarray:
    return np.clip(np.round(w_s * k), -127, 127)


def _ch(v, ref: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCDHW."""
    return torch.as_tensor(v, dtype=torch.float32, device=ref.device).view(
        1, -1, 1, 1, 1)


def _fq_in(x: torch.Tensor, s) -> torch.Tensor:
    """Engine activation quantization, dequantized:
    ``clip(round(x/s), 0, 255) * s``."""
    sv = _ch(s, x)
    return torch.clamp(torch.round(x / sv), 0.0, _QMAX) * sv


def _ste_round(c: torch.Tensor) -> torch.Tensor:
    r = torch.clamp(torch.round(c), -127.0, 127.0)
    return c + (r - c).detach()


def _fq_learn(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """:func:`_fq_in` with a learnable scale: STE through the round, real
    gradients through the clip."""
    z = torch.clamp(x / s, 0.0, _QMAX)
    return (z + (torch.round(z) - z).detach()) * s


def _conv(x: torch.Tensor, w_flax: torch.Tensor) -> torch.Tensor:
    """SAME k3 conv of NCDHW ``x`` with a flax-layout ``(3,3,3,I,O)``
    kernel."""
    return F.conv3d(x, w_flax.permute(4, 3, 0, 1, 2), padding=1)


def _composite_apply(x_aug: torch.Tensor, resp: torch.Tensor) -> torch.Tensor:
    """A composite response ``R[4,4,4,Cin,Co]`` applied as K3's plain
    version does: ``out[v] = sum_u R[v-2u+1] in[u]``, the k4/s2/p1
    transposed conv (``quant_opt._composite_apply``)."""
    return F.conv_transpose3d(x_aug, resp.permute(3, 4, 0, 1, 2), stride=2,
                              padding=1)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x, 2)


def _adam_best(loss_fn, p0: Dict[str, torch.Tensor], steps: int, lr: float):
    """Adam (``torch.optim.Adam``: optax.adam's defaults b1=0.9, b2=0.999,
    eps=1e-8) keeping the best iterate. Each step's loss is that of the
    iterate before the update. Returns ``(best_p, first_loss, best_loss)``.
    """
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr)
    best_l = l0 = None
    best_p = {k: v.detach().clone() for k, v in p.items()}
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p)
        loss.backward()
        lf = float(loss.detach())
        if l0 is None:
            l0 = lf
        if best_l is None or lf < best_l:
            best_l = lf
            best_p = {k: v.detach().clone() for k, v in p.items()}
        opt.step()
    with torch.no_grad():
        lf = float(loss_fn(p))
    if l0 is None:
        l0 = lf  # steps=0: the init is the only iterate
    if best_l is None or lf < best_l:
        best_l = lf
        best_p = {k: v.detach().clone() for k, v in p.items()}
    return best_p, l0, best_l


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def optimize_rounding(
    model_class: str,
    state_dict: Dict[str, torch.Tensor],
    calib_batch,
    scales: Dict[str, Any],
    steps: int = 250,
    lr: float = 0.03,
    verbose: bool = False,
    learn_scales: bool = False,
    out_scales: Optional[Dict[str, Any]] = None,
    bf16_head: float = 0.0,
    device=None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Sequential AdaQuant over the generic-UNet conv units.

    :param calib_batch: ``(N, D, H, W, Cin)`` float calibration volumes.
    :param scales: the engine's exported activation scales
        (``build_predict_q(export_scales=...)``), ones lanes included.
    :param learn_scales: also refine each unit's output scales; feed
        ``out_scales`` to ``build_predict_q(import_scales=...)``.
    :param out_scales: filled with the (refined) scales, export format.
    :param bf16_head: the engine build's ``bf16_head``: units it serves in
        float stay float here and the chain quantizes once at the switch.
    :param device: where the simulation runs (default the card; ``"cpu"``).
    :returns: ``{tag: {"q", "k", "db"}}`` for ``round_opt=``.
    """
    if not supports(model_class):
        raise ValueError(f"quant_opt: unsupported model {model_class}")
    n = _CONFIGS[model_class]["n_blocks"]
    device = resolve_device(device)
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    x = torch.as_tensor(calib_batch).to(device, torch.float32)
    x = x.permute(0, 4, 1, 2, 3).contiguous()  # NCDHW
    overrides: Dict[str, Dict[str, np.ndarray]] = {}
    # working scale store, ones lanes included; refined in place
    ts: Dict[str, np.ndarray] = {
        t_: np.array(v[1] if isinstance(v, tuple) else v, np.float32)
        for t_, v in scales.items()}

    def t_(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    def unit_opt(tag, x_f, x_hat, prefix, conv_idx, s_in_tag):
        """Optimize one conv unit; returns (y_float, y_hat before quant)."""
        w_eff, shift = unit_wb(sd, prefix, conv_idx)
        shift_v = _ch(shift, x_f)
        with torch.no_grad():
            y_f = torch.relu(_conv(x_f, t_(w_eff)) + shift_v)
        s_in = ts[s_in_tag][:-1]
        w_s, k = _grid(w_eff, s_in)
        kv, sv = t_(k), t_(s_in)[:, None]

        def y_of(w_dq, db):
            with torch.no_grad():
                return torch.relu(_conv(x_hat, t_(w_dq)) + shift_v
                                  + _ch(db, x_f))

        y_norm = float(torch.mean(torch.square(y_f)))
        if y_norm <= 0.0:  # dead unit on the calibration set: RTN
            q = _rtn(w_s, k)
            overrides[tag] = {"q": q.astype(np.float32), "k": k,
                              "db": np.zeros(w_eff.shape[-1], np.float32)}
            return y_f, y_of(q / k / s_in[:, None], 0.0)
        s_out = ts[tag][:-1]
        s_out_v = _ch(s_out, x_f)

        def loss_fn(p):
            w_dq = _ste_round(p["c"]) / kv / sv
            y = torch.relu(_conv(x_hat, w_dq) + shift_v
                           + p["db"].view(1, -1, 1, 1, 1) * s_out_v)
            if learn_scales:
                y = _fq_learn(y, s_out_v * torch.exp(p["t"]).view(
                    1, -1, 1, 1, 1))
            return torch.mean(torch.square(y - y_f)) / y_norm

        co = w_eff.shape[-1]
        p0 = {"c": t_(w_s * k), "db": torch.zeros(co, device=device)}
        if learn_scales:
            p0["t"] = torch.zeros(co, device=device)
        best_p, l0, best_l = _adam_best(loss_fn, p0, steps, lr)
        if learn_scales:
            ts[tag][:-1] = s_out * np.exp(_np(best_p["t"]))
        q = np.clip(np.round(_np(best_p["c"])), -127, 127)
        db = _np(best_p["db"]) * np.asarray(scales[tag][1], np.float32)[:-1]
        overrides[tag] = {"q": q.astype(np.float32), "k": k, "db": db}
        if verbose:
            flips = int((q != _rtn(w_s, k)).sum())
            print(f"  {tag}: loss {l0:.3e} -> {best_l:.3e}, {flips}/{q.size} "
                  f"ints changed, |db|max {np.abs(db).max():.2e}", flush=True)
        return y_f, y_of(q / k / s_in[:, None], db)

    head_units = int(round(max(0.0, min(float(bf16_head), float(n))) * 2))
    with _no_tf32():
        x_f = x
        x_hat = _fq_in(x, ts["entry"][:-1]) if head_units == 0 else x
        skips_f, skips_hat, skips_float = [], [], []
        for i in range(n):
            for j in range(2):
                tag = f"d{i}.{j}"
                prefix, conv_idx = f"d_blocks.{i}.block", 3 * j
                if 2 * i + j < head_units:
                    # served in float by the engine: no override; the chain
                    # quantizes once at the switch
                    w_eff, shift = unit_wb(sd, prefix, conv_idx)
                    with torch.no_grad():
                        x_f = torch.relu(_conv(x_f, t_(w_eff))
                                         + _ch(shift, x_f))
                    x_hat = (x_f if 2 * i + j + 1 < head_units
                             else _fq_in(x_f, ts[tag][:-1]))
                    continue
                prev = ("entry" if (i, j) == (0, 0)
                        else f"d{i - 1}.1" if j == 0 else f"d{i}.0")
                x_f, x_hat = unit_opt(tag, x_f, x_hat, prefix, conv_idx, prev)
                x_hat = _fq_in(x_hat, ts[tag][:-1])
            # a block served fully in float keeps its skip float
            skip_float = 2 * i + 2 <= head_units
            skips_f.append(x_f)
            skips_hat.append(x_f if skip_float else x_hat)
            skips_float.append(skip_float)
            x_f, x_hat = _maxpool(x_f), _maxpool(x_hat)

        for idx in range(n):
            i = n - 1 - idx
            p = f"u_blocks.{idx}.block"
            ku_w = sd[f"{p}.0.weight"].float().to(device)  # (Cin, Ct, 2,2,2)
            bu = sd[f"{p}.0.bias"].float().to(device)
            w0_eff, shift0 = unit_wb(sd, p, 1)
            shift0_v = _ch(shift0, x_f)
            s_up = ts[f"u{idx}.0"][:-1].copy()  # pre-refinement (db, loss)
            cat_f = x_f if idx == 0 else torch.cat([x_f, skips_f[i + 1]], 1)
            with torch.no_grad():
                h = F.conv_transpose3d(cat_f, ku_w, bu, stride=2)
                x_f = torch.relu(_conv(h, t_(w0_eff)) + shift0_v)

            tag0 = f"u{idx}.0"
            kk = _np(ku_w).transpose(2, 3, 4, 1, 0)  # flax (2,2,2,Ct,Cin)
            ones = torch.ones_like(x_hat[:, :1])
            if idx == 0:
                kT_aug, _ = ku.augment_upconv_kernel(kk, _np(bu), None)
                s_in_full = ts[f"d{n - 1}.1"]
                aug = [x_hat, ones]
            else:
                kT_aug, _ = ku.augment_upconv_kernel(kk, _np(bu),
                                                     x_hat.shape[1])
                s_in_full = np.concatenate([ts[f"u{idx - 1}.1"],
                                            ts[f"d{i + 1}.1"]])
                b_hat = skips_hat[i + 1]
                if skips_float[i + 1]:
                    # the engine quantizes a float skip where it is consumed
                    b_hat = _fq_in(b_hat, ts[f"d{i + 1}.1"][:-1])
                aug = [x_hat, ones, b_hat, ones]
            x_aug = torch.cat(aug, 1)
            resp = ku.composite_response(kT_aug, w0_eff)
            r_s, k = _grid(resp, s_in_full)
            y_norm = float(torch.mean(torch.square(x_f)))
            if y_norm <= 0.0:  # dead composite: RTN override
                q = _rtn(r_s, k)
                with torch.no_grad():
                    y_hat = torch.relu(_composite_apply(
                        x_aug, t_(q / k / s_in_full[:, None])) + shift0_v)
                overrides[tag0] = {"q": q.astype(np.float32), "k": k,
                                   "db": np.zeros(resp.shape[-1], np.float32)}
            else:
                kv, sv = t_(k), t_(s_in_full)[:, None]
                s_up_v = _ch(s_up, x_f)

                def loss_fn(pp, x_aug=x_aug, y_ref=x_f, kv=kv, sv=sv,
                            s_up_v=s_up_v, shift0_v=shift0_v, y_norm=y_norm):
                    w_dq = _ste_round(pp["c"]) / kv / sv
                    y = torch.relu(_composite_apply(x_aug, w_dq) + shift0_v
                                   + pp["db"].view(1, -1, 1, 1, 1) * s_up_v)
                    if learn_scales:
                        y = _fq_learn(y, s_up_v * torch.exp(pp["t"]).view(
                            1, -1, 1, 1, 1))
                    return torch.mean(torch.square(y - y_ref)) / y_norm

                co = resp.shape[-1]
                p0 = {"c": t_(r_s * k), "db": torch.zeros(co, device=device)}
                if learn_scales:
                    p0["t"] = torch.zeros(co, device=device)
                best_p, l0, best_l = _adam_best(loss_fn, p0, steps, lr)
                if learn_scales:
                    ts[tag0][:-1] = s_up * np.exp(_np(best_p["t"]))
                q = np.clip(np.round(_np(best_p["c"])), -127, 127)
                db = _np(best_p["db"]) * s_up
                overrides[tag0] = {"q": q.astype(np.float32), "k": k,
                                   "db": db}
                if verbose:
                    flips = int((q != _rtn(r_s, k)).sum())
                    print(f"  {tag0}: loss {l0:.3e} -> {best_l:.3e}, "
                          f"{flips}/{q.size} ints changed, |db|max "
                          f"{np.abs(db).max():.2e}", flush=True)
                with torch.no_grad():
                    y_hat = torch.relu(
                        _composite_apply(x_aug, t_(q / k / s_in_full[:, None]))
                        + shift0_v + _ch(db, x_f))
            x_hat = _fq_in(y_hat, ts[tag0][:-1])
            tag = f"u{idx}.1"
            x_f, x_hat = unit_opt(tag, x_f, x_hat, p, 4, tag0)
            x_hat = _fq_in(x_hat, ts[tag][:-1])

    if out_scales is not None:
        out_scales.update(_assemble_export(ts, n))
    return overrides


def _assemble_export(ts: Dict[str, np.ndarray], n: int) -> Dict[str, Any]:
    """Per-tensor output scales -> the engine's ``export_scales`` format."""
    out: Dict[str, Any] = {"entry": ts["entry"]}
    s_cur = ts["entry"]
    for i in range(n):
        out[f"d{i}.0"] = (s_cur, ts[f"d{i}.0"])
        out[f"d{i}.1"] = (ts[f"d{i}.0"], ts[f"d{i}.1"])
        s_cur = ts[f"d{i}.1"]
    for idx in range(n):
        out[f"u{idx}.0"] = ts[f"u{idx}.0"]
        out[f"u{idx}.1"] = (ts[f"u{idx}.0"], ts[f"u{idx}.1"])
    return out
