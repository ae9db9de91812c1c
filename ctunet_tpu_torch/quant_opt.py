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
package runs XLA's conv there, ``ops/packed_conv.py:102``). Inside
:func:`optimize_rounding` (:func:`search_flags`) TF32 is off for cuDNN and
matmuls, and cuDNN runs deterministic algorithms without benchmarking, so
that two builds on the same volume give the same integer weights; all four
flags are restored after.
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
from .models.variants import double_out_head
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


# the backend flags the rounding search sets: f32 without TF32 (the JAX
# package's XLA convs on the CPU), and cuDNN's deterministic algorithms,
# chosen without benchmarking, so that two searches on the same inputs give
# the same integers (autotuning may pick another, atomics-based backward
# algorithm from one run to the next)
SEARCH_FLAGS = (("cudnn", "allow_tf32", False),
                ("cuda.matmul", "allow_tf32", False),
                ("cudnn", "deterministic", True),
                ("cudnn", "benchmark", False))


def _backend(path: str):
    mod = torch.backends
    for part in path.split("."):
        mod = getattr(mod, part)
    return mod


@contextlib.contextmanager
def search_flags():
    """Set :data:`SEARCH_FLAGS` for the rounding search and restore all
    four flags afterwards."""
    saved = [getattr(_backend(m), k) for m, k, _ in SEARCH_FLAGS]
    try:
        for m, k, v in SEARCH_FLAGS:
            setattr(_backend(m), k, v)
        yield
    finally:
        for (m, k, _), v in zip(SEARCH_FLAGS, saved):
            setattr(_backend(m), k, v)


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
    overrides, ts, _ = _sequential(
        model_class, state_dict, calib_batch, scales, steps, lr, verbose,
        learn_scales, bf16_head, device, fixed=None)
    if out_scales is not None:
        out_scales.update(_assemble_export(ts, _CONFIGS[model_class][
            "n_blocks"]))
    return overrides


def simulate_int8(model_class: str, state_dict: Dict[str, torch.Tensor],
                  x, scales: Dict[str, Any],
                  round_opt: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                  bf16_head: float = 0.0, device=None):
    """The float forward and the simulated int8 forward of a fixed
    quantization on the volumes ``x`` ``(N, D, H, W, Cin)``: every unit
    rounded to nearest on ``scales``' grid, or with ``round_opt``'s
    integers where it has them (:func:`optimize_rounding`'s result), then
    the final skip concat and the float 1x1 head (:func:`_sim_head`).
    The JAX package evaluates it as ``optimize_rounding(tags=set(),
    apply_opt=round_opt, return_outputs=True)``.

    :returns: ``(out_float, out_quant)``, each the model's output tuple,
        channels-last.
    """
    _, _, outs = _sequential(model_class, state_dict, x, scales, 0, 0.0,
                             False, False, bf16_head, device,
                             fixed=round_opt or {})
    return outs


def _sequential(model_class, state_dict, calib_batch, scales, steps, lr,
                verbose, learn_scales, bf16_head, device, fixed):
    """The unit-by-unit walk of :func:`optimize_rounding` (``fixed`` None:
    optimize every unit, record its override) and of :func:`simulate_int8`
    (``fixed`` the overrides to apply: optimize nothing, run the head).
    Returns ``(overrides, scale store, (out_float, out_quant) or None)``.
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

        if fixed is not None:
            # not optimized: the given override, else round to nearest
            ov = fixed.get(tag)
            if ov is not None:
                return y_f, y_of(ov["q"] / ov["k"] / s_in[:, None], ov["db"])
            return y_f, y_of(_rtn(w_s, k) / k / s_in[:, None], 0.0)
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
    with search_flags():
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
            if fixed is not None or y_norm <= 0.0:
                ov = None if fixed is None else fixed.get(tag0)
                if ov is not None:
                    w_dq = ov["q"] / ov["k"] / s_in_full[:, None]
                    db_v = ov["db"]
                else:
                    q = _rtn(r_s, k)
                    w_dq, db_v = q / k / s_in_full[:, None], 0.0
                with torch.no_grad():
                    y_hat = torch.relu(_composite_apply(x_aug, t_(w_dq))
                                       + shift0_v + _ch(db_v, x_f))
                if fixed is None:  # dead composite: RTN override
                    overrides[tag0] = {
                        "q": q.astype(np.float32), "k": k,
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

        if fixed is None:
            return overrides, ts, None
        # the head takes the chain and the d0 skip (a float skip of a bf16
        # head unquantized: skips_hat[0] holds either)
        head = _CONFIGS[model_class]["head"]
        out_f = _sim_head(head, sd, torch.cat([x_f, skips_f[0]], 1))
        out_hat = _sim_head(head, sd, torch.cat([x_hat, skips_hat[0]], 1))
    return overrides, ts, (out_f, out_hat)


def _convt2x2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """ConvTranspose(k2, s2) of NCDHW ``x`` with the torch weight ``(Ci,
    Co, 2, 2, 2)`` in the einsum form (``quant_opt._convt2x2``)."""
    y = torch.einsum("nizyx,ioabc->nozaybxc", x, w)
    nb, co, d, _, h, _, wd, _ = y.shape
    return y.reshape(nb, co, 2 * d, 2 * h, 2 * wd) + b.view(1, -1, 1, 1, 1)


def simulate_scales(model_class: str, state_dict: Dict[str, torch.Tensor],
                    calib_batch, device=None) -> Dict[str, Any]:
    """Max calibration without the engine (``quant_opt.simulate_scales``):
    per-channel activation maxima of a float forward with BatchNorm folded
    (:func:`unit_wb`), ``s = max / 255`` (the zero-point range) with the
    ones lane, in the engine's ``export_scales`` format
    (:func:`_assemble_export`), for ``engine_q.build_predict_q(
    import_scales=)`` and :func:`optimize_rounding`. The engine calibrates
    through its bf16 kernels, so the two agree up to that rounding.

    :param calib_batch: ``(N, D, H, W, Cin)`` float calibration volumes.
    :param device: where the forward runs (default the card; ``"cpu"``).
    """
    if not supports(model_class):
        raise ValueError(f"quant_opt: unsupported model {model_class}")
    n = _CONFIGS[model_class]["n_blocks"]
    device = resolve_device(device)
    sd = {k: v.detach().to(device, torch.float32)
          for k, v in state_dict.items()}
    x = torch.as_tensor(calib_batch).to(device, torch.float32)
    x = x.permute(0, 4, 1, 2, 3).contiguous()  # NCDHW

    def smax(t: torch.Tensor) -> np.ndarray:
        m = np.maximum(_np(t.abs().amax(dim=(0, 2, 3, 4))), _EPS)
        return np.concatenate([m / _QMAX, [1.0 / _QMAX]]).astype(np.float32)

    def unit(t: torch.Tensor, prefix: str, conv_idx: int) -> torch.Tensor:
        w_eff, shift = unit_wb(sd, prefix, conv_idx)
        w = torch.as_tensor(w_eff, device=device)
        return torch.relu(_conv(t, w) + _ch(shift, t))

    ts: Dict[str, np.ndarray] = {"entry": smax(x)}
    skips = []
    with search_flags(), torch.no_grad():
        for i in range(n):
            for j in range(2):
                x = unit(x, f"d_blocks.{i}.block", 3 * j)
                ts[f"d{i}.{j}"] = smax(x)
            skips.append(x)
            x = _maxpool(x)
        for idx in range(n):
            i = n - 1 - idx
            p = f"u_blocks.{idx}.block"
            cat = x if idx == 0 else torch.cat([x, skips[i + 1]], 1)
            x = unit(_convt2x2(cat, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"]),
                     p, 1)
            ts[f"u{idx}.0"] = smax(x)
            x = unit(x, p, 4)
            ts[f"u{idx}.1"] = smax(x)
    return _assemble_export(ts, n)


def _sim_head(head: Optional[str], sd: Dict[str, torch.Tensor],
              feat: torch.Tensor):
    """The float 1x1 head over NCDHW ``feat`` and the variant's output
    mapping (``quant_opt._sim_head``; the engine's int8 head rounding is
    not simulated): a tuple of channels-last outputs."""
    lc_k = sd["last_conv.weight"][:, :, 0, 0, 0].float().t()
    lc_b = sd["last_conv.bias"].float()
    feat = feat.permute(0, 2, 3, 4, 1)
    out3 = torch.sigmoid(feat @ lc_k.to(feat.device) + lc_b.to(feat.device))
    if head is None:
        return (out3,)
    full, flap = double_out_head(out3)
    if head == "double_softmax":
        return torch.softmax(full, -1), torch.softmax(flap, -1)
    return full, flap


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
