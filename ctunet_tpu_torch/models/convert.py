"""Flax variable trees <-> PyTorch state_dict of the port's models.

``ctunet_tpu`` keeps weights as flax trees: ``params`` (conv kernels
``(k,k,k,I,O)``, ConvTranspose kernels ``(2,2,2,O,I)`` in the
``transpose_kernel`` layout, BN ``scale``/``bias``, ``last_conv`` kernel
``(1,1,1,I,O)``) and ``batch_stats`` (BN ``mean``/``var``), under a ``unet``
root for the generic family and at the root for the legacy family
(``dblock1/unit0/conv/kernel``, ``ublock1/upconv/kernel``). :func:`from_flax`
maps them to the reference state_dict names the port's modules use
(``models/unet.py``, ``models/legacy.py``):

- conv kernel ``(k,k,k,I,O)`` -> ``(O,I,k,k,k)``, no spatial flip;
- ConvTranspose kernel ``(2,2,2,O,I)`` -> torch ``(I,O,2,2,2)``, no flip:
  ``out[2z+a] = sum_i x[z,i] k[a,o,i]`` in flax is
  ``out[2z+a] = sum_i x[z,i] W[i,o,a]`` in torch (``unet.py:176-214``);
- BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``; flax stores the biased running variance
  and it is used as is (eval-mode parity is unaffected);
- ``last_conv`` ``(1,1,1,I,O)`` -> ``(O,I,1,1,1)``;
- the generic ``UNet``'s options (``models/unet.py``): a residual block's
  ``skip_conv`` ``(1,1,1,I,O)``, ``skip_bn`` and ``skip_upconv`` map to
  the block's ``skip_conv`` / ``skip_bn`` / ``skip_upconv`` as above, and
  the FC center ``cblock/fc{0,1}`` Dense kernels ``(I,O)`` to
  ``center.fc{0,1}`` ``nn.Linear`` weights ``(O,I)``.

The arrays are taken as numpy (any nested mapping of array-likes).
:func:`to_flax` is the way back: a state_dict of the port -> the JAX
package's ``params`` and ``batch_stats`` as nested dicts of numpy arrays,
so weights trained here load there and the tests carry one set of weights
through both train steps.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _kernel(a) -> torch.Tensor:
    """flax (kd,kh,kw,I,O) / transpose-kernel (kd,kh,kw,O,I) -> torch
    (O,I,kd,kh,kw) / (I,O,kd,kh,kw): the same transpose for both."""
    return _t(np.transpose(np.asarray(a, np.float32), (4, 3, 0, 1, 2)))


def _unit(sd, params, stats, src: str, dst: str, conv_idx: int) -> None:
    p, s = params[src], stats[src]
    sd[f"{dst}.{conv_idx}.weight"] = _kernel(p["conv"]["kernel"])
    if "bias" in p["conv"]:
        sd[f"{dst}.{conv_idx}.bias"] = _t(p["conv"]["bias"])
    bn = conv_idx + 1
    sd[f"{dst}.{bn}.weight"] = _t(p["bn"]["scale"])
    sd[f"{dst}.{bn}.bias"] = _t(p["bn"]["bias"])
    sd[f"{dst}.{bn}.running_mean"] = _t(s["bn"]["mean"])
    sd[f"{dst}.{bn}.running_var"] = _t(s["bn"]["var"])
    sd[f"{dst}.{bn}.num_batches_tracked"] = torch.tensor(0)


def _options(sd, params, stats, src: str, dst: str) -> None:
    """A residual block's skip path, when it has one (``unet.py:333-353``)."""
    p = params[src]
    if "skip_upconv" in p:
        sd[f"{dst}.skip_upconv.weight"] = _kernel(p["skip_upconv"]["kernel"])
        sd[f"{dst}.skip_upconv.bias"] = _t(p["skip_upconv"]["bias"])
    if "skip_conv" in p:
        sd[f"{dst}.skip_conv.weight"] = _kernel(p["skip_conv"]["kernel"])
        sd[f"{dst}.skip_bn.weight"] = _t(p["skip_bn"]["scale"])
        sd[f"{dst}.skip_bn.bias"] = _t(p["skip_bn"]["bias"])
        sd[f"{dst}.skip_bn.running_mean"] = _t(stats[src]["skip_bn"]["mean"])
        sd[f"{dst}.skip_bn.running_var"] = _t(stats[src]["skip_bn"]["var"])
        sd[f"{dst}.skip_bn.num_batches_tracked"] = torch.tensor(0)


LEGACY_DOWN = ("dblock1", "dblock2", "dblock3", "dblock4", "cblock_center")
LEGACY_UP = ("ublock1", "ublock2", "ublock3", "ublock4")


def _from_flax_legacy(params, stats) -> Dict[str, torch.Tensor]:
    """Legacy tree (``ctunet_tpu/models/legacy.py``) -> the reference's
    names (``torch_port.py:242-265``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in LEGACY_DOWN:
        for j, conv_idx in enumerate((0, 3)):
            _unit(sd, params[name], stats[name], f"unit{j}", name, conv_idx)
    for name in LEGACY_UP:
        up = params[name]["upconv"]
        sd[f"{name}.0.weight"] = _kernel(up["kernel"])
        sd[f"{name}.0.bias"] = _t(up["bias"])
        for k, conv_idx in enumerate((1, 4)):
            _unit(sd, params[name], stats[name], f"unit{k}", name, conv_idx)
    sd["last_conv.weight"] = _kernel(params["last_conv"]["kernel"])
    sd["last_conv.bias"] = _t(params["last_conv"]["bias"])
    return sd


def from_flax(params: Mapping[str, Any],
              batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``params``/``batch_stats`` -> state_dict, for the generic family
    (with or without the ``unet`` root) and the legacy family (a root with
    ``dblock1``).
    """
    if "dblock1" in params:
        return _from_flax_legacy(params, batch_stats)
    params = params.get("unet", params)
    stats = batch_stats.get("unet", batch_stats)
    n_blocks = sum(1 for k in params if k.startswith("d"))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        for j, conv_idx in enumerate((0, 3)):
            _unit(sd, params[f"d{i}"], stats[f"d{i}"], f"unit{j}",
                  f"d_blocks.{i}.block", conv_idx)
        _options(sd, params, stats, f"d{i}", f"d_blocks.{i}")
    for name in ("fc0", "fc1"):
        if "cblock" in params:
            fc = params["cblock"][name]
            sd[f"center.{name}.weight"] = _t(np.asarray(fc["kernel"]).T)
            sd[f"center.{name}.bias"] = _t(fc["bias"])
    for j in range(n_blocks):
        up = params[f"u{j}"]["upconv"]
        sd[f"u_blocks.{j}.block.0.weight"] = _kernel(up["kernel"])
        sd[f"u_blocks.{j}.block.0.bias"] = _t(up["bias"])
        for k, conv_idx in enumerate((1, 4)):
            _unit(sd, params[f"u{j}"], stats[f"u{j}"], f"unit{k}",
                  f"u_blocks.{j}.block", conv_idx)
        _options(sd, params, stats, f"u{j}", f"u_blocks.{j}")
    sd["last_conv.weight"] = _kernel(params["last_conv"]["kernel"])
    sd["last_conv.bias"] = _t(params["last_conv"]["bias"])
    return sd


def _n(t) -> np.ndarray:
    """A numpy f32 copy (never a view of a live parameter or buffer)."""
    return np.array(t.detach().cpu().float().numpy(), np.float32)


def _kernel_back(t) -> np.ndarray:
    """The inverse of :func:`_kernel`: torch (A,B,kd,kh,kw) -> (kd,kh,kw,B,A).
    """
    return np.ascontiguousarray(np.transpose(_n(t), (2, 3, 4, 1, 0)))


def _unit_back(sd, src: str, conv_idx: int):
    bn = conv_idx + 1
    conv = {"kernel": _kernel_back(sd[f"{src}.{conv_idx}.weight"])}
    if f"{src}.{conv_idx}.bias" in sd:
        conv["bias"] = _n(sd[f"{src}.{conv_idx}.bias"])
    params = {"conv": conv, "bn": {"scale": _n(sd[f"{src}.{bn}.weight"]),
                                   "bias": _n(sd[f"{src}.{bn}.bias"])}}
    stats = {"bn": {"mean": _n(sd[f"{src}.{bn}.running_mean"]),
                    "var": _n(sd[f"{src}.{bn}.running_var"])}}
    return params, stats


def _options_back(sd, params, stats, src: str, dst: str) -> None:
    """The inverse of :func:`_options`."""
    if f"{src}.skip_upconv.weight" in sd:
        params[dst]["skip_upconv"] = {
            "kernel": _kernel_back(sd[f"{src}.skip_upconv.weight"]),
            "bias": _n(sd[f"{src}.skip_upconv.bias"])}
    if f"{src}.skip_conv.weight" in sd:
        params[dst]["skip_conv"] = {
            "kernel": _kernel_back(sd[f"{src}.skip_conv.weight"])}
        params[dst]["skip_bn"] = {"scale": _n(sd[f"{src}.skip_bn.weight"]),
                                  "bias": _n(sd[f"{src}.skip_bn.bias"])}
        stats[dst]["skip_bn"] = {
            "mean": _n(sd[f"{src}.skip_bn.running_mean"]),
            "var": _n(sd[f"{src}.skip_bn.running_var"])}


def _to_flax_legacy(sd: Mapping[str, torch.Tensor]):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name in LEGACY_DOWN + LEGACY_UP:
        params[name], stats[name] = {}, {}
        up = name in LEGACY_UP
        if up:
            params[name]["upconv"] = {
                "kernel": _kernel_back(sd[f"{name}.0.weight"]),
                "bias": _n(sd[f"{name}.0.bias"])}
        for j, conv_idx in enumerate((1, 4) if up else (0, 3)):
            p, s = _unit_back(sd, name, conv_idx)
            params[name][f"unit{j}"], stats[name][f"unit{j}"] = p, s
    params["last_conv"] = {"kernel": _kernel_back(sd["last_conv.weight"]),
                           "bias": _n(sd["last_conv.bias"])}
    return params, stats


def to_flax(sd: Mapping[str, torch.Tensor], root: str = "unet"):
    """State_dict of the port's models -> ``(params, batch_stats)`` of
    ``ctunet_tpu``, as numpy f32: the generic family's under ``root``
    (``None``: no root), the legacy family's at the root as the JAX
    package keeps them. The inverse of :func:`from_flax`."""
    if "dblock1.0.weight" in sd:
        return _to_flax_legacy(sd)
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("d_blocks."))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_blocks):
        params[f"d{i}"], stats[f"d{i}"] = {}, {}
        for j, conv_idx in enumerate((0, 3)):
            p, s = _unit_back(sd, f"d_blocks.{i}.block", conv_idx)
            params[f"d{i}"][f"unit{j}"], stats[f"d{i}"][f"unit{j}"] = p, s
        _options_back(sd, params, stats, f"d_blocks.{i}", f"d{i}")
    if "center.fc0.weight" in sd:
        params["cblock"] = {
            name: {"kernel": np.ascontiguousarray(
                _n(sd[f"center.{name}.weight"]).T),
                "bias": _n(sd[f"center.{name}.bias"])}
            for name in ("fc0", "fc1")}
    for j in range(n_blocks):
        src = f"u_blocks.{j}.block"
        params[f"u{j}"] = {"upconv": {
            "kernel": _kernel_back(sd[f"{src}.0.weight"]),
            "bias": _n(sd[f"{src}.0.bias"])}}
        stats[f"u{j}"] = {}
        for k, conv_idx in enumerate((1, 4)):
            p, s = _unit_back(sd, src, conv_idx)
            params[f"u{j}"][f"unit{k}"], stats[f"u{j}"][f"unit{k}"] = p, s
        _options_back(sd, params, stats, f"u_blocks.{j}", f"u{j}")
    params["last_conv"] = {"kernel": _kernel_back(sd["last_conv.weight"]),
                           "bias": _n(sd["last_conv.bias"])}
    if root is None:
        return params, stats
    return {root: params}, {root: stats}


LEGACY = ("recAE_v2_fixed", "UNet4_2IC")


def export_state_dict(sd: Mapping[str, torch.Tensor],
                      model_class: str) -> Dict[str, np.ndarray]:
    """The reference's torch state_dict of a registered generic model
    (``torch_port.export_state_dict``, ``torch_port.py:331-376``), as
    numpy: f32 parameters and BatchNorm statistics, ``num_batches_tracked``
    0 (int64) as the JAX export writes it. The port's modules carry the
    reference's names already, so this checks that ``sd`` holds every key
    of ``model_class`` at its shape and nothing else; the dead center
    block's ``cblock.*`` keys are not emitted (quirk Q1): merge the result
    over a reference model's own state_dict to fill them.
    ``torch.save({k: torch.as_tensor(v) for k, v in out.items()}, path)``
    writes a ``.pt`` that ``checkpoint.load_pt`` reads back.

    :raises NotImplementedError: for the legacy family (the JAX package
        exports none).
    :raises KeyError: for a class with no export mapping, or a missing or
        extra key; ``ValueError`` for a shape that is not the model's.
    """
    if model_class in LEGACY:
        raise NotImplementedError(
            "legacy export not implemented (port direction only)")
    from . import build_model
    from .. import registry

    if model_class not in registry.MODEL_REGISTRY:
        raise KeyError(f"No torch export mapping for model '{model_class}'")
    want = build_model(model_class).state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"{model_class}: missing {missing[:4]}, extra "
                       f"{extra[:4]}")
    out: Dict[str, np.ndarray] = {}
    for k, ref in want.items():
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"{model_class}: {k} has shape "
                             f"{tuple(sd[k].shape)}, not {tuple(ref.shape)}")
        out[k] = (np.asarray(0, np.int64) if k.endswith(
            "num_batches_tracked") else _n(sd[k]))
    return out
