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
- ``last_conv`` ``(1,1,1,I,O)`` -> ``(O,I,1,1,1)``.

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
    for j in range(n_blocks):
        up = params[f"u{j}"]["upconv"]
        sd[f"u_blocks.{j}.block.0.weight"] = _kernel(up["kernel"])
        sd[f"u_blocks.{j}.block.0.bias"] = _t(up["bias"])
        for k, conv_idx in enumerate((1, 4)):
            _unit(sd, params[f"u{j}"], stats[f"u{j}"], f"unit{k}",
                  f"u_blocks.{j}.block", conv_idx)
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
    for j in range(n_blocks):
        src = f"u_blocks.{j}.block"
        params[f"u{j}"] = {"upconv": {
            "kernel": _kernel_back(sd[f"{src}.0.weight"]),
            "bias": _n(sd[f"{src}.0.bias"])}}
        stats[f"u{j}"] = {}
        for k, conv_idx in enumerate((1, 4)):
            p, s = _unit_back(sd, src, conv_idx)
            params[f"u{j}"][f"unit{k}"], stats[f"u{j}"][f"unit{k}"] = p, s
    params["last_conv"] = {"kernel": _kernel_back(sd["last_conv.weight"]),
                           "bias": _n(sd["last_conv.bias"])}
    if root is None:
        return params, stats
    return {root: params}, {root: stats}
