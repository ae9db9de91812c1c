"""Checkpoints: the port's own train-state files, ``.npz`` flax exports and
reference ``.pt`` files.

Counterpart of ``ctunet_tpu/checkpoint.py``. :func:`save_checkpoint` writes
one ``torch.save`` file holding the model's state_dict (parameters and
BatchNorm statistics), the optimizer's state_dict (moments, count, plateau
scale), the step and a small ``extra`` dict; :func:`restore_checkpoint`
reads it back, and the trainer resumes all of it from ``s_resume_model``
(the reference restarts Adam's moments from zero on resume). The port reads
no orbax: an orbax directory is exported once to a flat ``.npz``
(``tools/export_unetsp_npz.py``; keys are flax tree paths joined by ``/``),
which :func:`load_any` maps through ``models.convert.from_flax``. A
reference ``.pt`` state_dict loads natively (the generic family and the
legacy ``recAE_v2_fixed`` / ``UNet4_2IC``, whose live ``cblock_center``
is kept), minus the ``module.`` prefix of ``nn.DataParallel`` and the dead
``cblock.`` keys of quirk Q1; a pickled reference module is refused.
:func:`load_any` returns a state_dict of the port's models from any of the
three.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .models.convert import from_flax

# The trained UNetSP weights committed with the package (exported from
# .ckpts/unetsp_10k).
UNETSP_10K = os.path.join(os.path.dirname(__file__), "assets",
                          "unetsp_10k.npz")


FORMAT = "ctunet_tpu_torch.train_state.v1"


def save_checkpoint(path: str, state, extra: Optional[Dict] = None) -> None:
    """Save a ``steps.TrainState`` (+ a small metadata dict) to the file
    ``path``, written beside it first and then moved into place."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "format": FORMAT,
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "extra": dict(extra or {}),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Read a :func:`save_checkpoint` file: ``{"model", "optimizer",
    "step", "extra"}``, tensors on the CPU."""
    path = os.path.expanduser(path)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(loaded, dict) or loaded.get("format") != FORMAT:
        raise ValueError(f"{path} is not a ctunet_tpu_torch train-state "
                         "checkpoint")
    return loaded


def is_train_state(path: str) -> bool:
    """Whether ``path`` is a file :func:`save_checkpoint` wrote (by its
    ``.ckpt`` name, the workspace's ``model/<name>.ckpt``)."""
    path = os.path.expanduser(path)
    return os.path.isfile(path) and path.endswith(".ckpt")


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b/c": array} -> nested dicts."""
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Flat flax ``.npz`` (``params/...``, ``batch_stats/...``) ->
    state_dict."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    return from_flax(tree["params"], tree["batch_stats"])


def load_pt(path: str) -> Dict[str, torch.Tensor]:
    """Reference ``.pt`` state_dict -> the port's state_dict.

    Read with ``weights_only=True``: a pickled reference module (the other
    format ``Model.py:464-472`` accepts) needs the reference's classes and
    is refused by torch's safe unpickler.
    """
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in loaded.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("cblock."):  # quirk Q1: dead center block
            out[k] = v.detach().cpu()
    return out


def load_any(path: str) -> Dict[str, torch.Tensor]:
    """Load model weights from a train-state ``.ckpt`` of the port, a flax
    ``.npz`` export or a reference ``.pt`` state_dict (each carries its own
    structure)."""
    path = os.path.expanduser(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if is_train_state(path):
        return restore_checkpoint(path)["model"]
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".pt"):
        return load_pt(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax directory; the PyTorch port reads no orbax. "
            "Export it once with tools/export_unetsp_npz.py --ckpt "
            f"{path} --out <file>.npz and load the .npz."
        )
    raise ValueError(f"unknown checkpoint format: {path}")
