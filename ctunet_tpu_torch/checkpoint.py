"""Checkpoint read side: ``.npz`` flax exports and reference ``.pt`` files.

Counterpart of ``ctunet_tpu/checkpoint.py::load_any``. The port reads no
orbax: an orbax directory is exported once to a flat ``.npz``
(``tools/export_unetsp_npz.py``; keys are flax tree paths joined by ``/``),
which :func:`load_any` maps through ``models.convert.from_flax``. A
reference ``.pt`` state_dict loads natively, minus the ``module.`` prefix
of ``nn.DataParallel`` and the dead center-block keys of quirk Q1; a
pickled reference module is refused. Every loader returns a state_dict of
the port's models.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .models.convert import from_flax

# The trained UNetSP weights committed with the package (exported from
# .ckpts/unetsp_10k).
UNETSP_10K = os.path.join(os.path.dirname(__file__), "assets",
                          "unetsp_10k.npz")


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
    """Load model weights from a flax ``.npz`` export or a reference
    ``.pt`` state_dict (both carry their own structure)."""
    path = os.path.expanduser(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
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
