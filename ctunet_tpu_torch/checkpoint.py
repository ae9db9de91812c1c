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
which :func:`load_any` maps through ``models.convert.from_flax``.

A reference ``.pt`` holds either a state_dict or a whole pickled
``nn.Module`` (``Model.py:464-472``), each possibly wrapped in
``nn.DataParallel``, in torch's zip format or its older non-zip one.
:func:`load_pt` reads all of them through :data:`RESTRICTED_PICKLE`, an
unpickler that runs no code of the file: every global outside a short
allow-list of tensor rebuilds, storage types, ``OrderedDict`` and inert
builtins becomes an empty placeholder class, and nothing is imported. A
module's state_dict is then rebuilt from the placeholders'
``_parameters``, ``_buffers`` and ``_modules`` trees
(``ctunet_tpu/models/torch_port.py:154-178``), minus the ``module.``
prefix of ``nn.DataParallel`` and the dead ``cblock.`` keys of quirk Q1.
:func:`load_any` returns a state_dict of the port's models from any of the
three formats.
"""

from __future__ import annotations

import collections
import os
import pickle
import types
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from .models.convert import from_flax

# The trained weights committed with the package, exported from
# .ckpts/unetsp_10k (UNetSP) and .ckpts/unetspsmall_3k (UNetSPSmall).
UNETSP_10K = os.path.join(os.path.dirname(__file__), "assets",
                          "unetsp_10k.npz")
UNETSPSMALL_3K = os.path.join(os.path.dirname(__file__), "assets",
                              "unetspsmall_3k.npz")


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


# ---------------------------------------------------------------------------
# the restricted unpickler of reference .pt files
# ---------------------------------------------------------------------------

# where the placeholder classes claim to live: a module that does not exist,
# so nothing (torch's source check of legacy files included) finds a file
_PLACEHOLDER_MODULE = "ctunet_tpu_torch.checkpoint.<pickled>"


class Placeholder:
    """What every global of a ``.pt`` outside the allow-list unpickles to:
    a class with no behaviour. Constructing one ignores its arguments, and
    the pickle's state fills its ``__dict__``, so a pickled ``nn.Module``
    becomes a tree of these whose ``_parameters``, ``_buffers`` and
    ``_modules`` hold the tensors. ``pickled_as`` is the ``(module,
    name)`` the file asked for."""

    pickled_as = ("", "")

    def __init__(self, *args, **kwargs):
        del args, kwargs


def _rebuild_tensor(storage, storage_offset, size, stride, *_):
    """``torch._utils._rebuild_tensor_v2`` without the requires-grad flag,
    the backward hooks and the metadata the file may carry."""
    return torch._utils._rebuild_tensor(storage, storage_offset, size,
                                        stride)


def _rebuild_parameter(data, *_):
    """A parameter is kept as its tensor: no requires-grad flag, hooks or
    (``_rebuild_parameter_with_state``) attributes set from the file."""
    return data


# The globals that torch.save files of state_dicts and of modules (plain,
# in nn.DataParallel, zip and legacy format) name, as the tests find; none
# of them runs code of the file. ``set`` is a module's
# ``_non_persistent_buffers_set`` (protocol 2 names its module
# ``__builtin__``); a legacy file names the dtypes. The storage types
# (``torch.FloatStorage``, ...) never reach ``find_class``: torch's loaders
# resolve them first.
ALLOWED = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch._utils", "_rebuild_parameter_with_state"): _rebuild_parameter,
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set,
    ("__builtin__", "set"): set,
    **{("torch", n): getattr(torch, n) for n in (
        "float64", "float32", "float16", "bfloat16", "int64", "int32",
        "int16", "int8", "uint8", "bool")},
}


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that imports nothing: :data:`ALLOWED` globals come
    back as themselves, every other ``(module, name)`` as a fresh
    :class:`Placeholder` subclass."""

    def find_class(self, module, name):
        found = ALLOWED.get((module, name))
        if found is not None:
            return found
        return type(str(name), (Placeholder,), {
            "__module__": _PLACEHOLDER_MODULE,
            "pickled_as": (str(module), str(name))})


def _restricted_load(file, **kwargs):
    return RestrictedUnpickler(file, **kwargs).load()


# the ``pickle_module`` handed to ``torch.load``: torch's loaders subclass
# its ``Unpickler`` (keeping our ``find_class``) and call its ``load`` for
# the legacy format's headers
RESTRICTED_PICKLE = types.ModuleType("ctunet_tpu_torch.restricted_pickle")
RESTRICTED_PICKLE.Unpickler = RestrictedUnpickler
RESTRICTED_PICKLE.load = _restricted_load


def _tree_state_dict(node, prefix: str = "") -> Dict[str, Any]:
    """``state_dict()`` of an unpickled module tree
    (``torch_port.py:154-178``): parameters, then the persistent buffers,
    then the children, depth first."""
    d = vars(node)
    out: Dict[str, Any] = {}
    skip = d.get("_non_persistent_buffers_set") or ()
    for group in ("_parameters", "_buffers"):
        for name, value in (d.get(group) or {}).items():
            if value is not None and name not in skip:
                out[prefix + name] = value
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(_tree_state_dict(child, prefix + name + "."))
    return out


def load_pt(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` (a state_dict or a pickled module, zip or legacy
    format) read through :data:`RESTRICTED_PICKLE` -> the port's
    state_dict: the ``module.`` prefix of ``nn.DataParallel`` stripped and
    the dead center block's ``cblock.`` keys (quirk Q1) dropped. Raises
    ``ValueError`` when the file holds neither a state_dict nor a module,
    or anything but tensors where the state_dict's values are; it never
    loads the file again another way."""
    with warnings.catch_warnings():
        # the legacy format's source check of every module class, which a
        # placeholder has none of
        warnings.simplefilter("ignore")
        loaded = torch.load(path, map_location="cpu", weights_only=False,
                            pickle_module=RESTRICTED_PICKLE)
    if isinstance(loaded, Placeholder):
        sd = _tree_state_dict(loaded)
    elif isinstance(loaded, dict):
        sd = dict(loaded)
    else:
        raise ValueError(f"{path}: holds a {type(loaded).__name__}, neither "
                         "a state_dict nor a pickled module")
    bad = sorted(k for k, v in sd.items() if not isinstance(v, torch.Tensor))
    if bad or not sd:
        raise ValueError(f"{path}: no state_dict could be rebuilt (entries "
                         f"that are not tensors: {bad[:8]})")
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("cblock."):  # quirk Q1: dead center block
            out[k] = v.detach().cpu()
    return out


def is_torch_checkpoint(path: str) -> bool:
    """A reference ``.pt`` file (``checkpoint.is_torch_checkpoint``)."""
    return os.path.isfile(os.path.expanduser(path)) and path.endswith(".pt")


def load_any(path: str) -> Dict[str, torch.Tensor]:
    """Load model weights from a train-state ``.ckpt`` of the port, a flax
    ``.npz`` export or a reference ``.pt`` (state_dict or pickled module;
    each carries its own structure)."""
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
