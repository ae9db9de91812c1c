"""Explicit name registries for models and problem handlers.

The reference binds config strings to classes with ``eval()``
(``ctunet/pytorch/Model.py:101,485-488``). We keep the same composition shape
(config names a model class and a problem handler by string) but resolve
through explicit registries — no arbitrary code execution, and third-party
code can register its own entries. The PyTorch port's own copy of
``ctunet_tpu/registry.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

MODEL_REGISTRY: Dict[str, Callable] = {}
PROBLEM_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    """Class decorator adding a zero-arg model constructor to the registry."""

    def wrap(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return wrap


def register_problem(name: str):
    """Class decorator adding a problem handler to the registry."""

    def wrap(cls):
        PROBLEM_REGISTRY[name] = cls
        return cls

    return wrap


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model class '{name}'. Registered: "
            f"{sorted(MODEL_REGISTRY)}"
        ) from None


def get_problem(name: str):
    try:
        return PROBLEM_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown problem handler '{name}'. Registered: "
            f"{sorted(PROBLEM_REGISTRY)}"
        ) from None
