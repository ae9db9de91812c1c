"""ctunet_tpu_torch — the PyTorch / CUDA port of ctunet_tpu for Hopper.

Public API mirrors ``ctunet_tpu`` (and the reference ``ctunet`` package):
``load_params`` parses an INI config, ``Model`` is the config-driven
trainer and predictor entry point. The hot path runs on hand-written Hopper kernels
(``ops/kernels``, sources in ``csrc/``) built with ``nvcc`` at first use.
This package imports ``torch`` and numpy, never JAX or ``ctunet_tpu``.
"""

from .utils.config import default_params, load_params, set_cfg_params
from . import registry, utils

__version__ = "0.1.0"

__all__ = [
    "Model",
    "ops",
    "parallel",
    "default_params",
    "load_params",
    "set_cfg_params",
    "registry",
    "utils",
]


def __getattr__(name):
    # Lazy import: keep `import ctunet_tpu_torch` light (no torch import).
    if name == "Model":
        from .trainer import Model

        return Model
    if name in ("ops", "parallel"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(
        f"module 'ctunet_tpu_torch' has no attribute {name!r}")
