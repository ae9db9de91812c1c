"""What the systems under test share: the package's parameters from a
configuration, the benchmark's spans, the reference's precision, the set-up
clock, and the kind of loop a traffic mix drives.

A mix names its ``kind``; the loop of that kind is
``gpubench/kinds/<kind>.py``, found by that name and path, whose ``System``
is built as ``System(cfg, mix, seed, device, canvas)`` and offers
``window(seconds=None, count=None)``, ``release()``, ``check()`` and
``setup_stages``. A new kind of traffic is a new file there.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kind(name: str, root: str = ROOT):
    """The module ``gpubench/kinds/<name>.py`` under ``root``."""
    path = os.path.join(root, "gpubench", "kinds", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no loop of kind {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "gpubench_kind_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span(name: str):
    """A ``record_function`` span while a profiler runs, else nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Seconds of set-up by stage: ``with stages("model"): ...``."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)


def build_kernels(device) -> None:
    """Build every CUDA source of the package that has no current build
    (in parallel, into the package's own ``_build/``), so that the
    checkout's first run compiles in one stage of set-up of its own and
    not inside the warm-up's first calls. Nothing on the CPU."""
    if device.type != "cuda":
        return
    from ctunet_tpu_torch.ops.kernels import build

    build.build()


@contextlib.contextmanager
def reference_precision():
    """Full f32 products for the reference: TF32 off, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def program_params(cfg: Dict, device: torch.device, workspace: str) -> Dict:
    """The package's parameters for ``cfg``: its defaults, then the
    configuration's INI settings as written, on ``device``."""
    from ctunet_tpu_torch.utils import default_params

    p = default_params()
    p.update(cfg["settings"])
    p.update(train_flag=False, test_flag=False, name=cfg["name"],
             device="cpu" if device.type == "cpu" else "cuda",
             workspace_path=workspace)
    return p


def refuse(params: Dict, unfollowed: Dict[str, object]) -> None:
    """Raise where ``params`` sets a key of ``unfollowed`` away from the
    value given there: the loop does not follow that setting, and would
    measure another path under the cell's name."""
    bad = [k for k, v in unfollowed.items() if (params.get(k) or v) != v]
    if bad:
        raise NotImplementedError(
            "this loop does not follow the setting(s) "
            + ", ".join(f"{k} = {params.get(k)!r}" for k in bad)
            + "; add a kind of loop that does")


def release_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile, interpolated between order statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    return statistics.quantiles(v, n=100, method="inclusive")[
        int(round(q * 100)) - 1]


def flat(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays by ``a/b/c`` names."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out
