"""Build the port's CUDA C++ kernels with ``nvcc`` and bind them with ctypes.

Each source under ``ctunet_tpu_torch/csrc/`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface; no PyTorch header is included, so a build takes
seconds. Libraries land in ``ctunet_tpu_torch/_build/`` (git-ignored) under
a name that carries a hash of the sources and flags, so an edited source is
never served by a stale build. Nothing is built at import time: the first
kernel call builds what it needs, and :func:`build` builds several sources
at once (one ``nvcc`` process each, started together).

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, because a refused launch never
runs and ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Sequence

PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
SOURCES = {"conv3d": "conv3d.cu", "maxpool": "maxpool.cu",
           "upconv": "upconv.cu", "conv3d_q": "conv3d_q.cu",
           "upconv_q": "upconv_q.cu", "conv3d_k5": "conv3d_k5.cu",
           "convt": "convt.cu", "conv3d_tc": "conv3d_tc.cu",
           "upconv_tc": "upconv_tc.cu"}
HEADERS = ("common.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``$PATH``, /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "ctunet_tpu_torch are built from csrc/ at first use")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources that have no current build, in parallel.

    Returns ``{name: seconds}`` for what was compiled (an empty dict when
    everything was built already). Raises with nvcc's output on failure.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_target(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    times, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[n] = time.perf_counter() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc {SOURCES[n]} failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills)."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def function(lib: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of library ``lib``, built on first use.

    Pointers and the stream are ``ctypes.c_void_p`` in ``argtypes`` (a bare
    Python int would be cut to 32 bits); the return type is the
    ``cudaError_t`` of the launch.
    """
    key = (lib, symbol)
    if key not in _FNS:
        if lib not in _LIBS:
            build([lib])
            _LIBS[lib] = ctypes.CDLL(_target(lib))
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def check(code: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def stream_args(t) -> tuple:
    """(device index, current-stream handle) of a CUDA tensor for a launch."""
    import torch

    return (t.device.index,
            ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream))
