"""Export the committed orbax checkpoint ``.ckpts/unetsp_10k`` to ``.npz``.

The PyTorch port (``ctunet_tpu_torch``) reads no orbax: this tool restores
the checkpoint with ``ctunet_tpu.checkpoint.load_any`` and writes its
``params`` and ``batch_stats`` trees as one flat ``.npz`` whose keys are
the tree paths joined by ``/`` (``params/unet/d0/unit0/conv/kernel``, ...).
``ctunet_tpu_torch.checkpoint.load_any`` reads that file back and
``ctunet_tpu_torch.models.convert.from_flax`` maps it to a state_dict.

Usage (from the repo root, CPU is enough)::

    JAX_PLATFORMS=cpu python tools/export_unetsp_npz.py \
        [--ckpt .ckpts/unetsp_10k] \
        [--out ctunet_tpu_torch/assets/unetsp_10k.npz]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree, prefix: str = ""):
    """Nested dict of arrays -> {"a/b/c": np.ndarray}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(dict(v), key))
        else:
            out[key] = np.asarray(v)
    return out


def export(ckpt: str, out: str, model_class: str = "UNetSP") -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ctunet_tpu.checkpoint import load_any

    variables = load_any(ckpt, model_class)
    flat = flatten({"params": variables["params"],
                    "batch_stats": variables["batch_stats"]})
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **flat)
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=os.path.join(ROOT, ".ckpts",
                                                   "unetsp_10k"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "ctunet_tpu_torch", "assets", "unetsp_10k.npz"))
    ap.add_argument("--model-class", default="UNetSP")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    flat = export(args.ckpt, args.out, args.model_class)
    n = sum(int(v.size) for k, v in flat.items() if k.startswith("params/"))
    print(f"wrote {args.out}: {len(flat)} arrays, {n} parameters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
