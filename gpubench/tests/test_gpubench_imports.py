"""What the benchmark loads: never JAX, its kin or the JAX package; the
reference nothing of the package under test either; and no run without a
CUDA card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "ctunet_tpu"}
GPUBENCH = os.path.join(ROOT, "gpubench")


def _modules(code: str):
    """Top-level names of every module loaded after running ``code`` in a
    fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A whole serving and training run on the CPU at a small size,
    through the harness that ``run.py`` calls, then its own check."""
    loaded = _modules(
        "import time, torch\n"
        "from gpubench import harness, run\n"
        "for cell in ('unetspsmall.serve', 'unetsp.train'):\n"
        "    harness.run_cell(cell, 5, 0.2, True, torch.device('cpu'),\n"
        "                     time.perf_counter(), canvas=(32, 32, 32))\n"
        "assert run.forbidden_loaded() == []\n")
    assert "ctunet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_package():
    loaded = _modules("import gpubench.reference.unet, "
                      "gpubench.reference.train, "
                      "gpubench.reference.precision")
    assert not loaded & (FORBIDDEN | {"ctunet_tpu_torch"})


def test_no_benchmark_source_imports_a_forbidden_module():
    for dp, _, files in os.walk(GPUBENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dp, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module] if node.level == 0 else []
                tops = {n.split(".")[0] for n in names}
                assert not tops & FORBIDDEN, (f, tops)
                if "reference" in dp:
                    assert "ctunet_tpu_torch" not in tops, f


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, ROOT)
    from gpubench import run

    sys.modules.setdefault("ctunet_tpu_torch_probe", sys)
    assert "ctunet_tpu" not in run.forbidden_loaded()


def test_run_exits_without_a_result_where_there_is_no_card():
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "unetsp.serve",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert "{" not in out.stdout
