"""PyTorch port, the multi-tensor Adam kernel ``csrc/adam_mt.cu``
(``ops/kernels/adam.py``) and the optimizer's choice of executor.

- **The rule** (``steps.kernel_leaf``): an f32 ``adam`` or ``adamw`` leaf
  off the CPU takes the kernel; the CPU, bf16 and f16 leaves, ``rmsprop``
  and ``sgd`` take the per-leaf ``Optimizer._update``.
- **Routing on a patched card**: ``meta`` tensors pass the device check and
  ``build.function`` records each launch. A mixed model's f32 leaves go to
  the kernel in one launch per table, its bf16 leaves one at a time, a leaf
  without a gradient nowhere, and the step's two counters say so; CPU
  leaves never reach the kernel. The wrapper refuses what it cannot
  update: a size, dtype or list count that does not match, a strided
  tensor, CPU tensors.
- **The packing** (``adam.pack``, ``adam.table``): leaves in order, every
  table within ``LEAVES`` leaves, ``BLOCKS`` blocks and the 4 KB of a
  launch's parameters, every element of every leaf in exactly one block,
  the table laid out as the source declares it.
- **On the card** (marker ``card``; skipped without one): the kernel
  against its plain version, the per-leaf path on the same card, over five
  steps with a state-dict round trip after the second: equal bit for bit.
"""

import copy
import ctypes
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ctunet_tpu_torch import steps
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import adam, build
from ctunet_tpu_torch.utils import profiling

CHUNK, LEAVES, BLOCKS = adam.CHUNK, adam.LEAVES, adam.BLOCKS
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "ctunet_tpu_torch",
                   "csrc", "adam_mt.cu")

CASES = {
    "adam": dict(name="adam", lr=1e-2),
    "adam_l2": dict(name="adam", lr=1e-2, weight_decay=0.05),
    "adamw": dict(name="adamw", lr=1e-2, weight_decay=0.05),
    "adamw_no_decay": dict(name="adamw", lr=1e-3),
    "adam_scaled": dict(name="adam", lr=1e-2, scheduler=True),
    "adamw_scaled": dict(name="adamw", lr=1e-2, weight_decay=0.05,
                         scheduler=True),
}


# --------------------------------------------------------------------------
# the rule
# --------------------------------------------------------------------------


def _leaf(device="cuda", dtype=torch.float32):
    """A stand-in leaf with the attributes the rule reads."""
    return SimpleNamespace(is_cpu=device == "cpu", dtype=dtype)


RULE = {
    "cuda f32 adam": (_leaf(), "adam", True),
    "cuda f32 adamw": (_leaf(), "adamw", True),
    "cpu f32 adam": (_leaf("cpu"), "adam", False),
    "cuda bf16 adam": (_leaf(dtype=torch.bfloat16), "adam", False),
    "cuda f16 adamw": (_leaf(dtype=torch.float16), "adamw", False),
    "cuda f32 rmsprop": (_leaf(), "rmsprop", False),
    "cuda f32 sgd": (_leaf(), "sgd", False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_kernel_leaf_rule(case):
    p, name, want = RULE[case]
    assert steps.kernel_leaf(p, name) is want


# --------------------------------------------------------------------------
# routing on a patched card
# --------------------------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    """A card that launches nothing (``tests/test_torch_port_maxpool_rows``'s
    fixture): ``meta`` tensors pass the device check, ``build.function``
    records each call's block count."""
    asked = []

    def function(lib, symbol, argtypes):
        def call(*args):
            asked.append((lib, symbol, args[1]))
            return 0
        return call

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(adam, "_require_cuda", lambda t, what: None)
    kernels.reset_launches()
    return asked


@pytest.fixture
def card_tables(card, monkeypatch):
    """The patched card, keeping each launch's table bytes and block
    count."""
    tables = []

    def function(lib, symbol, argtypes):
        def call(*args):
            tables.append((ctypes.string_at(args[0], adam.TABLE_BYTES),
                           args[1]))
            return 0
        return call

    monkeypatch.setattr(build, "function", function)
    return tables


def _meta_leaves(sizes, dtype, grads=True):
    out = []
    for n in sizes:
        p = torch.nn.Parameter(torch.empty(n, dtype=dtype, device="meta"))
        if grads:
            p.grad = torch.empty(n, dtype=dtype, device="meta")
        out.append(p)
    return out


@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop", "sgd"])
def test_mixed_model_routes_each_leaf_and_counts(card, name):
    f32 = _meta_leaves([1, 7, 4097, 3 * CHUNK + 5] + [9] * LEAVES,
                       torch.float32)
    bf16 = _meta_leaves([5, 300], torch.bfloat16)
    idle = _meta_leaves([11], torch.float32, grads=False)
    opt = steps.Optimizer(f32 + bf16 + idle, name=name, lr=1e-3,
                          momentum=0.9)
    profiling.reset()
    with profiling.recording():
        opt.step()
        opt.step()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    kernel = name in ("adam", "adamw")
    fused = len(f32) if kernel else 0
    assert counters["ctunet.train.optimizer.fused_leaves"] == 2 * fused
    assert counters["ctunet.train.optimizer.plain_leaves"] == 2 * (
        len(f32) + len(bf16) - fused)
    plan = adam.pack([p.numel() for p in f32]) if kernel else []
    assert len(plan) == (2 if kernel else 0)  # the leaves fill two tables
    assert card == 2 * [("adam_mt", "ctunet_adam_mt", len(t.block_leaf))
                        for t in plan]
    assert kernels.launches()["adam_mt"] == 2 * len(plan)
    assert not opt.state[idle[0]]
    if kernel:  # the kernel's leaves hold their moments from the first step
        mu = opt.state[f32[2]]["mu"]
        assert set(opt.state[f32[2]]) == {"mu", "nu", "nu_max"}
        opt.step()
        assert opt.state[f32[2]]["mu"] is mu


def _refusal(case):
    """``(arguments of adam_mt, the error's words)`` of a refused call."""
    p = _meta_leaves([8], torch.float32)
    k = adam.constants("adam", 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, 1.0)
    short = torch.empty(7, device="meta")
    strided = torch.empty(8, 2, device="meta")[:, 0]
    if case == "a short grad":
        return (p, [short], [short], [short], [short], k), "size"
    if case == "an f16 grad":
        half = torch.empty(8, dtype=torch.float16, device="meta")
        return (p, [half], p, p, p, k), "f32"
    if case == "four lists":
        return (p, [], p, p, p, k), "five lists"
    if case == "a strided grad":
        return (p, [strided], p, p, p, k), "contiguous"
    if case == "a strided moment":
        return (p, p, p, [strided], p, k), "contiguous"
    raise KeyError(case)


@pytest.mark.parametrize("case", ["a short grad", "an f16 grad",
                                  "four lists", "a strided grad",
                                  "a strided moment"])
def test_wrapper_refuses_mismatched_leaves(card, case):
    args, words = _refusal(case)
    with pytest.raises(ValueError, match=words):
        adam.adam_mt(*args)
    assert card == []


def test_constants_refuse_other_optimizers():
    with pytest.raises(ValueError, match="adam or adamw"):
        adam.constants("sgd", 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.1, 1.0)


def test_wrapper_refuses_cpu_tensors():
    p = [torch.zeros(8)]
    k = adam.constants("adam", 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        adam.adam_mt(p, p, p, p, p, k)


def test_strided_gradient_on_the_card_raises_in_the_step(card):
    p = _meta_leaves([8, 16], torch.float32)
    p[1].grad = torch.empty(16, 2, device="meta")[:, 0]
    opt = steps.Optimizer(p, name="adamw", lr=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        opt.step()
    assert card == []


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_cpu_leaves_take_the_per_leaf_update(card, name):
    p = [torch.nn.Parameter(torch.ones(n)) for n in (1, 7, 300)]
    for t in p:
        t.grad = torch.full_like(t, 0.5)
    opt = steps.Optimizer(p, name=name, lr=1e-2, weight_decay=0.01)
    profiling.reset()
    with profiling.recording():
        opt.step()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["ctunet.train.optimizer.plain_leaves"] == 3
    assert counters["ctunet.train.optimizer.fused_leaves"] == 0
    assert card == [] and kernels.launches()["adam_mt"] == 0
    assert all((t.detach() < 1).all() for t in p)


# --------------------------------------------------------------------------
# the packing
# --------------------------------------------------------------------------

PACKS = {
    "one element": [1],
    "seven": [7],
    "a chunk and one": [CHUNK + 1],
    "mixed with empty": [1, 0, 7, 4097, 3 * CHUNK + 5, 0, 2],
    "more leaves than a table": [3] * (2 * LEAVES + 5),
    "more chunks than a map": [BLOCKS * CHUNK + 9, 5],
    "full map then a leaf": [(BLOCKS - 1) * CHUNK, CHUNK + 1, 1],
    "unetsp": "UNetSP",
    "unetspsmall": "UNetSPSmall",
}


def _numels(case):
    spec = PACKS[case]
    if isinstance(spec, str):
        from ctunet_tpu_torch.models import build_model

        return [p.numel() for p in build_model(spec).parameters()]
    return spec


@pytest.mark.parametrize("case", sorted(PACKS))
def test_pack_keeps_order_and_covers_every_element_once(case):
    numels = _numels(case)
    plan = adam.pack(numels)
    seen = [np.zeros(n, np.int64) for n in numels]
    last = -1
    for launch in plan:
        assert 0 < len(launch.leaves) <= LEAVES
        assert 0 < len(launch.block_leaf) <= BLOCKS
        assert len(launch.block_chunk) == len(launch.block_leaf)
        assert launch.leaves == sorted(set(launch.leaves))
        assert launch.leaves[0] >= last  # a cut leaf goes on, in order
        last = launch.leaves[-1]
        assert sorted(set(launch.block_leaf)) == list(
            range(len(launch.leaves)))
        for slot, c in zip(launch.block_leaf, launch.block_chunk):
            i = launch.leaves[slot]
            assert 0 <= c * CHUNK < numels[i]
            seen[i][c * CHUNK:(c + 1) * CHUNK] += 1
    assert all((s == 1).all() for s in seen)
    assert len(plan) == max(
        -(-sum(-(-n // CHUNK) for n in numels) // BLOCKS),
        -(-sum(1 for n in numels if n) // LEAVES))
    if case == "unetsp":  # 58 leaves: two launches a step
        assert len(numels) == 58 and len(plan) == 2


def _source_constants():
    with open(SRC) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (MT_\w+) = (\d+);", src))
    struct = re.search(r"struct Table \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)\[MT_(LEAVES|BLOCKS)\];", struct)
    return {k: int(v) for k, v in consts.items()}, fields


def test_table_layout_matches_the_kernel_source(card_tables):
    consts, fields = _source_constants()
    assert (consts["MT_LEAVES"], consts["MT_BLOCKS"], consts["MT_CHUNK"]) \
        == (LEAVES, BLOCKS, CHUNK)
    assert fields == [("p", "LEAVES"), ("g", "LEAVES"), ("mu", "LEAVES"),
                      ("nu", "LEAVES"), ("nu_max", "LEAVES"),
                      ("numel", "LEAVES"), ("block_chunk", "BLOCKS"),
                      ("block_leaf", "BLOCKS")]
    # a launch's parameters: the table and eleven 4-byte constants in 4 KB
    assert len(adam.Constants._fields) == 11
    assert adam.TABLE_BYTES + 11 * 4 <= 4096
    # the table a launch hands over, read back at the source's offsets
    sizes = [3, CHUNK + 2, 1]
    ts = [[torch.empty(n, device="meta") for n in sizes] for _ in range(5)]
    k = adam.constants("adam", 1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, 1.0)
    ptrs = [[1000 * r + 16 * i for i in range(3)] for r in range(5)]
    for r, lst in enumerate(ts):  # meta tensors: pointers of our own
        for i, t in enumerate(lst):
            t.data_ptr = lambda v=ptrs[r][i]: v
    adam.adam_mt(*ts, k)
    (buf, blocks), = card_tables
    assert blocks == 4 and len(buf) == adam.TABLE_BYTES
    buf = np.frombuffer(buf, np.uint8)
    got = buf[:40 * LEAVES].view(np.uint64).reshape(5, LEAVES)
    assert got[:, :3].tolist() == ptrs and not got[:, 3:].any()
    assert list(buf[40 * LEAVES:48 * LEAVES].view(np.int64)[:4]) == \
        sizes + [0]
    at = 48 * LEAVES
    assert list(buf[at:at + 4 * BLOCKS].view(np.int32)[:5]) == [0, 0, 1, 0,
                                                               0]
    assert list(buf[at + 4 * BLOCKS:at + 4 * BLOCKS + 5]) == [0, 1, 1, 2, 0]


def test_constants_round_as_aten_on_the_card():
    bc1, bc2 = steps._bias_correction(0.9, 3), steps._bias_correction(
        0.999, 3)
    k = adam.constants("adamw", 3e-4, 0.9, 0.999, 1e-8, 0.01, bc1, bc2, 0.1)
    assert k.flags == adam.DECOUPLED | adam.SCALED
    assert k.c1 == float(np.float32(1 - 0.9)) and k.neg_lr == float(
        np.float32(-3e-4))
    assert k.inv_bc1 == float(np.float32(1) / np.float32(bc1))
    for v in k[:-1]:
        assert float(np.float32(v)) == v
    assert adam.constants("adam", 1e-3, 0.9, 0.999, 1e-8, 0.01, bc1, bc2,
                          1.0).flags == adam.L2
    assert adam.constants("adam", 1e-3, 0.9, 0.999, 1e-8, 0.0, bc1, bc2,
                          1.0).flags == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _series(n_steps, sizes, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    grads = [[(rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 0)).astype(
        np.float32) for n in sizes] for _ in range(n_steps)]
    return params, grads


def _optimizer(case, params, device):
    cfg = dict(CASES[case])
    p = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(device))
         for a in params]
    opt = steps.Optimizer(p, **cfg)
    if cfg.get("scheduler"):  # a reduced plateau scale from the start
        opt.param_groups[0]["plateau"]["scale"] = 0.1
    return p, opt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


# leaves of 1, 7 and 4097 elements, one over a chunk, one over a block
# map, and enough small ones to overflow a table; the last has no gradient
CARD_SIZES = (1, 7, 4097, 2 * CHUNK + 3, BLOCKS * CHUNK + 5) + (33,) * LEAVES


def _run(case, params, grads, device, route, resume_at=None):
    """Parameters and moments after the steps; ``route`` "kernel" or
    "plain" (the per-leaf path on the same device)."""
    p, opt = _optimizer(case, params, device)
    for step, g in enumerate(grads):
        if step == resume_at:  # a state-dict round trip mid-run
            saved = copy.deepcopy(opt.state_dict())
            p = [torch.nn.Parameter(t.detach().clone()) for t in p]
            opt = steps.Optimizer(p, **CASES[case])
            opt.load_state_dict(saved)
        for t, gi in zip(p[:-1], g):
            t.grad = torch.from_numpy(gi.copy()).to(device)
        if route == "plain":
            group = opt.param_groups[0]
            group["count"] += 1
            scale = (opt._plateau_scale(group["plateau"], 1.0)
                     if group["plateau"] is not None else 1.0)
            with torch.no_grad():
                for t in p[:-1]:
                    opt._update(t, group, group["count"], group["name"],
                                scale)
        else:
            opt.step(value=torch.tensor(1.0))
    return [[t.detach().cpu() for t in p]] + [
        [opt.state[t][k].cpu() for t in p[:-1]]
        for k in ("mu", "nu", "nu_max")], opt, p


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_the_per_leaf_path_on_the_card(cuda, case):
    params, grads = _series(5, CARD_SIZES, seed=4)
    grads = [g[:-1] for g in grads]
    kernels.reset_launches()
    got, opt, p = _run(case, params, grads, cuda, "kernel", resume_at=2)
    torch.cuda.synchronize(cuda)
    want, _, _ = _run(case, params, grads, cuda, "plain")
    for kind, a, b in zip(("param", "mu", "nu", "nu_max"), got, want):
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), f"{case}: {kind} of leaf {i}"
    assert not opt.state[p[-1]]
    n_launches = len(adam.pack([t.numel() for t in p[:-1]]))
    assert kernels.launches()["adam_mt"] == 5 * n_launches
