"""PyTorch port, reference ``.pt`` files on the CPU: pickled ``nn.Module``
trees read by the restricted unpickler of ``checkpoint.py``.

The reference saves state_dicts and loads whole pickled modules too
(``Model.py:464-472``). Fixtures: UNetSP, UNetSPSmall and UNet4_2IC with
seeded weights, saved by ``torch.save(module)`` with every class of the
port's tree renamed into ``ctunet.pytorch.models`` (a module that exists
only while the file is written), in torch's zip and legacy formats, bare
and inside ``nn.DataParallel`` (``chip_smoke.save_reference_pt``, whose
files phase 11 serves on the card). Each must load, through ``load_any``,
to exactly the tensors of the same weights' state_dict file and of
``from_flax(ctunet_tpu.models.torch_port.load_torch_checkpoint(...))``
(which unpickles with the real classes, so ``reference_classes`` installs
the fake module for it). A file whose pickle calls ``os.system``,
``builtins.exec`` or ``builtins.getattr`` must raise and run nothing.
"""

import os
import pickle
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch import nn

from chip_smoke import reference_classes, save_reference_pt
from ctunet_tpu.models.torch_port import (_load_state_dict_torch_free,
                                          load_torch_checkpoint)
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import checkpoint as ckpt
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax
from ctunet_tpu_torch.utils import nifti
from test_torch_port_legacy_model import seeded_state_dict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    return {mc: seeded_state_dict(mc, seed=i) for i, mc in
            enumerate(("UNetSP", "UNetSPSmall", "UNet4_2IC"))}


@pytest.mark.parametrize("data_parallel", [False, True])
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("model_class", ["UNetSP", "UNetSPSmall",
                                         "UNet4_2IC"])
def test_pickled_module_loads_as_its_state_dict(tmp_path, weights,
                                                model_class, legacy,
                                                data_parallel):
    sd = weights[model_class]
    model = build_model(model_class)
    model.load_state_dict(sd)
    p_mod = str(tmp_path / "module.pt")
    p_sd = str(tmp_path / "state_dict.pt")
    save_reference_pt(model, p_mod, legacy, data_parallel)
    torch.save(sd, p_sd)
    assert "ctunet" not in sys.modules  # the classes are not importable
    got = load_any(p_mod)
    assert "ctunet" not in sys.modules  # and were not imported
    want = load_any(p_sd)
    assert list(got) == list(want) == list(model.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    # the JAX package's conversion, its torch.load given the real classes
    with reference_classes(model):
        jax_vars = load_torch_checkpoint(p_mod, model_class)
    jax_sd = from_flax(jax_vars["params"], jax_vars["batch_stats"])
    assert set(jax_sd) == set(got)
    for k, v in jax_sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_sequential_fixture_matches_the_torch_free_reader(tmp_path):
    """The fixture of ``tests/test_round2_fixes.py``: torch classes only,
    zip format, module and state_dict files."""
    m = nn.Sequential(nn.Conv3d(2, 3, 3, bias=False), nn.BatchNorm3d(3),
                      nn.Linear(4, 5))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(np.random.default_rng(0).standard_normal(
                p.shape).astype(np.float32)))
    ref = m.state_dict()
    for kind, obj in (("module", m), ("state_dict", ref)):
        path = str(tmp_path / f"{kind}.pt")
        torch.save(obj, path)
        got = ckpt.load_pt(path)
        assert list(got) == list(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (kind, k)
        free = _load_state_dict_torch_free(path)
        for k, v in free.items():
            np.testing.assert_array_equal(got[k].numpy(), v)


def test_non_persistent_buffers_are_left_out(tmp_path):
    m = nn.Sequential(nn.Conv3d(1, 2, 1))
    m[0].register_buffer("scratch", torch.ones(3), persistent=False)
    m[0].register_buffer("kept", torch.arange(4.0))
    path = str(tmp_path / "m.pt")
    torch.save(m, path)
    got = ckpt.load_pt(path)
    assert list(got) == list(m.state_dict()) == ["0.weight", "0.bias",
                                                 "0.kept"]


SENTINEL = "ran.txt"
PAYLOADS = {
    # os.system("touch <sentinel>")
    "os.system": "cos\nsystem\n(Vtouch {s}\ntR.",
    # builtins.exec("open(<sentinel>, 'w').close()")
    "builtins.exec": "cbuiltins\nexec\n(Vopen('{s}', 'w').close()\ntR.",
    # getattr(__import__('os'), 'system')("touch <sentinel>")
    "builtins.getattr": ("cbuiltins\ngetattr\n(cbuiltins\n__import__\n(Vos\n"
                         "tRVsystem\ntR(Vtouch {s}\ntR."),
}


def _hostile(tmp_path, payload: bytes) -> str:
    """A zip ``.pt`` whose ``data.pkl`` is ``payload``, the rest of the
    archive as ``torch.save`` wrote it."""
    ok, bad = str(tmp_path / "ok.pt"), str(tmp_path / "bad.pt")
    torch.save({"w": torch.ones(2)}, ok)
    with zipfile.ZipFile(ok) as src, zipfile.ZipFile(bad, "w") as dst:
        for info in src.infolist():
            data = src.read(info.filename)
            dst.writestr(info.filename, payload
                         if info.filename.endswith("/data.pkl") else data)
    return bad


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_hostile_pickle_raises_and_runs_nothing(tmp_path, name):
    sentinel = str(tmp_path / SENTINEL)
    payload = PAYLOADS[name].format(s=sentinel).encode()
    if name == "builtins.exec":  # the payload is live under plain pickle
        pickle.loads(payload)
        assert os.path.exists(sentinel)
        os.remove(sentinel)
    bad = _hostile(tmp_path, payload)
    with pytest.raises((ValueError, TypeError)):
        load_any(bad)
    assert not os.path.exists(sentinel)


def test_model_serves_a_pickled_module_as_the_npz(tmp_path):
    """``Model``'s serving load: the committed weights as a pickled
    reference module in ``nn.DataParallel`` (legacy format) serve the same
    masks as the ``.npz``."""
    shape = (16, 16, 32)
    csv = make_dataset(str(tmp_path / "data"), n=1, shape=shape, seed=3)
    register_atlas(shape, spherical_shell(shape, radius_frac=0.42))
    model = build_model("UNetSP")
    model.load_state_dict(load_any(UNETSP_10K))
    pt = str(tmp_path / "unetsp_10k_module.pt")
    save_reference_pt(model, pt, legacy=True, data_parallel=True)
    masks = {}
    for name, weights in (("npz", UNETSP_10K), ("pt", pt)):
        Model(params=dict(
            test_flag=True, name=name, model_class="UNetSP",
            problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
            workspace_path=str(tmp_path / "ws"), test_files_csv=csv,
            resume_model=weights))
        out = os.path.join(os.path.dirname(csv), f"pred_{name}")
        masks[name] = {f: nifti.read(os.path.join(out, f)).data
                       for f in sorted(os.listdir(out))}
    assert len(masks["npz"]) == 3
    for a, b in zip(masks["npz"].values(), masks["pt"].values()):
        np.testing.assert_array_equal(a, b)
