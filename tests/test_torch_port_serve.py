"""PyTorch port, serving path: ``Model`` / CLI end to end on the CPU.

Synthetic skulls (``spherical_shell``, 32^3) go through the port's CLI and
``Model`` test path with the committed ``unetsp_10k`` weights; the written
``pred_<name>/<file>_{sk,fl,i}.nii.gz`` files are held against
``ctunet_tpu``'s f32 ``model.apply`` on the same weights and inputs. The
settings this slice does not serve must raise, and a missing card must be
an error. The engine against ``ctunet_tpu.engine.build_predict(...,
interpret=True)`` is in the slow lane (about 40 s per model here).
``train_flag`` is served since the training slice (its tests are
``test_torch_port_train_*``), the foreground-crop settings (``fg_crop``,
``serve_scan``, ``serve_profile``, ``fg_crop_train``) since the
foreground-crop slice (``test_torch_port_foreground.py``,
``test_torch_port_fg_train.py``).
"""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import codecs as jax_codecs
from ctunet_tpu.ops import postprocess as jax_post
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.data.datasets import NiftiImageDataset
from ctunet_tpu_torch.data.pipeline import HostLoader
from ctunet_tpu_torch.device import resolve_device
from ctunet_tpu_torch.ops import hard_segm, largest_cc
from ctunet_tpu_torch.ops.foreground import crop_slices, plan_crop
from ctunet_tpu_torch.trainer import cli
from ctunet_tpu_torch.utils import nifti

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 32)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    csv = make_dataset(str(root / "data"), n=2, shape=SHAPE, seed=7)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    register_atlas(SHAPE, atlas)
    return root, csv, atlas


@pytest.fixture(scope="module")
def jax_masks(synth):
    """``ctunet_tpu`` f32 ``model.apply`` argmax masks on the same inputs
    and weights (the orbax checkpoint the ``.npz`` was exported from)."""
    _, csv, atlas = synth
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"), "UNetSP")
    m = jax_build_model("UNetSP", compute_dtype="float32",
                        use_checkpoint=False)
    out = {}
    for path in NiftiImageDataset(csv).files:
        vol = nifti.read(path).data.astype(np.float32)
        x = jnp.asarray(np.stack([vol, atlas], -1)[None])
        full, flap = m.apply(vs, x, False)
        name = os.path.basename(path).replace(".nii.gz", "")
        out[name] = {"sk": np.argmax(np.asarray(full[0]), -1),
                     "fl": np.argmax(np.asarray(flap[0]), -1)}
    return out


def _ini(tmp_path, csv, **extra):
    lines = ["[DEFAULT]", "b_train_flag = False", "b_test_flag = True",
             "s_name = port_e2e", "s_model_class = UNetSP",
             "s_problem_handler = FlapRecWithShapePriorDoubleOut",
             f"s_resume_model = {UNETSP_10K}", "[TRAINING]",
             "s_device = cpu", "[PATHS]",
             f"s_workspace_path = {tmp_path / 'ws'}",
             f"s_test_files_csv = {csv}", "[MISC]"]
    lines += [f"{k} = {v}" for k, v in extra.items()]
    path = tmp_path / "serve.ini"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("dtype,use_engine,max_diff", [
    # f32: the port and ctunet_tpu differ only in summation order (~1e-6),
    # so a mask may differ only at an exact near-tie
    ("float32", True, 2),
    # b_use_engine = False: the plain f32 nn.Module forward
    ("float32", False, 2),
    # bf16 engine against the f32 model: boundary voxels flip (11 of ~2000
    # skull voxels at most on these inputs)
    ("bfloat16", True, 32),
])
def test_cli_writes_masks_like_ctunet_tpu(synth, jax_masks, tmp_path,
                                          monkeypatch, dtype, use_engine,
                                          max_diff):
    _, csv, _ = synth
    ini = _ini(tmp_path, csv, s_compute_dtype=dtype,
               b_use_engine=use_engine)
    monkeypatch.setattr(sys, "argv", ["ctunet-tpu-torch", ini])
    cli()
    for path in NiftiImageDataset(csv).files:
        src = nifti.read(path)
        name = os.path.basename(path).replace(".nii.gz", "")
        out_dir = os.path.join(os.path.dirname(path), "pred_port_e2e")
        for sfx in ("sk", "fl"):
            img = nifti.read(os.path.join(out_dir, f"{name}_{sfx}.nii.gz"))
            assert img.data.dtype == np.uint8
            assert img.data.shape == src.data.shape
            np.testing.assert_array_equal(img.affine, src.affine)
            want = jax_masks[name][sfx]
            assert want.any() or sfx == "fl"
            assert int((img.data != want).sum()) <= max_diff, (sfx, dtype)
        copy = nifti.read(os.path.join(out_dir, f"{name}_i.nii.gz"))
        np.testing.assert_array_equal(copy.data, src.data)


def test_model_serves_non_multiple_shapes(tmp_path):
    """Volumes are padded to the pool multiple and the masks cropped back;
    the atlas is padded the same way so it stays registered."""
    shape = (20, 24, 18)
    csv = make_dataset(str(tmp_path / "data"), n=1, shape=shape, seed=3)
    register_atlas(shape, spherical_shell(shape, radius_frac=0.42))
    m = Model(params=dict(
        test_flag=True, name="odd", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(tmp_path / "ws"), test_files_csv=csv,
        resume_model=UNETSP_10K, largest_cc=True))
    assert m.n_served == 1
    files = sorted(glob.glob(str(tmp_path / "data" / "pred_odd" / "*")))
    assert [os.path.basename(f) for f in files] == [
        "skull_000_fl.nii.gz", "skull_000_i.nii.gz", "skull_000_sk.nii.gz"]
    assert nifti.read(files[2]).data.shape == shape


@pytest.mark.parametrize("key,value", [
    ("fg_crop_train", True), ("serve_profile", True), ("fg_crop", True),
    ("serve_scan", 4),
])
def test_fg_and_scan_settings_are_served(tmp_path, key, value):
    """The settings of the foreground-crop slice, once refused, are read
    and served: masks at the canvas shape, the profile's stages, the
    K-batch, the training window."""
    shape = (32, 64, 64)  # the shells' margin-2 windows are smaller
    csv = make_dataset(str(tmp_path / "data"), n=2, shape=shape, seed=3)
    register_atlas(shape, spherical_shell(shape, radius_frac=0.42))
    params = dict(test_flag=True, name="fgs", model_class="UNetSP",
                  problem_handler="FlapRecWithShapePriorDoubleOut",
                  device="cpu", workspace_path=str(tmp_path / "ws"),
                  test_files_csv=csv, resume_model=UNETSP_10K,
                  compute_dtype="float32", fg_margin=2)
    if key == "fg_crop_train":
        params.update(train_flag=True, train_files_csv=csv,
                      validation_files_csv=csv, n_epochs=1, batch_size=1,
                      ce_lambda=1.0, dice_lambda=1.0, resume_model="",
                      fg_train_size="16,16,32")
    params[key] = value
    m = Model(params=params)
    assert m.n_served == 2
    files = sorted(glob.glob(str(tmp_path / "data" / "pred_fgs" / "*")))
    assert len(files) == 6
    assert all(nifti.read(f).data.shape == shape for f in files)
    if key == "fg_crop_train":
        assert m.fg_train_size == (16, 16, 32)
        assert m.writer.history["val/epoch/fg_lost_voxels"][-1][1] >= 0
    elif key == "serve_profile":
        assert set(m.serve_profile_s) >= {"decode_wait", "dispatch", "wait",
                                          "fetch", "other"}
    elif key == "serve_scan":
        assert m.scan_batches == [1]  # the warm-up dispatch, then 1
    else:  # served on the crop: outside it, the fill class
        vol = nifti.read(files[1]).data
        offs, size = plan_crop(vol, margin=2, multiple=16)
        sk = nifti.read(files[2]).data
        out = np.ones(shape, bool)
        out[crop_slices(offs, size)] = False
        assert out.any() and len(np.unique(sk[out])) == 1


@pytest.mark.parametrize("key,value", [
    ("patch_inference", True), ("distributed", True),
    ("mesh_data", 2), ("mesh_spatial", 2), ("profile_dir", "trace"),
])
def test_unported_settings_raise(tmp_path, monkeypatch, key, value):
    """Every setting is served now: ``patch_inference``
    (``test_torch_port_sliding_window.py``), ``profile_dir``
    (``test_torch_port_param_dtype.py`` checks its trace). The
    multi-device keys need ranks: ``b_distributed`` without a coordinator,
    world or rank raises ``ValueError`` naming the missing key (the port has
    no automatic discovery), and a mesh above 1x1 in one process raises the
    one-process-per-device ``ValueError``
    (``test_torch_port_dp.py`` runs them over ranks)."""
    for env in ("CTUNET_COORDINATOR", "CTUNET_NUM_PROCESSES",
                "CTUNET_PROCESS_ID"):
        monkeypatch.delenv(env, raising=False)
    params = dict(test_flag=False, name="x", model_class="UNetSP",
                  problem_handler="FlapRecWithShapePriorDoubleOut",
                  device="cpu", workspace_path=str(tmp_path))
    params[key] = value
    if key in ("patch_inference", "profile_dir"):
        assert Model(params=params).params[key] == value
        return
    match = ("dist_coordinator" if key == "distributed"
             else "one process per device")
    with pytest.raises(ValueError, match=match):
        Model(params=params)


def test_unported_model_family_raises(synth, tmp_path):
    """UNetSPSmall serves through ``Model`` from its own weights (padded
    to its pool multiple, 32); the 4-block UNetSP weights do not load into
    it."""
    from ctunet_tpu_torch.checkpoint import UNETSPSMALL_3K

    _, csv, _ = synth
    params = dict(
        test_flag=True, name="x5", model_class="UNetSPSmall",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(tmp_path), test_files_csv=csv,
        resume_model=UNETSPSMALL_3K)
    m = Model(params=params)
    assert m.n_served == 2 and m.pool_multiple == 32
    fl = glob.glob(os.path.join(os.path.dirname(csv), "pred_x5",
                                "*_fl.nii.gz"))
    assert len(fl) == 2 and nifti.read(fl[0]).data.shape == SHAPE
    with pytest.raises(RuntimeError, match="d_blocks.4"):
        Model(params=dict(params, resume_model=UNETSP_10K))


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device("tpu").type == "cuda"
        return
    # no card: the entry points refuse instead of moving to the CPU
    for name in (None, "cuda", "gpu", "tpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(name)


def test_model_without_card_raises_unless_cpu(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _, csv, _ = synth
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(params=dict(
            test_flag=True, name="x", model_class="UNetSP",
            problem_handler="FlapRecWithShapePriorDoubleOut", device="tpu",
            workspace_path=str(tmp_path), test_files_csv=csv,
            resume_model=UNETSP_10K))
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.build_predict("UNetSP", load_any(UNETSP_10K))


def test_codecs_and_postprocess_match(rng):
    p = rng.random((2, 5, 6, 7, 3)).astype(np.float32)
    p[0, 0, 0, 0] = (0.5, 0.5, 0.1)  # tie: first index, like argmax
    np.testing.assert_array_equal(
        hard_segm(torch.from_numpy(p), keep_dims=True).numpy(),
        np.asarray(jax_codecs.hard_segm(jnp.asarray(p), keep_dims=True)))
    mask = (rng.random((12, 12, 12)) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(largest_cc(mask), jax_post.largest_cc(mask))


def test_host_loader_order_and_csv(synth):
    _, csv, _ = synth
    ds = NiftiImageDataset(csv)
    import pandas as pd

    assert ds.files == list(pd.read_csv(csv).iloc[:, 0])
    batches = list(HostLoader(ds, batch_size=1, n_workers=2))
    assert [b["filepath"][0] for b in batches] == ds.files
    assert batches[0]["image"].shape == (1,) + SHAPE
    assert batches[0]["image"].dtype == np.float32


@pytest.mark.slow
@pytest.mark.parametrize("name,in_ch", [("UNetSP", 2), ("UNetDO", 1)])
def test_engine_matches_jax_engine_interpret(rng, name, in_ch):
    """The port's engine (plain path, f32) against ``ctunet_tpu``'s fused
    engine with its Pallas kernels in interpret mode, same weights."""
    from ctunet_tpu import engine as jax_engine
    from ctunet_tpu_torch.models.convert import from_flax

    shape = (16, 16, 32)
    m = jax_build_model(name, compute_dtype="float32", use_checkpoint=False)
    vs = jax.jit(m.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *shape, in_ch)), False)
    stats = jax.tree.map(lambda s: s * 1.05 + 0.01, vs["batch_stats"])
    vs = {"params": vs["params"], "batch_stats": stats}
    x = rng.random((1, *shape, in_ch)).astype(np.float32)
    want = jax_engine.build_predict(name, vs, compute_dtype=jnp.float32,
                                    interpret=True)(jnp.asarray(x))
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), vs)
    sd = from_flax(np_tree["params"], np_tree["batch_stats"])
    got = tengine.build_predict(name, sd, torch.float32, device="cpu")(
        torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-3)
