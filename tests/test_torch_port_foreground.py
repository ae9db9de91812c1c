"""PyTorch port, foreground-crop serving (``b_fg_crop``), K-volume batching
(``i_serve_scan``), the serving-stage profile and the AdaQuant calibration
window, on the CPU against ``ctunet_tpu``.

- ``ops.foreground``'s planner, slices and paste equal
  ``ctunet_tpu.ops.foreground``'s on seeded volumes; ``background_class``
  equals the JAX one on UNetSP with the ``unetsp_10k`` weights.
- The AdaQuant window that ``Model``'s serving loop hands the int8 builder
  equals, element for element, the one ``ctunet_tpu``'s loop builds for
  the same volume and atlas, whole-volume and cropped (the JAX ``Model``
  runs with its initialization and forward stubbed: the window does not
  depend on them).
- ``build_predict_q_opt(calib_batch=...)`` searches on that batch, within
  the ``INT_AGREE`` / ``LOSS_RTOL`` of ``test_torch_port_int8_adaquant.py``
  of the JAX build on the same batch.
- ``Model`` serving shells on 64^3 canvases through the crop and the paste
  at f32 writes the JAX ``Model``'s masks (scan of 3) wherever the f32
  reference decides by more than ``DECIDED``, with ``serve_scan`` 1 and 3,
  and its scan masks are bit-identical to its single dispatch; the
  shipped ``FlapRecSP2O_serve_int8.ini`` serves through the crop, a K-batch
  and the paste on the CPU.
"""

import contextlib
import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu import quant_opt as jopt
from ctunet_tpu import trainer as jtrainer
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu.data.atlas import register_atlas as jax_register_atlas
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import foreground as jfg
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch import quant_opt as topt
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.ops import foreground as tfg
from ctunet_tpu_torch.utils import nifti
from test_torch_port_int8_adaquant import INT_AGREE, LOSS_RTOL, _losses
from test_torch_port_int8_engine import ROOT, skull_and_atlas

torch.set_num_threads(2)

JAX_CKPT = os.path.join(ROOT, ".ckpts", "unetsp_10k")
DECIDED = 1e-3  # |p1 - p0| of the f32 reference above which masks agree


def _volume(case, rng):
    shape = (48, 64, 80)
    vol = np.zeros(shape, np.float32)
    if case == "full":
        vol[:] = 1.0
    elif case == "edge":  # the box touches the canvas on three faces
        vol[:6, 54:, 72:] = rng.random((6, 10, 8)) > 0.3
    elif case != "empty":
        vol[9:21, 13:22, 20:33] = rng.random((12, 9, 13)) > 0.5
    return vol


@pytest.mark.parametrize("case,margin,multiple,min_size", [
    ("empty", 16, 16, None), ("full", 2, 16, None), ("edge", 2, 8, None),
    ("box", 2, 16, None), ("box", 16, 16, None), ("box", 24, 16, None),
    ("box", 2, 4, (24, 24, 40)), ("edge", 3, 2, (16, 16, 16)),
])
def test_plan_slices_and_paste_match_jax(case, margin, multiple, min_size):
    rng = np.random.default_rng(7)
    vol = _volume(case, rng)
    got = tfg.plan_crop(vol, margin, multiple, min_size)
    assert got == jfg.plan_crop(vol, margin, multiple, min_size)
    if got is None:
        assert case in ("empty", "full")
        return
    sl = tfg.crop_slices(*got)
    assert sl == jfg.crop_slices(*got)
    mask = (rng.random((2,) + got[1]) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        tfg.paste_full(mask, got[0], vol.shape, 1),
        jfg.paste_full(mask, got[0], vol.shape, 1))
    assert (vol[sl] != 0).sum() == (vol != 0).sum()


def test_background_class_matches_jax():
    vs = jax_load_any(JAX_CKPT, "UNetSP")
    jm = jax_build_model("UNetSP", compute_dtype="float32",
                         use_checkpoint=False)
    want = jfg.background_class(jax.jit(lambda x: jm.apply(vs, x, False)),
                                (32, 32, 32, 2), jnp.float32)
    model = build_model("UNetSP").eval()
    model.load_state_dict(load_any(UNETSP_10K))
    got = tfg.background_class(model, (32, 32, 32, 2), "cpu")
    assert got == want and len(got) == 2


# --------------------------------------------------------------------------
# Model: the serving loop
# --------------------------------------------------------------------------


def _write_csv(folder, vols, atlas):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, v in enumerate(vols):
        p = os.path.join(folder, f"skull_{i:03d}.nii.gz")
        nifti.write(p, nifti.NiftiImage(v, np.eye(4)))
        paths.append(p)
    csv = os.path.join(folder, "files.csv")
    with open(csv, "w") as f:
        f.write("image,mask\n" + "".join(f"{p},\n" for p in paths))
    register_atlas(vols[0].shape, atlas)
    jax_register_atlas(vols[0].shape, atlas)
    return csv, paths


def _params(root, csv, **extra):
    params = dict(test_flag=True, name="fg", model_class="UNetSP",
                  problem_handler="FlapRecWithShapePriorDoubleOut",
                  device="cpu", workspace_path=str(root / "ws"),
                  test_files_csv=csv, compute_dtype="float32", n_workers=1)
    params.update(extra)
    return params


def _masks(paths, name="fg"):
    out = {}
    for p in paths:
        base = os.path.basename(p)[:-7]
        for sfx in ("sk", "fl"):
            out[(base, sfx)] = nifti.read(os.path.join(
                os.path.dirname(p), f"pred_{name}", f"{base}_{sfx}.nii.gz")
            ).data
    return out


@pytest.mark.parametrize("crop", [False, True])
def test_int8_calib_window_matches_jax(tmp_path, monkeypatch, crop):
    """The window AdaQuant searches on: the margin-16 plan of the served
    volume (its crop at ``fg_margin`` 24, or the whole padded volume),
    stacked with the padded atlas at the same canvas offsets. The port's
    builder gets it as ``calib_batch``, in whole-volume serving too."""
    shape = (64, 96, 96)
    vol = spherical_shell(shape, radius_frac=0.15, center=(24, 30, 66))
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    csv, _ = _write_csv(str(tmp_path / "data"), [vol], atlas)
    extra = dict(use_int8=True, int8_adaquant=True, int8_adaquant_steps=2,
                 fg_crop=crop, fg_margin=24)

    # ctunet_tpu's loop, its model and forward stubbed
    def init(self, load_out=False):
        self._maybe_atlas(self._sample_shape()[0])
        self.models["main"], self._variables = "stub", {"params": {}}

    def make_predict(self, model, variables, compute_dtype, atlas=None):
        return lambda vs, images, offsets=None: (
            jnp.zeros(images.shape + (2,)),) * 2

    monkeypatch.setattr(jtrainer.Model, "initialize_models", init)
    monkeypatch.setattr(jtrainer.Model, "_make_whole_volume_predict",
                        make_predict)
    jm = jtrainer.Model(params=_params(tmp_path / "jax", csv, **extra))
    want = jm._int8_calib_hint

    seen = []

    def capture(model_class, sd, calib, **kw):
        seen.append((tuple(calib.shape), kw.get("calib_batch")))
        raise tq.Unsupported("captured")

    monkeypatch.setattr(tq, "build_predict_q_opt", capture)
    monkeypatch.setattr(tq, "build_predict_q", capture)
    m = Model(params=_params(tmp_path / "port", csv,
                             resume_model=UNETSP_10K, **extra))
    assert m.n_served == 1 and len(seen) == 2  # AdaQuant, then plain int8
    (x_shape, hint), (_, plain) = seen
    assert plain is None and want is not None
    assert hint.dtype == np.float32 and hint.shape == want.shape
    assert hint[0].size < np.prod(x_shape)
    np.testing.assert_array_equal(hint, np.asarray(want))
    assert m.int8_hint_shapes == {x_shape: want.shape[1:]}
    window = (64, 80, 80) if crop else shape
    assert x_shape == window + (2,)


def test_build_predict_q_opt_calib_batch_matches_jax(monkeypatch):
    """The rounding search runs on ``calib_batch`` (a 4-D one a batch of
    one), with the scales calibrated on the calibration volume. The JAX
    build's own two engine builds are stood in for by the port's exported
    scales (as ``test_torch_port_int8_adaquant.py`` feeds both searches):
    what is compared is the search each ``build_predict_q_opt`` runs."""
    vs = jax_load_any(JAX_CKPT, "UNetSP")
    sd = load_any(UNETSP_10K)
    x = skull_and_atlas()
    batch = x[0, :, :, :16]  # (16, 16, 16, 2): 4-D
    scales = {}
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", export_scales=scales)
    runs = {}

    def spy(name, fn):
        def call(*a, **kw):
            runs[name] = {"batch": np.asarray(a[2]), "scales": a[3]}
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = fn(*a, **dict(kw, verbose=True))
            runs[name].update(ropt=out, losses=_losses(buf.getvalue()))
            return out
        return call

    def jax_build(model_class, variables, calib, export_scales=None, **kw):
        if export_scales is not None:
            export_scales.update(scales)

    monkeypatch.setattr(jq, "build_predict_q", jax_build)
    monkeypatch.setattr(jopt, "optimize_rounding",
                        spy("jax", jopt.optimize_rounding))
    monkeypatch.setattr(topt, "optimize_rounding",
                        spy("port", topt.optimize_rounding))
    jq.build_predict_q_opt("UNetSP", vs, jnp.asarray(x[0]), adaquant_steps=3,
                           calib_batch=batch, compute_dtype=jnp.float32)
    fwd = tq.build_predict_q_opt("UNetSP", sd, torch.from_numpy(x[0]),
                                 adaquant_steps=3, calib_batch=batch,
                                 compute_dtype=torch.float32, device="cpu")
    assert fwd.round_opt is runs["port"]["ropt"]
    assert runs["port"]["scales"].keys() == scales.keys()
    for name in runs:
        np.testing.assert_array_equal(runs[name]["batch"], batch[None])
    want, got = runs["jax"]["ropt"], runs["port"]["ropt"]
    assert set(got) == set(want) == set(runs["port"]["losses"])
    same = sum(int((got[t]["q"] == want[t]["q"]).sum()) for t in want)
    total = sum(want[t]["q"].size for t in want)
    assert same / total >= INT_AGREE, same / total
    for tag, (_, best) in runs["port"]["losses"].items():
        np.testing.assert_allclose(best, runs["jax"]["losses"][tag][1],
                                   rtol=LOSS_RTOL, err_msg=tag)


@pytest.fixture(scope="module")
def shells(tmp_path_factory):
    """Four small shells on a 64^3 canvas whose margin-2 plans all have
    the 32^3 size at different offsets, the JAX ``Model``'s masks on them
    (f32, ``serve_scan`` 3: a warm-up dispatch, a scan of 2, a single) and
    the f32 reference's decided voxels on each window."""
    root = tmp_path_factory.mktemp("fg_serve")
    shape = (64, 64, 64)
    centers = [(30, 30, 30), (46, 30, 30), (30, 46, 30), (30, 30, 46)]
    vols = [spherical_shell(shape, radius_frac=0.15, center=c)
            for c in centers]
    atlas = spherical_shell(shape, radius_frac=0.17).astype(np.float32)
    csv, paths = _write_csv(str(root / "data"), vols, atlas)
    plans = [jfg.plan_crop(v, margin=2, multiple=16) for v in vols]
    assert {p[1] for p in plans} == {(32, 32, 32)}
    assert len({p[0] for p in plans}) == 4
    jtrainer.Model(params=_params(root, csv, resume_model=JAX_CKPT,
                                  fg_crop=True, fg_margin=2, serve_scan=3))
    want = _masks(paths)
    vs = jax_load_any(JAX_CKPT, "UNetSP")
    jm = jax_build_model("UNetSP", compute_dtype="float32",
                         use_checkpoint=False)
    apply = jax.jit(lambda x: jm.apply(vs, x, False))
    decided = {}
    for p, v, (offs, size) in zip(paths, vols, plans):
        sl = jfg.crop_slices(offs, size)
        x = np.stack([v[sl], atlas[sl]], -1)[None].astype(np.float32)
        for sfx, prob in zip(("sk", "fl"), apply(jnp.asarray(x))):
            prob = np.asarray(prob[0])
            dec = np.ones(shape, bool)
            dec[sl] = np.abs(prob[..., 1] - prob[..., 0]) > DECIDED
            decided[(os.path.basename(p)[:-7], sfx)] = dec
    return root, csv, paths, want, decided


def test_model_fg_serving_matches_jax_model(shells):
    root, csv, paths, want, decided = shells
    masks = {}
    for scan in (1, 3):
        m = Model(params=_params(root, csv, resume_model=UNETSP_10K,
                                 fg_crop=True, fg_margin=2, serve_scan=scan))
        assert m.n_served == 4
        assert m.scan_batches == ([] if scan == 1 else [2])
        masks[scan] = _masks(paths)
        for key, w in want.items():
            g = masks[scan][key]
            assert g.shape == w.shape == (64, 64, 64)
            dec = decided[key]
            assert dec.mean() > 0.99, key
            np.testing.assert_array_equal(g[dec], w[dec], err_msg=str(key))
            if key[1] == "sk":
                assert g.any()
    for key in masks[1]:  # the scan path writes the single dispatch's
        np.testing.assert_array_equal(masks[3][key], masks[1][key])


def test_serve_profile_stages(shells):
    root, csv, _, _, _ = shells
    m = Model(params=_params(root, csv, resume_model=UNETSP_10K,
                             fg_crop=True, fg_margin=2, serve_scan=4,
                             serve_profile=True, name="prof"))
    prof = m.serve_profile_s
    assert set(prof) == {"decode_wait", "pad", "upload", "dispatch", "wait",
                         "fetch", "write_drain", "other"}
    assert prof["wait"] == 0.0  # no device to wait for on the CPU
    assert all(v >= 0 for k, v in prof.items() if k != "other")
    assert sum(prof.values()) == pytest.approx(m.serve_seconds)
    assert m.scan_batches == [3]
    assert len(glob.glob(os.path.join(os.path.dirname(csv), "pred_prof",
                                      "*.nii.gz"))) == 12


def test_shipped_int8_ini_serves_on_the_cpu(tmp_path):
    """``FlapRecSP2O_serve_int8.ini`` as written, given a test CSV (and the
    CPU, and 2 AdaQuant steps): full-canvas masks through the crop, one
    K-batch and the paste; one int8 engine, its search on the window."""
    from ctunet_tpu_torch import default_params, load_params

    shape = (64, 96, 96)
    vols = [spherical_shell(shape, radius_frac=0.15, center=c) for c in
            ((24, 30, 66), (26, 34, 62), (22, 28, 64), (24, 32, 60))]
    atlas = spherical_shell(shape, radius_frac=0.15, center=(24, 31, 63))
    csv, paths = _write_csv(str(tmp_path / "data"), vols, atlas)
    params = load_params(os.path.join(ROOT, "examples", "UNetSPDO",
                                      "FlapRecSP2O_serve_int8.ini"),
                         default_params())
    params.update(device="cpu", workspace_path=str(tmp_path / "ws"),
                  test_files_csv=csv, resume_model=UNETSP_10K,
                  int8_adaquant_steps=2, n_workers=1)
    m = Model(params=params)
    assert m.n_served == 4 and m.scan_batches == [3]
    (shape_q, window), = m.int8_hint_shapes.items()
    assert shape_q[1] < shape[1] and window is not None
    assert m.int8_engines[shape_q].round_opt is not None
    masks = _masks(paths, "FlapRecSP2O")
    assert all(v.shape == shape for v in masks.values())
    assert all(masks[(os.path.basename(p)[:-7], "sk")].any() for p in paths)
