"""PyTorch port, sliding-window inference (``b_patch_inference``) on the CPU
against ``ctunet_tpu``.

- ``patch_starts``, ``grid_starts`` and ``gaussian_window`` equal
  ``ctunet_tpu.ops.sliding_window``'s exactly.
- The blend equals the JAX ``make_sliding_window_fn`` value for value on
  the same per-patch outputs (an elementwise forward both libraries
  compute exactly), for ``patch_batch`` 1 and for a K whose grid the JAX
  scan pads with zero-weight entries.
- ``Model`` with ``b_patch_inference`` on small synthetic volumes, UNetSP
  (``unetsp_10k``) and UNetSPSmall (``unetspsmall_3k``), against the JAX
  ``Model`` on the same settings (which on the CPU serves ``model.apply``
  per patch): in f32 the masks are equal wherever the JAX model's
  blended classes differ by more than ``DECIDED``; in bf16 wherever they
  differ by more than ``DECIDED_BF16``. With ``use_int8`` the central
  calibration patch equals the one the JAX loop builds, element for
  element, and the int8 masks agree with the JAX ``Model``'s on at least
  ``INT8_AGREE`` of the decided voxels.
- ``FlapRecSP2O_512.ini`` as written (whole volume, bf16) and with
  ``b_patch_inference = True`` (its 128^3 patches at overlap 0.5) serves
  on the CPU and writes the JAX ``Model``'s masks on decided voxels.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu import trainer as jtrainer
from ctunet_tpu.ops import sliding_window as jsw
from ctunet_tpu_torch import Model
from ctunet_tpu_torch.checkpoint import UNETSP_10K, UNETSPSMALL_3K
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.ops import sliding_window as tsw
from test_torch_port_foreground import _masks, _params, _write_csv
from test_torch_port_int8_engine import ROOT

torch.set_num_threads(2)

DECIDED = 1e-3  # f32: |p1 - p0| of the JAX blend above which masks agree
DECIDED_BF16 = 2.0 ** -4  # bf16 engine vs bf16 model.apply: 16 ulps at 0.5
INT8_AGREE = 0.99
WEIGHTS = {"UNetSP": (UNETSP_10K, os.path.join(ROOT, ".ckpts",
                                                "unetsp_10k")),
           "UNetSPSmall": (UNETSPSMALL_3K, os.path.join(ROOT, ".ckpts",
                                                        "unetspsmall_3k"))}


@pytest.mark.parametrize("size,patch,step", [
    (100, 32, 16), (16, 32, 16), (32, 32, 16), (224, 128, 64),
    (512, 128, 64), (512, 128, 96), (33, 16, 8), (47, 16, 12)])
def test_patch_starts_match_jax(size, patch, step):
    got = tsw.patch_starts(size, patch, step)
    want = jsw.patch_starts(size, patch, step)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,patch,overlap", [
    ((224, 512, 512), (128, 128, 128), 0.5),
    ((224, 512, 512), (128, 128, 128), 0.25),
    ((64, 64, 64), (32, 32, 32), 0.5), ((40, 52, 36), (16, 24, 16), 0.3),
    ((16, 16, 16), (32, 32, 32), 0.5)])
def test_grid_and_window_match_jax(shape, patch, overlap):
    got = tsw.grid_starts(shape, patch, overlap)
    np.testing.assert_array_equal(got, jsw.grid_starts(shape, patch,
                                                       overlap))
    if shape == (224, 512, 512) and overlap == 0.5:
        assert len(got) == 3 * 7 * 7  # the INI's 147 patches
    w = tsw.gaussian_window(patch)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, jsw.gaussian_window(patch))


def _heads_np(x):
    """The per-patch forward both sides compute exactly: two 2-channel
    heads of single IEEE products of the (patch, atlas) channels (no
    product feeds a sum, which XLA may contract into a fused multiply-add
    depending on its fusion)."""
    a, b = x[..., 0:1], x[..., 1:2]
    return (a * 0.75, b * 0.5), (a * b, b * 0.25)


@pytest.mark.parametrize("patch,overlap,batch", [
    (16, 0.5, 1), (16, 0.5, 4), ((16, 24, 16), 0.3, 5), (16, 0.25, 3)])
def test_blend_matches_jax(patch, overlap, batch):
    """Same volume, atlas and per-patch outputs: the port's f32 blend
    equals the JAX scan's (whose grid pads to a multiple of K with
    zero-weight entries), and equals itself at K = 1."""
    rng = np.random.default_rng(11)
    vol = rng.random((2, 40, 52, 36)).astype(np.float32)
    atlas = rng.random((40, 52, 36)).astype(np.float32)

    def heads_cat(x):
        return tuple(jnp.concatenate(h, -1)
                     for h in _heads_np(x.astype(jnp.float32)))

    want = jsw.make_sliding_window_fn(
        None, patch_size=patch, overlap=overlap, atlas=atlas,
        compute_dtype=jnp.float32, patch_batch=batch,
        apply_fn=lambda v, x: heads_cat(x))(None, jnp.asarray(vol))
    calls = []

    def apply_fn(x):
        calls.append(x.shape[0])
        return tuple(torch.cat(h, -1) for h in _heads_np(x))

    got = tsw.make_sliding_window_fn(
        apply_fn, patch_size=patch, overlap=overlap, atlas=atlas,
        compute_dtype=torch.float32, patch_batch=batch)(
            torch.from_numpy(vol))
    n = len(tsw.grid_starts(vol.shape[1:], (patch,) * 3 if isinstance(
        patch, int) else patch, overlap))
    assert sum(calls) == 2 * n and max(calls) == batch
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if batch > 1:
        one = tsw.make_sliding_window_fn(
            apply_fn, patch_size=patch, overlap=overlap, atlas=atlas,
            compute_dtype=torch.float32)(torch.from_numpy(vol))
        for g, o in zip(got, one):
            assert torch.equal(g, o)


def test_volume_smaller_than_patch_raises():
    fn = tsw.make_sliding_window_fn(lambda x: x, patch_size=32)
    with pytest.raises(ValueError, match="smaller than the patch"):
        fn(torch.zeros(1, 16, 32, 32))


@pytest.fixture
def jax_blends(monkeypatch):
    """Spies on the JAX ``Model``'s forwards on the CPU (the sliding
    window over ``model.apply``, or ``model.apply`` on the whole volume):
    the list of each served volume's output maps, f32, padded."""
    from ctunet_tpu import steps as jsteps

    seen = []

    def spy(build):
        def built(*a, **k):
            fn = build(*a, **k)

            def predict(*args):
                out = fn(*args)
                seen.append([np.asarray(o[0], np.float32) for o in out])
                return out
            return predict
        return built

    monkeypatch.setattr(jsw, "make_sliding_window_fn",
                        spy(jsw.make_sliding_window_fn))
    monkeypatch.setattr(jsteps, "make_predict_fn",
                        spy(jsteps.make_predict_fn))
    return seen


def _serve_both(root, mc, vols, atlas, name, extra, blends):
    """The JAX ``Model`` then the port's on the same volumes and settings:
    ``(jax masks, port masks, port Model, reference maps)``, the last the
    JAX forward's outputs by mask key, cut to the volume."""
    csv, paths = _write_csv(str(root / name), vols, atlas)
    port_w, jax_w = WEIGHTS[mc]
    base = dict(model_class=mc, name=name, n_workers=1, **extra)
    jtrainer.Model(params=_params(root, csv, resume_model=jax_w, **base))
    want = _masks(paths, name)
    assert len(blends) == len(vols)
    ref = {}
    for p, v, maps in zip(paths, vols, blends):
        sl = tuple(slice(0, s) for s in v.shape)
        for sfx, o in zip(("sk", "fl"), maps):
            ref[(os.path.basename(p)[:-7], sfx)] = o[sl]
    m = Model(params=_params(root, csv, resume_model=port_w, **base))
    return want, _masks(paths, name), m, ref


@pytest.fixture(scope="module")
def skulls():
    """Two shells with caps removed on a (40, 60, 44) canvas (padded to
    the pool multiple), and a registered atlas."""
    shape = (40, 60, 44)
    vols = []
    for i, c in enumerate(((20, 30, 22), (22, 28, 20))):
        v = spherical_shell(shape, radius_frac=0.4, center=c, seed=i)
        v[:12, :24] = 0.0
        vols.append(v)
    atlas = spherical_shell(shape, radius_frac=0.4, center=(21, 29, 21))
    return vols, atlas.astype(np.float32)


def _decided_equal(want, got, ref, thr):
    """Masks equal on the voxels whose JAX maps decide by more than
    ``thr``."""
    for key, w in want.items():
        assert got[key].shape == w.shape
        dec = np.abs(ref[key][..., 1] - ref[key][..., 0]) > thr
        assert dec.mean() > 0.98, (key, dec.mean())
        np.testing.assert_array_equal(got[key][dec], w[dec],
                                      err_msg=str(key))


@pytest.mark.parametrize("mc,dtype", [
    ("UNetSP", "float32"), ("UNetSPSmall", "float32"),
    ("UNetSPSmall", "bfloat16")])
def test_model_patch_serving_matches_jax_model(tmp_path, skulls, jax_blends,
                                               mc, dtype):
    """32^3 patches at overlap 0.5, 3 a forward call: 12 patches a
    volume on UNetSP's 48x64x48 canvas, 27 on UNetSPSmall's 64^3."""
    vols, atlas = skulls
    extra = dict(patch_inference=True, patch_size=32, patch_overlap=0.5,
                 compute_dtype=dtype, patch_batch=3)
    want, got, m, ref = _serve_both(tmp_path, mc, vols, atlas, "pw", extra,
                                    jax_blends)
    assert m.n_served == 2 and m.pool_multiple == (
        32 if mc == "UNetSPSmall" else 16)
    _decided_equal(want, got, ref, DECIDED if dtype == "float32"
                   else DECIDED_BF16)
    assert any(w.any() for k, w in want.items() if k[1] == "sk")


def test_model_int8_patch_serving(tmp_path, monkeypatch, skulls, jax_blends):
    """``use_int8`` with AdaQuant (2 steps): the int8 engine calibrates on
    the first volume's central patch with the atlas at the same offsets,
    both rounded to ``compute_dtype``, equal to the patch the JAX loop
    hands its int8 build (its engine stubbed on the CPU); the masks
    agree with the JAX ``Model``'s on the same settings."""
    vols, atlas = skulls
    mc = "UNetSPSmall"
    extra = dict(patch_inference=True, patch_size=32, patch_overlap=0.5,
                 compute_dtype="bfloat16", use_int8=True, int8_adaquant=True,
                 int8_adaquant_steps=2)
    csv, paths = _write_csv(str(tmp_path / "q8"), vols, atlas)
    jtrainer.Model(params=_params(tmp_path, csv, resume_model=WEIGHTS[mc][1],
                                  model_class=mc, name="q8", n_workers=1,
                                  **extra))
    want = _masks(paths, "q8")
    ref = [b for b in jax_blends]
    seen = []

    def capture(model_class, variables, calib, **kw):
        seen.append((np.asarray(calib, np.float32), calib.dtype, kw))
        raise ValueError("captured")

    monkeypatch.setattr(jtrainer.Model, "_maybe_engine",
                        lambda self, v, dt: (lambda x: None))
    monkeypatch.setattr(jq, "build_predict_q_opt", capture)
    monkeypatch.setattr(jq, "build_predict_q", capture)
    monkeypatch.setattr(jsw, "make_sliding_window_fn",
                        lambda *a, **k: (lambda vs, x: (
                            jnp.zeros(x.shape + (2,)),) * 2))
    jtrainer.Model(params=_params(tmp_path, csv, resume_model=WEIGHTS[mc][1],
                                  model_class=mc, name="stub", n_workers=1,
                                  **extra))
    assert len(seen) == 2 and "adaquant_steps" in seen[0][2]
    jax_calib, jax_dtype, _ = seen[0]
    assert jax_dtype == jnp.bfloat16
    monkeypatch.undo()
    m = Model(params=_params(tmp_path, csv, resume_model=WEIGHTS[mc][0],
                             model_class=mc, name="q8", n_workers=1,
                             **extra))
    calib = m.int8_calib_patch
    assert calib.dtype == torch.bfloat16 and calib.shape == (32, 32, 32, 2)
    np.testing.assert_array_equal(calib.float().numpy(), jax_calib)
    ((shape, qfn),) = m.int8_engines.items()
    assert shape == (32, 32, 32, 2) and qfn.round_opt is not None
    assert m.int8_hint_shapes == {shape: None}  # searched on the patch
    got = _masks(paths, "q8")
    for i, (v, maps) in enumerate(zip(vols, ref)):
        sl = tuple(slice(0, s) for s in v.shape)
        for sfx, o in zip(("sk", "fl"), maps):
            key = (f"skull_{i:03d}", sfx)
            dec = np.abs(o[sl][..., 1] - o[sl][..., 0]) > DECIDED_BF16
            agree = (got[key][dec] == want[key][dec]).mean()
            assert agree >= INT8_AGREE, (key, agree)


@pytest.mark.parametrize("patch_inference", [False, True])
def test_512_ini_serves_on_the_cpu(tmp_path, jax_blends, patch_inference):
    """``examples/UNetSPDO/FlapRecSP2O_512.ini`` as written (UNetSPSmall,
    bf16, whole volume), given a test CSV and the CPU, and with
    ``b_patch_inference = True`` (128^3 patches at 0.5 overlap: a
    128x160x128 volume is 2 patches)."""
    from ctunet_tpu import default_params as jax_defaults
    from ctunet_tpu import load_params as jax_load
    from ctunet_tpu_torch import default_params, load_params

    ini = os.path.join(ROOT, "examples", "UNetSPDO", "FlapRecSP2O_512.ini")
    shape = (128, 160, 128) if patch_inference else (64, 96, 64)
    v = spherical_shell(shape, radius_frac=0.4, seed=4)
    v[: shape[0] // 3, : shape[1] // 2] = 0.0
    atlas = spherical_shell(shape, radius_frac=0.4).astype(np.float32)
    csv, paths = _write_csv(str(tmp_path / "data"), [v], atlas)
    over = dict(device="cpu", workspace_path=str(tmp_path / "ws"),
                test_files_csv=csv, n_workers=1,
                patch_inference=patch_inference)
    jp = jax_load(ini, jax_defaults())
    jp.update(over, resume_model=WEIGHTS["UNetSPSmall"][1])
    jtrainer.Model(params=jp)
    want = _masks(paths, "FlapRecSP2O_512")
    params = load_params(ini, default_params())
    assert params["model_class"] == "UNetSPSmall"
    assert params["patch_size"] == 128 and params["patch_overlap"] == 0.5
    params.update(over, resume_model=UNETSPSMALL_3K)
    m = Model(params=params)
    assert m.n_served == 1 and m.compute_dtype == torch.bfloat16
    got = _masks(paths, "FlapRecSP2O_512")
    (maps,) = jax_blends
    ref = {("skull_000", sfx): o for sfx, o in zip(("sk", "fl"), maps)}
    _decided_equal(want, got, ref, DECIDED_BF16)
    assert want[("skull_000", "sk")].any()
