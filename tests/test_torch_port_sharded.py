"""Depth-sharded and data-parallel serving in ``ctunet_tpu_torch``.

- ``engine.build_sharded_predict``: one volume's depth over 2 gloo ranks
  on the CPU (the kernels' plain versions), the neighbours' edge planes
  joined on before every K1 and both K3 inputs, against the port's single
  engine within atol 1e-5, rtol 1e-5 (``tests/test_engine_sharded.py``'s
  tolerance, its UNetSP f32 at 32x16x32), and against the JAX package's
  ``build_sharded_predict`` on 2 of the 8 virtual CPU devices; the legacy
  family raises.
- ``engine.build_dp_predict``: 2 ranks x 1 volume in bf16, f32 and int8
  (zero-point mode, the same calibration volume on every rank), each equal
  to the single engine on its volume (int8 bit for bit); the legacy family
  serves in bf16 and refuses int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine as jax_engine
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.parallel import make_mesh as jax_make_mesh
from ctunet_tpu_torch import engine, engine_q, parallel
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax

SHARD_SHAPE = (32, 16, 32)  # D = 2 shards x 16, the pool multiple
DP_SHAPE = (16, 16, 32)


def _jax_variables():
    """JAX UNetSP f32 weights with perturbed statistics, as
    ``tests/test_engine_sharded.py`` makes them, and the port's copy."""
    m = jax_build_model("UNetSP", compute_dtype="float32",
                        use_checkpoint=False)
    x0 = jnp.zeros((1, *SHARD_SHAPE, 2), jnp.float32)
    vs = jax.jit(m.init, static_argnums=(2,))(jax.random.key(0), x0, False)
    vs = {"params": vs["params"],
          "batch_stats": jax.tree.map(lambda s: s * 1.05 + 0.01,
                                      vs["batch_stats"])}
    return vs, from_flax(vs["params"], vs["batch_stats"])


def _shard_input():
    return np.random.default_rng(0).random((1, *SHARD_SHAPE, 2)).astype(
        np.float32)


def _dp_volumes():
    """Two skull-and-atlas volumes and the calibration volume."""
    atlas = spherical_shell(DP_SHAPE, radius_frac=0.42).astype(np.float32)
    vols = []
    for seed in (3, 4, 5):
        skull = spherical_shell(DP_SHAPE, seed=seed).astype(np.float32)
        skull[: DP_SHAPE[0] // 3, : DP_SHAPE[1] // (seed - 1)] = 0.0
        vols.append(np.stack([skull, atlas], -1))
    return torch.from_numpy(np.stack(vols[:2])), torch.from_numpy(vols[2])


def _legacy_state_dict():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        return build_model("UNet4_2IC").state_dict()


def _rank(rank, sd_shard, threads):
    """Everything the tests read from one rank, in one process group, on as
    many threads as the test process (the CPU convs' f32 sums then run in
    the same order)."""
    torch.set_num_threads(threads)
    parallel.initialize_from_params(dict(distributed=True, device="cpu"))
    out = {}
    # depth-sharded, 1 x 2
    spatial = parallel.make_mesh(1, 2)
    fwd = engine.build_sharded_predict("UNetSP", sd_shard, spatial,
                                       torch.float32, "cpu")
    out["sharded"] = fwd(torch.from_numpy(_shard_input()))
    # data-parallel, 2 x 1
    mesh = parallel.make_mesh(2, 1)
    images, calib = _dp_volumes()
    sd = load_any(UNETSP_10K)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        out[name] = engine.build_dp_predict("UNetSP", sd, mesh, dtype,
                                            "cpu")(images)
    out["int8"] = engine.build_dp_predict("UNetSP", sd, mesh, device="cpu",
                                          int8_calib=calib)(images)
    legacy = _legacy_state_dict()
    out["legacy_bf16"] = engine.build_dp_predict(
        "UNet4_2IC", legacy, mesh, device="cpu")(images)
    try:
        engine.build_dp_predict("UNet4_2IC", legacy, mesh, device="cpu",
                                int8_calib=calib)
        out["legacy_int8"] = None
    except ValueError as e:
        out["legacy_int8"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    vs, sd = _jax_variables()
    return vs, sd, parallel.spawn(_rank, 2, (sd, torch.get_num_threads()))


def _slab(t, i, n=2):
    ds = t.shape[1] // n
    return t[:, i * ds:(i + 1) * ds]


def test_sharded_engine_matches_the_single_engine(ranks):
    _, sd, got = ranks
    want = engine.build_predict("UNetSP", sd, torch.float32, "cpu")(
        torch.from_numpy(_shard_input()))
    for r, res in enumerate(got):
        for g, w in zip(res["sharded"], want):
            assert g.shape == _slab(w, r).shape
            np.testing.assert_allclose(g.numpy(), _slab(w, r).numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.slow  # ~35 s: the JAX engine in interpret mode, as its file
def test_sharded_engine_matches_the_jax_sharded_engine(ranks):
    vs, _, got = ranks
    mesh = jax_make_mesh(1, 2, jax.devices()[:2])
    want = jax_engine.build_sharded_predict(
        "UNetSP", vs, mesh, compute_dtype=jnp.float32,
        interpret=True)(jnp.asarray(_shard_input()))
    for i, w in enumerate(jax.tree.leaves(want)):
        g = np.concatenate([res["sharded"][i].numpy() for res in got], 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)


def test_sharded_engine_refuses_the_legacy_family():
    mesh = parallel.Mesh(1, 2, 0)
    with pytest.raises(NotImplementedError, match="generic"):
        engine.build_sharded_predict("UNet4_2IC", _legacy_state_dict(),
                                     mesh, device="cpu")
    sd = build_model("UNetSP").state_dict()
    fwd = engine.build_sharded_predict("UNetSP", sd, mesh, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        fwd(torch.zeros((1, 48, 16, 16, 2)))  # 48 = 2 x 24, not 2 x 16k


@pytest.mark.parametrize("name", ["bf16", "f32"])
def test_dp_serving_equals_the_single_engine_per_volume(ranks, name):
    _, _, got = ranks
    images, _ = _dp_volumes()
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    single = engine.build_predict("UNetSP", load_any(UNETSP_10K), dtype,
                                  "cpu")
    for r, res in enumerate(got):
        want = single(images[r:r + 1])
        for g, w in zip(res[name], want):
            assert g.dtype == dtype and torch.equal(g, w), (name, r)


def test_dp_int8_serving_is_bit_equal_to_the_single_engine(ranks):
    _, _, got = ranks
    images, calib = _dp_volumes()
    single = engine_q.build_predict_q("UNetSP", load_any(UNETSP_10K), calib,
                                      device="cpu")
    for r, res in enumerate(got):
        for g, w in zip(res["int8"], single(images[r:r + 1])):
            assert torch.equal(g, w), r


def test_dp_legacy_serves_bf16_and_refuses_int8(ranks):
    _, _, got = ranks
    images, _ = _dp_volumes()
    single = engine.build_predict("UNet4_2IC", _legacy_state_dict(),
                                  device="cpu")
    for r, res in enumerate(got):
        assert torch.equal(res["legacy_bf16"], single(images[r:r + 1]))
        assert res["legacy_int8"] and "UNet4_2IC" in res["legacy_int8"]
    with pytest.raises(ValueError, match="divide"):
        engine.build_dp_predict("UNet4_2IC", _legacy_state_dict(),
                                parallel.Mesh(2, 1, 0), device="cpu")(
            images[:1])
