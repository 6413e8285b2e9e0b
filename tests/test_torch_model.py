"""The PyTorch port's modules, whole model and inference helper against the
JAX package on the CPU, with the same weights (through the port's weight
bridge) and the same numpy inputs.  The architecture is the flagship's at
reduced size: npoint 64, k=8 and narrower merge/head MLPs on 512-point
clouds."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu.models import ModelInferenceHelper as JaxHelper  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models.torch_convert import convert_torch_state_dict  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG  # noqa: E402
from deepclr_tpu_torch.models import ModelInferenceHelper, build_model, load_jax_params  # noqa: E402

B, N = 2, 512


def _tiny_cfg(compute_dtype):
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = compute_dtype
    params["cloud_features"]["params"].update(npoint=[64], nsamples=[[32, 64]])
    params["merge"]["params"].update(k=8, mlp=[64, 64, 128])
    params["output"]["params"].update(mlp=[128, 128, 256], linear=[256, 128, 64])
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax model, jax variables, port model) sharing one set of weights."""
    cfg = _tiny_cfg(request.param)
    jmodel = jax_build_model(cfg)
    variables = jax_init_params(jmodel, jax.random.PRNGKey(0), num_points=N, batch_size=B)
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(load_jax_params(_np_tree(variables)))
    return request.param, jmodel, variables, model


# float32: the JAX CPU path computes ball distances in the expanded form and
# sums matmuls in another order; 1e-4 covers that.  bfloat16: the JAX CPU
# set abstraction accumulates its bf16 tail in bf16 where the port (like the
# TPU kernel) accumulates in float32, and the bf16 rounding points of the
# merge and head MLPs then compound; 2e-2 bounds the pose outputs (|y| <~ 1).
_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _kitti_like(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)) * np.array([3.0, 3.0, 0.5])
    return np.concatenate([pts, rng.uniform(size=(b, n, 1))], -1).astype(np.float32)


def _mask():
    mask = np.ones((B, N), bool)
    mask[1, 400:] = False
    return mask


def _t(x):
    return torch.from_numpy(np.array(x))


def test_set_abstraction_matches_jax(pair):
    dtype, jmodel, variables, model = pair
    pts, mask = _kitti_like(B, N, 0), _mask()
    ref = np.asarray(jmodel.apply(variables, pts, mask, method="encode"))
    got = model.encode(_t(pts), _t(mask)).detach().numpy()
    assert got.shape == ref.shape == (B, 64, 67)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])  # FPS + gather are exact
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], atol=_TOL[dtype] * np.abs(ref).max(), rtol=0)


def test_motion_embedding_and_head_match_jax(pair):
    dtype, jmodel, variables, model = pair
    params = variables["params"]
    f0 = np.asarray(jmodel.apply(variables, _kitti_like(B, N, 1), method="encode"))
    f1 = np.asarray(jmodel.apply(variables, _kitti_like(B, N, 2), method="encode"))
    ref = np.asarray(jmodel.merge.bind({"params": params["merge"]})(f0, f1))
    got = model.merge(_t(f0), _t(f1)).detach().numpy()
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got, ref, atol=_TOL[dtype] * np.abs(ref).max(), rtol=0)
    y_ref = np.asarray(jmodel.output.bind({"params": params["output"]})(ref))
    y = model.output(_t(ref)).detach().numpy()
    np.testing.assert_allclose(y, y_ref, atol=_TOL[dtype], rtol=0)


def test_deepclr_forward_matches_jax(pair):
    dtype, jmodel, variables, model = pair
    t, s, mask = _kitti_like(B, N, 3), _kitti_like(B, N, 4), _mask()
    aug = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    aug[:, :3, 3] = [0.3, -0.2, 0.1]
    ref = np.asarray(jmodel.apply(variables, t, s, None, mask, aug, None)[0])
    with torch.inference_mode():
        got, loss = model(_t(t), _t(s), None, _t(mask), _t(aug), None)
    assert loss is None  # no loss module, no labels
    got = got.numpy()
    assert got.shape == ref.shape == (B, 8)
    np.testing.assert_allclose(got, ref, atol=_TOL[dtype], rtol=0)


def test_inference_helper_matches_jax(pair):
    """pairwise predict, predict_batch (with padding and subsampling) and a
    sequential run through encode_register."""
    dtype, jmodel, variables, model = pair
    rng = np.random.default_rng(5)
    clouds = [_kitti_like(1, n, 10 + i)[0] for i, n in enumerate((700, 512, 300, 600))]
    clouds = [np.concatenate([c, rng.normal(size=(len(c), 1)).astype(np.float32)], 1) for c in clouds]

    def both(make):
        return make(JaxHelper(jmodel, variables, num_points=N)), make(ModelInferenceHelper(model, num_points=N))

    ref, got = both(lambda h: h.predict(clouds[0], clouds[1]))
    np.testing.assert_allclose(got, ref, atol=_TOL[dtype], rtol=0)
    ref, got = both(lambda h: h.predict_batch(clouds[:2], clouds[2:]))
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, ref, atol=_TOL[dtype], rtol=0)

    jseq = JaxHelper(jmodel, variables, is_sequential=True, num_points=N)
    seq = ModelInferenceHelper(model, is_sequential=True, num_points=N)
    assert seq.predict(clouds[0]) is None and jseq.predict(clouds[0]) is None
    for c in clouds[1:3]:
        np.testing.assert_allclose(seq.predict(c), jseq.predict(c), atol=_TOL[dtype], rtol=0)


def test_weight_bridge_round_trips_through_reference_converter(pair):
    _, _, variables, model = pair
    params = _np_tree(variables["params"])
    back = convert_torch_state_dict(model.state_dict(), strict=True)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, value in flat_ref:
        np.testing.assert_array_equal(flat_back[path], value)


def test_weight_bridge_rejects_missing_and_extra_keys(pair):
    _, _, variables, _ = pair
    params = _np_tree(variables["params"])
    missing = copy.deepcopy(params)
    del missing["output"]["output"]["bias"]
    with pytest.raises(KeyError, match="output/output/bias"):
        load_jax_params(missing)
    gap = copy.deepcopy(params)
    del gap["merge"]["mlp"]["dense_1"]
    with pytest.raises(KeyError, match="merge/mlp"):
        load_jax_params(gap)
    extra = copy.deepcopy(params)
    extra["output"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="output/bogus/kernel"):
        load_jax_params(extra)
