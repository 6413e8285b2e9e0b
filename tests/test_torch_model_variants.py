"""The model variants the JAX package builds besides the flagship's fused
shape, against the JAX package on the CPU with the same weights and numpy
inputs: the exact set abstraction (ball query, nsample truncation),
MotionEmbedding with k=0, append_features=False, batch norm and the one-hot
gather, OutputSimple with batch norm, FeaturePropagation, DeepCLR on
differently padded clouds, and whole models through build_model, the
ModelNet40 recipe's among them.

Tolerances: float32 outputs within 1e-5 of max(1, max|JAX|) and gradients
within 1e-4 of each gradient's scale; bfloat16 within 2e-2 (XLA:CPU and
torch round bf16 products at other points, as in test_torch_model.py);
running statistics after one training forward within 1e-6 at float32."""
import copy
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu.losses import make_loss_fn as jax_make_loss_fn  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models.deepclr import MotionEmbedding as JaxME, OutputSimple as JaxOut  # noqa: E402
from deepclr_tpu.models.deepclr import SetAbstraction as JaxSA  # noqa: E402
from deepclr_tpu.models.feature_propagation import FeaturePropagation as JaxFP  # noqa: E402
from deepclr_tpu_torch.configs import (KITTI_MODEL_CFG, KITTI_TRAIN_CFG, MODELNET40_MODEL_CFG,  # noqa: E402
                                      MODELNET40_TRAIN_CFG)
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn  # noqa: E402
from deepclr_tpu_torch.models import (FeaturePropagation, ModelInferenceHelper, MotionEmbedding,  # noqa: E402
                                      OutputSimple, SetAbstraction, build_model, init_params,
                                      load_jax_feature_propagation_params, load_jax_params)
from deepclr_tpu_torch.models.pointnet2 import SORT_MIN_POINTS  # noqa: E402
from deepclr_tpu_torch.synthetic import cad_train_batch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
LOSSES = KITTI_TRAIN_CFG["metrics"]["loss"]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _jit_apply(module, **kwargs):
    """module.apply, jitted (eager Flax spends seconds dispatching op by op)."""
    return jax.jit(lambda variables, *args: module.apply(variables, *args, **kwargs))


def _random_biases(tree, seed):
    """Every bias non-zero: jnp.maximum(x, 0) has gradient 0.5 at 0, torch.relu 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias" or (name.startswith("scale") and "_b" in name):
            return (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return np.array(leaf, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _kitti_like(b, n, seed, dim=4):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3)) * np.array([3.0, 3.0, 0.5])
    return np.concatenate([pts, rng.uniform(size=(b, n, dim - 3))], -1).astype(np.float32)


# --- the exact set abstraction ---------------------------------------------

SA_ARGS = {
    "one_stage": dict(npoint=[48], radii=[[0.6, 1.2]], nsamples=[[8, 24]], mlps=[[[8, 8, 16], [8, 16]]]),
    "two_stages": dict(npoint=[64, 16], radii=[[0.6, 1.2], [1.5]], nsamples=[[8, 24], [12]],
                       mlps=[[[8, 8, 16], [8, 16]], [[16, 16]]]),
}


def _sa_state(params):
    """JAX SetAbstraction params -> the port SetAbstraction's state dict."""
    state = {}
    for stage, tree in params.items():
        for name, value in tree.items():
            scale, kind, layer = re.fullmatch(r"scale(\d+)_([wb])(\d+)", name).groups()
            key = f"_{stage}.mlps.{scale}.layer{layer}.conv." + ("weight" if kind == "w" else "bias")
            state[key] = torch.from_numpy(np.array(value.T if kind == "w" else value, np.float32))
    return state


def _sa_pair(kind, dtype, seed=0):
    jdt, tdt, _ = DTYPES[dtype]
    jsa = JaxSA(**SA_ARGS[kind], fused=False, compute_dtype=jdt)
    pts = _kitti_like(2, 400, seed)
    mask = np.ones((2, 400), bool)
    mask[1, 300:] = False
    params = _random_biases(jax.jit(jsa.init)(jax.random.PRNGKey(seed), pts, mask)["params"], seed)
    sa = SetAbstraction(4, **SA_ARGS[kind], fused=False, compute_dtype=tdt)
    sa.load_state_dict(_sa_state(params))
    return jsa, params, sa, pts, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["one_stage", "two_stages"])
def test_exact_set_abstraction_matches_jax(kind, dtype):
    jsa, params, sa, pts, mask = _sa_pair(kind, dtype)
    ref = np.asarray(_jit_apply(jsa)({"params": params}, pts, mask))
    got = sa(_t(pts), _t(mask)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])  # FPS and the gather are exact
    _close(got, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("kind", ["one_stage", "two_stages"])
def test_exact_set_abstraction_gradients_match_jax(kind):
    jsa, params, sa, pts, mask = _sa_pair(kind, "float32", seed=1)
    cot = np.random.default_rng(2).normal(size=(2, SA_ARGS[kind]["npoint"][-1], 3 + sum(
        m[-1] for m in SA_ARGS[kind]["mlps"][-1]))).astype(np.float32)
    ref = jax.jit(jax.grad(lambda p: jnp.sum(jsa.apply({"params": p}, pts, mask) * cot)))(params)
    (sa(_t(pts), _t(mask)) * _t(cot)).sum().backward()
    grads = {n: p.grad for n, p in sa.named_parameters()}
    for name, g in _sa_state(_np(ref)).items():
        assert grads[name].abs().sum() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * max(1e-6, g.abs().max().item()), err_msg=name)


def test_exact_equals_fused_when_nsample_covers_every_ball():
    """With nsample above every ball's count the truncation is a no-op, so
    the port's exact and fused paths agree (one state dict for both)."""
    args = dict(npoint=[48], radii=[[0.6, 1.2]], nsamples=[[400, 400]], mlps=[[[8, 8, 16], [8, 8, 16]]])
    exact = SetAbstraction(4, **args, fused=False)
    init_params(exact, 3)
    fused = SetAbstraction(4, **args, fused=True)
    fused.load_state_dict(exact.state_dict())
    pts, mask = _t(_kitti_like(2, 400, 4)), torch.ones(2, 400, dtype=torch.bool)
    mask[0, 350:] = False
    _close(fused(pts, mask).detach().numpy(), exact(pts, mask).detach().numpy(), 1e-5)


# --- MotionEmbedding, OutputSimple, FeaturePropagation ---------------------

def _mlp_state(variables, prefix):
    """A JAX module's ``mlp`` subtree (with its batch statistics) -> port names under ``prefix``."""
    return {prefix + k[len("mlp."):]: v for k, v in load_jax_feature_propagation_params(variables).items()}


ME_CASES = {
    "k0": dict(k=0, radius=1.5),
    "k0_no_radius": dict(k=0, radius=0.0),
    "append_features_false": dict(k=6, radius=1.5, append_features=False),
    "k0_append_features_false": dict(k=0, radius=1.5, append_features=False),
    "onehot": dict(k=6, radius=1.5, gather="onehot"),
    "batch_norm": dict(k=6, radius=1.5, batch_norm=True),
    "batch_norm_k0": dict(k=0, radius=1.5, batch_norm=True, append_features=False),
}


def _feats(b, p, c, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(b, p, 3)), rng.normal(size=(b, p, c))], -1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ME_CASES))
def test_motion_embedding_variant_matches_jax(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    f0, f1 = _feats(2, 32, 5, 1), _feats(2, 40, 5, 2)
    f1[:, :, :3] = f1[:, :, :3] * 0.8
    args = dict(ME_CASES[case], mlp=[16, 16, 32])
    jme = JaxME(**args, compute_dtype=jdt)
    variables = jax.jit(jme.init)(jax.random.PRNGKey(0), f0, f1)
    variables = {"params": _random_biases(variables["params"], 5),
                 **({"batch_stats": _np(variables["batch_stats"])} if "batch_stats" in variables else {})}
    me = MotionEmbedding(5, **args, compute_dtype=tdt)
    me.load_state_dict(_mlp_state(variables, "_embedding._conv."))
    me.eval()
    ref = np.asarray(_jit_apply(jme)(variables, f0, f1))
    with torch.no_grad():
        got = me(_t(f0), _t(f1)).numpy()
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    _close(got, ref, tol)
    if not ME_CASES[case].get("batch_norm"):
        return
    # training mode: batch statistics, and the running statistics updated as Flax updates them
    ref, updates = _jit_apply(jme, train=True, mutable=["batch_stats"])(variables, f0, f1)
    me.train()
    with torch.no_grad():
        got = me(_t(f0), _t(f1)).numpy()
    _close(got, np.asarray(ref), tol)
    stats = _mlp_state({"params": variables["params"], "batch_stats": _np(updates["batch_stats"])},
                       "_embedding._conv.")
    for name, value in stats.items():
        if "running" in name:
            # bf16: the statistics of bf16 activations, which jitted XLA may
            # keep in float32 between the Dense and the batch norm
            atol = 1e-6 if dtype == "float32" else tol * value.abs().max().item()
            np.testing.assert_allclose(me.state_dict()[name].numpy(), value.numpy(), rtol=0, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_output_simple_with_batch_norm_matches_jax(train):
    x = _feats(3, 20, 13, 3)
    jout = JaxOut(mlp=[16, 32], linear=[32, 24, 16], label_type=JaxLabelType.POSE3D_DUAL_QUAT, batch_norm=True)
    variables = jax.jit(jout.init)(jax.random.PRNGKey(1), x)
    params = _random_biases(variables["params"], 6)
    stats = _np(variables["batch_stats"])
    out = OutputSimple(16, mlp=[16, 32], linear=[32, 24, 16], label_type=LabelType.POSE3D_DUAL_QUAT,
                       batch_norm=True)
    state = {}
    for part in ("conv", "linear"):
        state.update(_mlp_state({"params": {"mlp": params[part]}, "batch_stats": {"mlp": stats[part]}},
                                f"{part}."))
    state["output.weight"] = _t(params["output"]["kernel"].T)
    state["output.bias"] = _t(params["output"]["bias"])
    out.load_state_dict(state)
    out.train(train)
    if train:
        ref, updates = _jit_apply(jout, train=True, mutable=["batch_stats"])({"params": params, "batch_stats": stats},
                                                                             x)
    else:
        ref = _jit_apply(jout)({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = out(_t(x)).numpy()
    _close(got, np.asarray(ref), 1e-5)
    if train:
        np.testing.assert_allclose(out.linear._sequential[1]._sequential[1].running_var.numpy(),
                                   np.asarray(updates["batch_stats"]["linear"]["bn_1"]["var"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_feature_propagation_matches_jax(batch_norm):
    rng = np.random.default_rng(8)
    unknown, known = rng.normal(size=(2, 100, 3)).astype(np.float32), rng.normal(size=(2, 24, 3)).astype(np.float32)
    skip, kfeat = rng.normal(size=(2, 100, 4)).astype(np.float32), rng.normal(size=(2, 24, 6)).astype(np.float32)
    kmask = np.ones((2, 24), bool)
    kmask[1, 20:] = False
    jfp = JaxFP(mlp=(16, 8), batch_norm=batch_norm)
    variables = jax.jit(jfp.init)(jax.random.PRNGKey(2), unknown, known, skip, kfeat, kmask)
    variables = {"params": _random_biases(variables["params"], 9),
                 **({"batch_stats": _np(variables["batch_stats"])} if batch_norm else {})}
    fp = FeaturePropagation(10, (16, 8), batch_norm=batch_norm).eval()
    fp.load_state_dict(load_jax_feature_propagation_params(variables))
    ref = np.asarray(_jit_apply(jfp)(variables, unknown, known, skip, kfeat, kmask))
    got = fp(*map(_t, (unknown, known, skip, kfeat, kmask)))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), ref, 1e-5)


# --- whole models through build_model ---------------------------------------

def _tiny_cfg(**changes):
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["cloud_features"]["params"].update(npoint=[48], nsamples=[[8, 24]])
    params["merge"]["params"].update(k=8, mlp=[32, 32, 64])
    params["output"]["params"].update(mlp=[64, 64, 128], linear=[128, 64, 32])
    for where, key, value in changes.get("set", ()):
        (params if where == "params" else params[where]["params"])[key] = value
    return cfg


def _models(cfg, n=384, seed=0):
    jmodel = jax_build_model(cfg)
    variables = jax.jit(lambda key: jax_init_params(jmodel, key, num_points=n, batch_size=1))(
        jax.random.PRNGKey(seed))
    variables = {"params": _random_biases(variables["params"], seed + 10),
                 **({"batch_stats": _np(variables["batch_stats"])} if "batch_stats" in variables else {})}
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(load_jax_params(variables))
    return jmodel, variables, model


def _pair(n_t, n_s, seed):
    t, s = _kitti_like(2, n_t, seed), _kitti_like(2, n_s, seed + 1)
    tm, sm = np.ones((2, n_t), bool), np.ones((2, n_s), bool)
    tm[1, n_t * 3 // 4:] = False
    sm[0, n_s // 2:] = False
    return t, s, tm, sm


def _flagship_exact_cfg():
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"].update(fused=False, compute_dtype="float32")
    return cfg


# (config, pairs, points): reduced widths, and the flagship's own (npoint
# 1024, nsamples 512 / 1024, published MLPs) on one pair of 1024 points
VARIANTS = {
    "exact": (lambda: _tiny_cfg(set=[("params", "fused", False)]), 2, 384),
    "k0_append_features_false": (
        lambda: _tiny_cfg(set=[("merge", "k", 0), ("merge", "append_features", False)]), 2, 384),
    "flagship_exact": (_flagship_exact_cfg, 1, 1024),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_variant_forward_and_gradients_match_jax(variant):
    """Forward and one train step's gradients of the whole model."""
    make_cfg, b, n = VARIANTS[variant]
    jmodel, variables, model = _models(make_cfg(), n=n)
    t, s, tm, sm = (x[:b] for x in _pair(n, n, 20))
    y = np.tile(np.array([[1.0, 0, 0, 0, 0, 0.1, 0, 0]], np.float32), (b, 1))
    jloss = jax_make_loss_fn(LOSSES, JaxLabelType.POSE3D_DUAL_QUAT)

    def f(p):
        y_pred, _ = jmodel.apply({**variables, "params": p}, t, s, tm, sm, None, None)
        return jloss(y_pred, y), y_pred

    (ref_loss, ref_y), ref = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    model.train()
    y_pred, _ = model(*map(_t, (t, s, tm, sm)))
    _close(y_pred.detach().numpy(), ref_y, 1e-5)
    loss = make_loss_fn(LOSSES, "pose3d_dual_quat")(y_pred, _t(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    want = load_jax_params(_np(ref))
    for name, p in model.named_parameters():
        g = want[name]
        assert p.grad is not None and (p.grad.abs().sum() > 0 or g.abs().sum() == 0), name
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0, atol=1e-4 * max(1e-6, g.abs().max().item()),
                                   err_msg=name)


# The ModelNet40 recipe's whole model (xyz only, so the stage has no input
# features; radii 0.1 / 0.2, k 30 and an embedding radius of 0.2 that cuts
# most pairs) on 2 CAD self-pairs of 512 points and 64 centres.  float32 as
# above.  bf16: the pose within the file's 2e-2 (seeds 0-9 read <= 7.4e-4)
# and the loss within 1% (<= 2.0e-3).  A bf16 gradient sends the max over a
# ball or the neighbours to another row wherever two round alike, which
# turns a leaf's gradient but hardly its norm: each norm within 15% of the
# larger of its JAX norm and the median leaf's (seeds 0-9: <= 4.9%).
MODELNET40_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
MODELNET40_GRAD_NORM_TOL = 0.15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modelnet40_model_forward_and_gradients_match_jax(dtype):
    cfg = copy.deepcopy(MODELNET40_MODEL_CFG)
    cfg["params"]["compute_dtype"] = dtype
    cfg["params"]["cloud_features"]["params"]["npoint"] = [64]
    jmodel, variables, model = _models(cfg, n=512, seed=2)
    b = cad_train_batch(2, 512, 2)
    t, s, tm, sm, y = (b[k] for k in ("template", "source", "template_mask", "source_mask", "y"))
    losses = MODELNET40_TRAIN_CFG["metrics"]["loss"]
    jloss = jax_make_loss_fn(losses, JaxLabelType.POSE3D_DUAL_QUAT)

    def f(p):
        y_pred, _ = jmodel.apply({**variables, "params": p}, t, s, tm, sm, None, None)
        return jloss(y_pred, y), y_pred

    (ref_loss, ref_y), ref = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    model.train()
    y_pred, _ = model(*map(_t, (t, s, tm, sm)))
    pose_tol, loss_tol = MODELNET40_TOL[dtype]
    _close(y_pred.detach().numpy(), ref_y, pose_tol)
    loss = make_loss_fn(losses, "pose3d_dual_quat")(y_pred, _t(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=loss_tol)
    want = load_jax_params(_np(ref))
    median = float(np.median([float(g.norm()) for g in want.values()]))
    for name, p in model.named_parameters():
        g = want[name]
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0 or g.abs().sum() == 0, name
        if dtype == "float32":
            np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                       atol=1e-4 * max(1e-6, g.abs().max().item()), err_msg=name)
        else:
            gap = abs(float(p.grad.norm()) - float(g.norm())) / max(float(g.norm()), median)
            assert gap <= MODELNET40_GRAD_NORM_TOL, (name, gap)


def test_deepclr_forward_with_differently_padded_clouds_matches_jax():
    """Templates and sources padded to other sizes are encoded separately."""
    jmodel, variables, model = _models(_tiny_cfg())
    t, s, tm, sm = _pair(384, 300, 30)
    ref = np.asarray(_jit_apply(jmodel)(variables, t, s, tm, sm)[0])
    with torch.no_grad():
        got, _ = model(*map(_t, (t, s, tm, sm)))
    _close(got.numpy(), ref, 1e-5)


def test_presorted_exact_equals_fused_at_4096_points():
    """From SORT_MIN_POINTS on, the fused path Morton-sorts the points on
    the device before FPS, so FPS starts at another point and picks other
    centres than the exact path, which never sorts.  Both models presorted,
    on the clouds their helpers sort on the host, see one order: with every
    ball within nsample the two paths agree at float32."""
    n, nsample = SORT_MIN_POINTS, 1024
    templates = [_kitti_like(1, n, 41)[0], _kitti_like(1, n - 300, 42)[0]]
    sources = [_kitti_like(1, n - 500, 43)[0], _kitti_like(1, n, 44)[0]]
    radius = max(KITTI_MODEL_CFG["params"]["cloud_features"]["params"]["radii"][0])
    for cloud in templates + sources:  # the fullest ball around any point, so around any centre
        xyz = torch.from_numpy(cloud[:, :3])
        assert (torch.cdist(xyz, xyz) < radius).sum(-1).max() < nsample
    preds = {}
    for presorted in (True, False):
        for fused in (True, False):
            cfg = _tiny_cfg(set=[("params", "fused", fused), ("params", "presorted", presorted),
                                 ("cloud_features", "nsamples", [[nsample, nsample]])])
            model = build_model(cfg, device="cpu", seed=5)
            preds[presorted, fused] = ModelInferenceHelper(model, num_points=n).predict_batch(sources, templates)
    _close(preds[True, True], preds[True, False], 1e-5)
    assert np.abs(preds[False, True] - preds[False, False]).max() > 1e-4  # as given, other centres


def test_batch_norm_config_raises_as_in_jax():
    """Batch norm in set abstraction raises in both packages (Flax at init)."""
    cfg = _tiny_cfg(set=[("params", "batch_norm", True)])
    with pytest.raises(NotImplementedError):
        jax_init_params(jax_build_model(cfg), jax.random.PRNGKey(0), num_points=64)
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")
