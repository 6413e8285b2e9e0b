"""The port's losses and metrics (deepclr_tpu_torch.losses) and its in-model
loss modules against the JAX package on the CPU, on the same random label
batches (float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu import losses as jax_losses  # noqa: E402
from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu.models import deepclr as jax_deepclr  # noqa: E402
from deepclr_tpu_torch import losses  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_TRAIN_CFG  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.models.deepclr import (  # noqa: E402
    AccumulatedLoss,
    TransformLoss,
    TransformUncertaintyLoss,
)

LABELS = ["pose3d_euler", "pose3d_quat", "pose3d_dual_quat"]
# which label types each metric accepts (the others raise in both packages)
SUPPORTED = {
    "mae": LABELS, "mse": LABELS, "trans": LABELS, "trans_3d": LABELS, "rot": LABELS,
    "dual": ["pose3d_quat", "pose3d_dual_quat"], "quat_norm": ["pose3d_quat", "pose3d_dual_quat"],
    "dual_constraint": ["pose3d_dual_quat"],
}
RTOL = 1e-6


def _labels(label, seed, b=6, exact_row=True):
    """(prediction, target) label batches; the prediction is the target plus
    noise, except in row 0 with ``exact_row``."""
    dim = LabelType.create(label).dim
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, dim)).astype(np.float32)
    if label != "pose3d_euler":  # a unit rotation part, as the labels have
        q = slice(3, 7) if label == "pose3d_quat" else slice(0, 4)
        y[:, q] /= np.linalg.norm(y[:, q], axis=1, keepdims=True)
    pred = (y + 0.1 * rng.normal(size=y.shape)).astype(np.float32)
    if exact_row:  # an exact match: the p=2 norm's gradient stays finite
        pred[0] = y[0]
    return pred, y


@pytest.mark.parametrize("reduction", ["none", "mean"])
@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("metric", list(SUPPORTED))
def test_metric_matches_jax(metric, label, reduction):
    pred, y = _labels(label, seed=len(metric) + len(label))
    mt, jmt = losses.MetricType.create(metric), jax_losses.MetricType.create(metric)
    assert mt.value == jmt.value
    if label not in SUPPORTED[metric]:
        with pytest.raises(RuntimeError):
            mt.fn(LabelType.create(label))(torch.from_numpy(pred), torch.from_numpy(y))
        return
    # per-sample values through the functions, batch means through MetricType.fn
    if reduction == "none" and metric not in ("mae", "mse"):
        fn = {"trans": "trans_loss", "trans_3d": "trans_3d_loss", "dual": "dual_loss", "rot": "rot_loss",
              "quat_norm": "quat_norm_loss", "dual_constraint": "dual_constraint_loss"}[metric]
        got = getattr(losses, fn)(torch.from_numpy(pred), torch.from_numpy(y), LabelType.create(label),
                                  reduction="none").numpy()
        ref = np.asarray(getattr(jax_losses, fn)(pred, y, JaxLabelType.create(label), reduction="none"))
    else:
        weights = None if reduction == "mean" else [0.5] * (1 if metric not in ("mae", "mse") else len(y[0]))
        got = mt.fn(LabelType.create(label), weights=weights)(torch.from_numpy(pred), torch.from_numpy(y)).numpy()
        ref = np.asarray(jmt.fn(JaxLabelType.create(label), weights=weights)(pred, y))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)


def test_p2_norm_gradient_is_finite_at_an_exact_match():
    y = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.1, 0.2, 0.3, 0.4]])
    pred = y.clone().requires_grad_()
    losses.trans_loss(pred, y, LabelType.POSE3D_DUAL_QUAT).backward()
    assert torch.isfinite(pred.grad).all()


def test_flagship_loss_fn_and_metric_fns_match_jax():
    cfg = KITTI_TRAIN_CFG["metrics"]
    pred, y = _labels("pose3d_dual_quat", seed=1)
    loss = losses.make_loss_fn(cfg["loss"], "pose3d_dual_quat")(torch.from_numpy(pred), torch.from_numpy(y))
    ref = jax_losses.make_loss_fn(cfg["loss"], JaxLabelType.POSE3D_DUAL_QUAT)(pred, y)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), rtol=RTOL)
    got = losses.make_metric_fns(cfg["loss"], cfg["other"], "pose3d_dual_quat")
    want = jax_losses.make_metric_fns(cfg["loss"], cfg["other"], JaxLabelType.POSE3D_DUAL_QUAT)
    assert sorted(got) == sorted(want) == ["dual_constraint", "quat_norm", "rot", "trans"]
    for name in got:
        np.testing.assert_allclose(got[name](torch.from_numpy(pred), torch.from_numpy(y)).numpy(),
                                   np.asarray(want[name](pred, y)), rtol=RTOL, err_msg=name)


def _jax_loss_value_and_grads(module, pred, y):
    variables = module.init(jax.random.PRNGKey(0), pred, y)

    def f(params, pred):
        return module.apply({"params": params} if params else {}, pred, y)

    value, (g_params, g_pred) = jax.value_and_grad(f, argnums=(0, 1))(variables.get("params", {}), pred)
    return value, g_params, g_pred


@pytest.mark.parametrize("kind", ["TransformLoss", "TransformUncertaintyLoss", "AccumulatedLoss"])
def test_loss_modules_match_jax(kind):
    # no exact match: jnp.abs has gradient 1 at 0 where torch.abs has 0, and
    # AccumulatedLoss holds a p=1 loss
    pred, y = _labels("pose3d_dual_quat", seed=2, exact_row=False)
    lt, jlt = LabelType.POSE3D_DUAL_QUAT, JaxLabelType.POSE3D_DUAL_QUAT
    if kind == "TransformLoss":
        module = TransformLoss(lt, sx=1.0, sq=200.0)
        jmodule = jax_deepclr.TransformLoss(jlt, sx=1.0, sq=200.0)
    elif kind == "TransformUncertaintyLoss":
        module = TransformUncertaintyLoss(lt, sx=0.3, sq=-2.5)
        jmodule = jax_deepclr.TransformUncertaintyLoss(jlt, sx=0.3, sq=-2.5)
    else:
        module = AccumulatedLoss([TransformLoss(lt, p=1), TransformUncertaintyLoss(lt, sx=-1.0, sq=0.5)])
        jmodule = jax_deepclr.AccumulatedLoss((jax_deepclr.TransformLoss(jlt, p=1),
                                               jax_deepclr.TransformUncertaintyLoss(jlt, sx=-1.0, sq=0.5)))
    value, g_params, g_pred = _jax_loss_value_and_grads(jmodule, pred, y)
    p = torch.from_numpy(pred).requires_grad_()
    loss = module(p, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(value), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_pred), rtol=1e-5, atol=1e-7)
    # the learned log-variances get the JAX gradients, under their JAX names
    named = dict(module.named_parameters())
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(g_params)[0]}
    expect = {"TransformLoss": set(), "TransformUncertaintyLoss": {"sx", "sq"},
              "AccumulatedLoss": {"losses_1/sx", "losses_1/sq"}}[kind]
    assert set(flat) == expect
    for jname, g in flat.items():
        tname = jname.replace("losses_", "losses.").replace("/", "._")
        tname = tname if "." in tname else f"_{tname}"
        assert named[tname].shape == (1,)
        np.testing.assert_allclose(named[tname].grad.numpy(), np.asarray(g), rtol=1e-5)
