"""Dropout in the pose head (``OutputSimple.linear``) of the PyTorch port
against the JAX package on the CPU, with the same weights through the
port's weight bridge (``load_jax_params``) and the same numpy inputs.

The two packages draw different random bits (a torch.Generator, a JAX key),
so the tests hold both to the rule, not to each other's masks: in training
mode every element of the ``linear`` output is 0 or exactly eval's value /
keep; keep = 1 drops nothing; eval mode never drops."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG  # noqa: E402
from deepclr_tpu_torch.engine import create_train_state, make_train_step  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn  # noqa: E402
from deepclr_tpu_torch.models import build_model, load_jax_params  # noqa: E402

B, N, P = 2, 512, 64


def _cfg(keep, linear=(256, 128, 64)):
    """The flagship architecture at reduced size, float32, with dropout."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["dropout"] = keep
    params["cloud_features"]["params"].update(npoint=[P], nsamples=[[32, 64]])
    params["merge"]["params"].update(k=8, mlp=[64, 64, 128])
    params["output"]["params"].update(mlp=[128, 128, 256], linear=list(linear))
    return cfg


def _pair(cfg):
    """(jax model, jax variables, port model) sharing one set of weights."""
    jmodel = jax_build_model(cfg)
    variables = jax.jit(lambda key: jax_init_params(jmodel, key, num_points=N, batch_size=B))(
        jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, model


def _merged(b=4, seed=0):
    """A motion embedding's output: (B, P, 3 + 128)."""
    return np.random.default_rng(seed).normal(size=(b, P, 3 + 128)).astype(np.float32)


def _jax_linear(jmodel, variables, x, train, seed=1):
    """The JAX ``OutputSimple``'s ``linear`` output, and its pose output."""
    y, state = jmodel.apply(variables, x, train, method=lambda m, x, train: m.output(x, train=train),
                            rngs={"dropout": jax.random.PRNGKey(seed)}, capture_intermediates=True)
    return np.asarray(state["intermediates"]["output"]["linear"]["__call__"][0]), np.asarray(y)


def _port_linear(model, x, train):
    model.train(train)
    try:
        with torch.no_grad():
            return model.output.features(torch.from_numpy(x)).numpy(), model.output(torch.from_numpy(x)).numpy()
    finally:
        model.eval()


def test_keep_one_trains_as_eval_in_both_packages():
    jmodel, variables, model = _pair(_cfg(1.0))
    x = _merged()
    j_eval, jy_eval = _jax_linear(jmodel, variables, x, False)
    j_train, jy_train = _jax_linear(jmodel, variables, x, True)
    t_eval, ty_eval = _port_linear(model, x, False)
    t_train, ty_train = _port_linear(model, x, True)
    assert np.array_equal(j_train, j_eval) and np.array_equal(jy_train, jy_eval)
    assert np.array_equal(t_train, t_eval) and np.array_equal(ty_train, ty_eval)
    # float32 matmuls summed in other orders
    np.testing.assert_allclose(t_eval, j_eval, rtol=1e-5, atol=1e-5)


def _assert_dropout_rule(train, ev, keep):
    """Every element 0 or exactly eval / keep; among eval's nonzero
    elements the dropped share within 5 sigma of 1 - keep."""
    assert np.all((train == 0) | (train == ev / keep))
    live = ev != 0
    n = int(live.sum())
    assert n > 500
    share = float((train[live] == 0).mean())
    sigma = np.sqrt(keep * (1 - keep) / n)
    assert abs(share - (1 - keep)) < 5 * sigma, (share, sigma)


def test_keep_half_keeps_or_doubles_each_element_in_both_packages():
    """One ``linear`` layer, so its output is one dropout's: the JAX MLP
    with ``dropout_last=True`` and the port's OutputSimple in training mode
    both zero an element or scale it by 1 / keep."""
    jmodel, variables, model = _pair(_cfg(0.5, linear=(256, 512)))
    x = _merged()
    j_eval, _ = _jax_linear(jmodel, variables, x, False)
    j_train, _ = _jax_linear(jmodel, variables, x, True)
    t_eval, _ = _port_linear(model, x, False)
    t_train, _ = _port_linear(model, x, True)
    np.testing.assert_allclose(t_eval, j_eval, rtol=1e-5, atol=1e-5)
    _assert_dropout_rule(j_train, j_eval, 0.5)
    _assert_dropout_rule(t_train, t_eval, 0.5)


def test_dropout_masks_come_from_the_models_own_generator():
    """Seeded from build_model's seed, reproducible, and the global torch
    generator untouched; successive training calls draw new masks."""
    x = _merged()
    draws = []
    for _ in range(2):
        model = build_model(_cfg(0.5), device="cpu", seed=3)
        state = torch.get_rng_state()
        first = _port_linear(model, x, True)[0]
        second = _port_linear(model, x, True)[0]
        assert torch.equal(torch.get_rng_state(), state)
        draws.append((first, second))
    assert np.array_equal(draws[0][0], draws[1][0]) and np.array_equal(draws[0][1], draws[1][1])
    assert not np.array_equal(draws[0][0], draws[0][1])


def test_micro_step_with_dropout_gives_finite_gradients():
    """make_train_step takes a dropout model; one accumulating micro-step
    leaves finite gradients on every parameter, non-zero on the head's."""
    model = build_model(_cfg(0.5), device="cpu", seed=4)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_train_step(model, opt, make_loss_fn(KITTI_TRAIN_CFG["metrics"]["loss"], "pose3d_dual_quat"), {},
                           accumulation_steps=2)
    rng = np.random.default_rng(5)
    t = np.concatenate([rng.normal(size=(B, N, 3)) * [3.0, 3.0, 0.5], rng.uniform(size=(B, N, 1))], -1)
    batch = {"template": t.astype(np.float32), "source": (t + rng.normal(size=t.shape) * 0.01).astype(np.float32),
             "y": np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32), (B, 1))}
    metrics = step(create_train_state(model), batch, 1e-3)
    assert np.isfinite(float(metrics["loss"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    assert all(grads[n].abs().max() > 0 for n in grads if n.startswith("_merge_layers.1.linear"))
