"""The port's train step (deepclr_tpu_torch solver and engine) against the
JAX package on the CPU: whole-model gradients against ``jax.grad``, Ranger
and Adam against the optax chains, the schedules, micro-steps with gradient
accumulation against ``make_train_step``, kill and resume, and the weight
bridge with a learned loss.  The same numpy inputs go through both."""
import copy
import re
import signal
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepclr_tpu.engine.trainer import create_train_state as jax_create_train_state  # noqa: E402
from deepclr_tpu.engine.trainer import make_train_step as jax_make_train_step  # noqa: E402
from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu.losses import make_loss_fn as jax_make_loss_fn  # noqa: E402
from deepclr_tpu.losses import make_metric_fns as jax_make_metric_fns  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models.torch_convert import convert_torch_state_dict  # noqa: E402
from deepclr_tpu.solver import optimizers as jax_optimizers  # noqa: E402
from deepclr_tpu.solver import schedulers as jax_schedulers  # noqa: E402
from deepclr_tpu.solver.build import make_optimizer as jax_make_optimizer  # noqa: E402
from deepclr_tpu_torch import solver  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG  # noqa: E402
from deepclr_tpu_torch.engine import make_train_step, run_trainer  # noqa: E402
from deepclr_tpu_torch.geometry import se3  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns  # noqa: E402
from deepclr_tpu_torch.models import build_model, load_jax_params  # noqa: E402

B, N = 2, 512
LOSSES = KITTI_TRAIN_CFG["metrics"]["loss"]
OTHER = KITTI_TRAIN_CFG["metrics"]["other"]


def _tiny_cfg(loss=None):
    """The flagship architecture at reduced size, float32."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["cloud_features"]["params"].update(npoint=[64], nsamples=[[32, 64]])
    params["merge"]["params"].update(k=8, mlp=[64, 64, 128])
    params["output"]["params"].update(mlp=[128, 128, 256], linear=[256, 128, 64])
    if loss is not None:
        params["loss"] = loss
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(cfg, seed=0):
    """JAX model and params with every bias drawn at random (non-zero): a
    zero bias gives exactly-zero pre-activations on all-zero rows, where the
    ReLU subgradients of the two frameworks differ."""
    jmodel = jax_build_model(cfg)
    variables = jax.jit(lambda key: jax_init_params(jmodel, key, num_points=N, batch_size=B))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def randomize(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias" or re.fullmatch(r"scale\d+_b\d+", name):
            return (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return np.asarray(leaf)

    return jmodel, jax.tree_util.tree_map_with_path(randomize, variables["params"])


def _batch(seed, b=B, n=N):
    """KITTI-like clouds (xyz + intensity), the source a small rigid motion
    of the template, dual-quaternion labels; the second template has a
    masked tail."""
    rng = np.random.default_rng(seed)
    t = np.concatenate([rng.normal(size=(b, n, 3)) * [3.0, 3.0, 0.5], rng.uniform(size=(b, n, 1))], -1)
    angles = torch.from_numpy((rng.normal(size=(3, b)) * 0.03).astype(np.float32))
    shift = torch.from_numpy((rng.normal(size=(b, 3)) * 0.3).astype(np.float32))
    m = se3.make_transform(se3.euler_to_matrix(*angles), shift).numpy()
    src = np.concatenate([t[..., :3] @ m[:, :3, :3].transpose(0, 2, 1) + m[:, None, :3, 3], t[..., 3:]], -1)
    mask = np.ones((b, n), bool)
    mask[-1, n * 3 // 4:] = False
    y = se3.dualquat_from_matrix(torch.from_numpy(m)).numpy()
    return {"template": t.astype(np.float32), "source": src.astype(np.float32), "template_mask": mask,
            "source_mask": mask.copy(), "y": y.astype(np.float32)}


def _port_model(cfg, params):
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(load_jax_params(params))
    return model


def _grads_as_jax_tree(model):
    """The port's gradients in the JAX parameter layout."""
    return convert_torch_state_dict({n: p.grad for n, p in model.named_parameters()}, strict=True)


def _assert_trees_close(got, want, rtol, atol_rel):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(flat_got[path]), w, rtol=rtol,
                                   atol=atol_rel * max(1e-6, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_every_parameter_gradient_matches_jax_grad():
    """Forward + trans/rot loss + backward of the reduced flagship in float32:
    every gradient equals jax.grad of the JAX model (set abstraction through
    the port's kernel backward, the JAX one through its scan)."""
    cfg = _tiny_cfg()
    jmodel, params = _jax_model(cfg)
    batch = _batch(0)
    jloss = jax_make_loss_fn(LOSSES, JaxLabelType.POSE3D_DUAL_QUAT)

    def f(p):
        y_pred, _ = jmodel.apply({"params": p}, batch["template"], batch["source"],
                                 batch["template_mask"], batch["source_mask"], None, None)
        return jloss(y_pred, batch["y"])

    ref_loss, ref = jax.jit(jax.value_and_grad(f))(params)
    model = _port_model(cfg, params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    y_pred, _ = model(t["template"], t["source"], t["template_mask"], t["source_mask"])
    loss = make_loss_fn(LOSSES, "pose3d_dual_quat")(y_pred, t["y"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    sa = [p.grad for n, p in model.named_parameters() if n.startswith("_cloud_layers")]
    assert all(g is not None and g.abs().sum() > 0 for g in sa)
    # float32 throughout; the two sum matmuls and distances in other orders
    # (as the forward parity tests), which the backward carries through
    _assert_trees_close(_grads_as_jax_tree(model), ref, rtol=2e-3, atol_rel=2e-4)


def test_relu_subgradient_at_zero_differs_from_jax():
    """jnp.maximum(x, 0) has gradient 0.5 at x = 0, torch.relu (like the TPU
    backward kernel's h > 0) has 0: whole-model parity needs non-zero biases."""
    assert float(jax.grad(lambda x: jnp.maximum(x, 0.0))(0.0)) == 0.5
    x = torch.zeros((), requires_grad=True)
    torch.relu(x).backward()
    assert x.grad.item() == 0.0


def _opt_problem(seed, steps):
    """Parameters in the JAX layout ((in, out) kernels, biases, a learned
    (1,) loss weight) and one gradient per step."""
    rng = np.random.default_rng(seed)
    params = {"dense": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                        "bias": rng.normal(size=(5,)).astype(np.float32)},
              "conv": {"kernel": rng.normal(size=(4, 7)).astype(np.float32)},
              "loss_module": {"sx": np.array([0.3], np.float32)}}
    grads = [jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32), params)
             for _ in range(steps)]
    lrs = [1e-2 * (1.0 + 0.1 * i) for i in range(steps)]
    return params, grads, lrs


def _to_port(tree):
    """(in, out) kernels -> (out, in) torch parameters, in a fixed order."""
    return [torch.nn.Parameter(torch.tensor(v.T if v.ndim == 2 else v)) for v in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", ["Ranger", "Adam"])
def test_optimizer_matches_optax_chain(name):
    """14 updates: past RAdam's rectification threshold (step 6) and two
    Lookahead syncs (steps 6 and 12), with gradient centralization and the
    rank >= 2 weight-decay mask in play."""
    steps = 14
    params, grads, lrs = _opt_problem(7, steps)
    factory = jax_optimizers.ranger if name == "Ranger" else jax_optimizers.adam
    tx = optax.inject_hyperparams(lambda learning_rate: factory(learning_rate, weight_decay=1e-2))(
        learning_rate=lrs[0])

    @jax.jit
    def update(p, state, g, lr):
        state.hyperparams["learning_rate"] = lr
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    jp, state = params, tx.init(params)
    port = _to_port(params)
    opt = solver.make_optimizer({"optimizer": {"name": name, "base_lr": lrs[0], "weight_decay": 1e-2}}, port)
    for g, lr in zip(grads, lrs):
        jp, state = update(jp, state, g, jnp.float32(lr))
        for p, gl in zip(port, _to_port(g)):
            p.grad = gl.data
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for p, ref, init in zip(port, jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(params)):
        ref = np.asarray(ref)
        got = p.detach().numpy()
        got = got.T if got.ndim == 2 else got
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        assert np.abs(ref - init).max() > 1e-3  # the parameters moved


def test_schedules_match_jax_value_for_value():
    params = dict(KITTI_TRAIN_CFG["scheduler"]["params"])
    params.update(cyclic_iterations=30, flat_iterations=10, annealing_iterations=20, step_size_up=4)
    steps = range(0, 70)
    for mode in ("triangular", "triangular2", "exp_range"):
        kw = dict(params, mode=mode, gamma=0.99)
        got = [solver.cyclic_flat_cosine(**kw)(s) for s in steps]
        assert got == [jax_schedulers.cyclic_flat_cosine(**kw)(s) for s in steps]
        cyc = dict(base_lr=1e-4, max_lr=1e-3, step_size_up=3, step_size_down=5, mode=mode, gamma=0.9)
        assert [solver.cyclic_lr(**cyc)(s) for s in steps] == [jax_schedulers.cyclic_lr(**cyc)(s) for s in steps]
    flagship = solver.make_schedule(KITTI_TRAIN_CFG)
    ref = jax_schedulers.make_schedule_fn(KITTI_TRAIN_CFG["scheduler"]["name"],
                                          KITTI_TRAIN_CFG["scheduler"]["params"], 5e-4)
    for s in (0, 1, 2000, 4000, 7999, 600000, 650000, 700000, 750000, 800000):
        assert flagship(s) == ref(s)
    assert solver.make_schedule({"optimizer": {"base_lr": 3e-4}})(123) == 3e-4


@pytest.mark.parametrize("variant", ["loss_fn", "model_loss_and_weight_ema"])
def test_micro_steps_with_accumulation_match_jax_train_step(variant):
    """4 micro-steps at accumulation 2 (2 Ranger updates): parameters, metric
    EMAs and, in the second variant, the learned loss weights of the
    in-model TransformUncertaintyLoss and the Polyak weight average, against
    the JAX train step on the same batches and lrs."""
    from deepclr_tpu_torch.engine import create_train_state

    in_model = variant == "model_loss_and_weight_ema"
    cfg = _tiny_cfg(loss={"name": "TransformUncertaintyLoss", "params": {"sx": 0.0, "sq": -2.5}}
                    if in_model else None)
    jmodel, params = _jax_model(cfg, seed=3)
    decay = 0.5 if in_model else 0.0
    opt_cfg = SimpleNamespace(optimizer=SimpleNamespace(name="Ranger", params=None, weight_decay=1e-3,
                                                        base_lr=1e-2))
    jopt = jax_make_optimizer(opt_cfg)
    jloss = jax_make_loss_fn(LOSSES, JaxLabelType.POSE3D_DUAL_QUAT)
    jmetrics = jax_make_metric_fns(LOSSES, OTHER, JaxLabelType.POSE3D_DUAL_QUAT)
    jstep = jax_make_train_step(jmodel, jopt, jloss, jmetrics, accumulation_steps=2, ema_alpha=0.5,
                                use_model_loss=in_model, weight_ema_decay=decay)
    jstate = jax_create_train_state(jmodel, {"params": params}, jopt, ["loss", "loss_fn", *jmetrics],
                                    weight_ema=in_model)

    model = _port_model(cfg, params)
    opt = solver.make_optimizer({"optimizer": {"name": "Ranger", "base_lr": 1e-2, "weight_decay": 1e-3}},
                                model.parameters())
    step = make_train_step(model, opt, make_loss_fn(LOSSES, "pose3d_dual_quat"),
                           make_metric_fns(LOSSES, OTHER, "pose3d_dual_quat"), accumulation_steps=2,
                           ema_alpha=0.5, use_model_loss=in_model, weight_ema_decay=decay)
    state = create_train_state(model, weight_ema=in_model)
    for i in range(4):
        batch, lr = _batch(10 + i), 1e-2 * (1 - 0.1 * i)
        jstate, jema = jstep(jstate, batch, np.float32(lr))
        ema = step(state, batch, lr)
    assert state.step == 4 and opt.state[next(model.parameters())]["count"] == 2
    assert sorted(ema) == sorted(jema)
    # float32 forwards that sum in other orders (the forward parity tests' 1e-4)
    for name in ema:
        np.testing.assert_allclose(ema[name].item(), float(jema[name]), rtol=1e-4, err_msg=name)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jstate.params), jax.tree_util.tree_leaves(params)))
    assert moved > 1e-3
    _assert_trees_close(convert_torch_state_dict(model.state_dict(), strict=True), _np_tree(jstate.params),
                        rtol=1e-4, atol_rel=1e-5)
    if in_model:
        assert model.loss_module._sq.item() != -2.5  # the learned weight trained
        _assert_trees_close(convert_torch_state_dict(state.param_ema, strict=True), _np_tree(jstate.param_ema),
                            rtol=1e-4, atol_rel=1e-5)


class _Loader(list):
    """A sized list of batches; with ``interrupt_at`` the iteration raises
    KeyboardInterrupt at that batch, as a SIGINT there would."""

    def __init__(self, batches, interrupt_at=None):
        super().__init__(batches)
        self.interrupt_at = interrupt_at

    def __iter__(self):
        for i, b in enumerate(list.__iter__(self)):
            if i == self.interrupt_at:
                self.interrupt_at = None
                raise KeyboardInterrupt
            yield b


def _trainer_run(tmp_path, max_iterations, loader, checkpoint=None, dropout=1.0):
    cfg = copy.deepcopy(KITTI_TRAIN_CFG)
    cfg["optimizer"].update(max_iterations=max_iterations, base_lr=1e-2)
    cfg["logging"].update(log_period=1, checkpoint_period=2, checkpoint_n_saved=2)
    cfg["scheduler"]["params"].update(base_lr=1e-3, max_lr=1e-2, step_size_up=2)
    mcfg = _tiny_cfg()
    mcfg["params"]["cloud_features"]["params"]["npoint"] = [16]
    mcfg["params"]["dropout"] = dropout
    model = build_model(mcfg, device="cpu", seed=5)
    opt = solver.make_optimizer(cfg, model.parameters())
    state = run_trainer(cfg, model, loader, None, opt, solver.make_schedule(cfg),
                        make_loss_fn(LOSSES, "pose3d_dual_quat"), make_metric_fns(LOSSES, OTHER, "pose3d_dual_quat"),
                        output_dir=str(tmp_path), checkpoint=checkpoint)
    return model, state


def test_kill_and_resume_gives_the_uninterrupted_params(tmp_path):
    # one batch throughout: a resumed run restarts its epoch, so with distinct
    # batches it would see them in another order than the uninterrupted run
    batches = [_batch(20, n=256)] * 2
    full, full_state = _trainer_run(tmp_path / "full", 6, _Loader(batches))
    assert (tmp_path / "full" / "ckpt_final_6.pt").exists()
    # interrupted after micro-step 3 (mid-accumulation): the interrupt
    # checkpoint is resumed
    _trainer_run(tmp_path / "cut", 6, _Loader(batches * 2, interrupt_at=3))
    assert (tmp_path / "cut" / "ckpt_interrupt_3.pt").exists()
    assert sorted(p.name for p in (tmp_path / "cut").glob("ckpt_[0-9]*.pt")) == ["ckpt_2.pt"]
    resumed, state = _trainer_run(tmp_path / "cut", 6, _Loader(batches * 2),
                                  checkpoint=str(tmp_path / "cut" / "ckpt_interrupt_3.pt"))
    assert state.step == full_state.step == 6
    ref = full.state_dict()
    for name, value in resumed.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(), err_msg=name)
    for name in full_state.metrics_ema:
        assert state.metrics_ema[name].item() == full_state.metrics_ema[name].item()
    # the ring keeps the last n_saved = 2 regular checkpoints, the latest linked
    assert sorted(p.name for p in (tmp_path / "full").glob("ckpt_[0-9]*.pt")) == ["ckpt_4.pt", "ckpt_6.pt"]
    assert (tmp_path / "full" / "weights.pt").resolve().name == "weights_final_6.pt"


def test_kill_and_resume_with_dropout_gives_the_uninterrupted_params(tmp_path):
    """With dropout 0.5 every micro-step's masks come from (seed, step), so
    the run resumed after micro-step 3 draws the masks the uninterrupted run
    drew from micro-step 4 on, and ends with its parameters bit for bit."""
    batches = [_batch(21, n=256)] * 2
    full, full_state = _trainer_run(tmp_path / "full", 6, _Loader(batches), dropout=0.5)
    _trainer_run(tmp_path / "cut", 6, _Loader(batches * 2, interrupt_at=3), dropout=0.5)
    resumed, state = _trainer_run(tmp_path / "cut", 6, _Loader(batches * 2), dropout=0.5,
                                  checkpoint=str(tmp_path / "cut" / "ckpt_interrupt_3.pt"))
    assert state.step == full_state.step == 6
    ref = full.state_dict()
    for name, value in resumed.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(), err_msg=name)
    for name in full_state.metrics_ema:
        assert state.metrics_ema[name].item() == full_state.metrics_ema[name].item()
    # the masks mattered: without dropout the same run ends elsewhere
    plain, _ = _trainer_run(tmp_path / "plain", 6, _Loader(batches))
    assert not torch.equal(plain.state_dict()["_merge_layers.1.linear._sequential.0._sequential.0.weight"],
                           ref["_merge_layers.1.linear._sequential.0._sequential.0.weight"])


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    batches = [_batch(22, n=256)] * 2
    full, _ = _trainer_run(tmp_path_factory.mktemp("full"), 6, _Loader(batches))
    return batches, {k: v.clone() for k, v in full.state_dict().items()}


class _SignalLoader(list):
    """A sized list of batches whose iteration delivers SIGINT (through the
    trainer's handler, in process) while it fetches batch ``at``."""

    def __init__(self, batches, at):
        super().__init__(batches)
        self.at = at

    def __iter__(self):
        from deepclr_tpu_torch.engine import trainer

        for i, b in enumerate(list.__iter__(self)):
            if i == self.at:
                trainer._sigint_handler(signal.SIGINT, None)
            yield b


@pytest.mark.parametrize("where,stopped_at", [("loader", 3), ("schedule", 3), ("train_step", 3), ("checkpoint", 2)])
def test_sigint_anywhere_in_the_loop_leaves_a_checkpoint_of_whole_iterations(tmp_path, monkeypatch, uninterrupted,
                                                                             where, stopped_at):
    """SIGINT delivered in process, deterministically, at one point of the
    loop: while the loader fetches the 4th batch, in the 3rd schedule call,
    just after the 3rd train step updated the state in place, or in the
    first periodic checkpoint (iteration 2).  The interrupt checkpoint's
    iteration equals the micro-steps its state holds, the optimizer's update
    count is that over the accumulation (2), and resuming from it gives the
    uninterrupted run's weights bit for bit."""
    from deepclr_tpu_torch.engine import trainer
    from deepclr_tpu_torch.engine.checkpoint import Checkpointer, load_checkpoint

    batches, ref = uninterrupted
    deliver = trainer._sigint_handler
    calls = []

    def on_call(fn, n):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append(1)
            if len(calls) == n:
                deliver(signal.SIGINT, None)
            return out
        return wrapped

    loader = _Loader(batches * 2)
    if where == "loader":
        loader = _SignalLoader(batches * 2, at=3)
    elif where == "schedule":
        monkeypatch.setattr(solver, "make_schedule", lambda cfg, f=solver.make_schedule: on_call(f(cfg), 3))
    elif where == "train_step":
        monkeypatch.setattr(trainer, "make_train_step", lambda *a, f=trainer.make_train_step, **k: on_call(
            f(*a, **k), 3))
    else:
        monkeypatch.setattr(Checkpointer, "save_checkpoint", on_call(Checkpointer.save_checkpoint, 1))
    _trainer_run(tmp_path / "cut", 6, loader)
    monkeypatch.undo()

    path = tmp_path / "cut" / f"ckpt_interrupt_{stopped_at}.pt"
    assert [p.name for p in (tmp_path / "cut").glob("ckpt_interrupt_*.pt")] == [path.name]
    ckpt = load_checkpoint(str(path))
    assert ckpt["iteration"] == ckpt["state"]["step"] == stopped_at
    assert {s["count"] for s in ckpt["state"]["optimizer"]["state"].values()} == {stopped_at // 2}
    resumed, state = _trainer_run(tmp_path / "cut", 6, _Loader(batches * 2), checkpoint=str(path))
    assert state.step == 6
    for name, value in resumed.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ref[name].numpy(), err_msg=name)


def test_non_finite_loss_raises_and_writes_an_exception_checkpoint(tmp_path):
    bad = _batch(30, n=256)
    bad["template"][0, 0, 0] = np.nan
    with pytest.raises(ValueError, match="Invalid loss"):
        _trainer_run(tmp_path, 2, _Loader([bad]))
    assert (tmp_path / "ckpt_exception_1.pt").exists()


def test_weight_bridge_with_a_learned_loss():
    """TransformUncertaintyLoss: sx / sq cross the bridge, the in-model loss
    equals JAX's, and the reverse converter returns the same tree."""
    loss_cfg = {"name": "TransformUncertaintyLoss", "params": {"sx": 0.0, "sq": -2.5}}
    cfg = _tiny_cfg(loss=loss_cfg)
    jmodel, params = _jax_model(cfg, seed=4)
    params["loss_module"] = {"sx": np.array([0.25], np.float32), "sq": np.array([-2.0], np.float32)}
    model = _port_model(cfg, params)
    assert model.loss_module._sq.item() == -2.0
    batch = _batch(5)
    y_ref, loss_ref = jax.jit(lambda p: jmodel.apply(
        {"params": p}, batch["template"], batch["source"], batch["template_mask"], batch["source_mask"],
        None, None, batch["y"]))(params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    y_pred, loss = model(t["template"], t["source"], t["template_mask"], t["source_mask"], y=t["y"])
    np.testing.assert_allclose(y_pred.detach().numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-4)
    _assert_trees_close(convert_torch_state_dict(model.state_dict(), strict=True), params, rtol=0, atol_rel=0)
    # an AccumulatedLoss's indexed weights load, but the reference converter
    # does not map them back (ROADMAP Queue C)
    acc = _tiny_cfg(loss=[{"name": "TransformLoss"}, loss_cfg])
    acc_params = dict(params, loss_module={"losses_1": params["loss_module"]})
    acc_model = _port_model(acc, acc_params)
    assert acc_model.loss_module.losses[1]._sx.item() == 0.25
    with pytest.raises(ValueError, match="_loss_layer.losses.1"):
        convert_torch_state_dict(acc_model.state_dict(), strict=True)
