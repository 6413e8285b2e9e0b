"""The train step's upload (``engine.trainer._Upload``) and the loss
weights kept on the device (``losses.MetricType.fn``).

On the CPU: a weighted metric copies its weights once a device and weighs
the unweighted terms as by hand; the train step converts the batch as it
is (every micro-step ``resident``) and equals a plain micro-step loop bit
for bit.

On the card (``-m cuda``; each case skips without one), for the flagship
and the ModelNet40 model at small batches: micro-steps raise nothing under
``torch.cuda.set_sync_debug_mode("error")``; a profiled pair of
micro-steps holds no pageable copy and no stream synchronise; numpy
batches through the pinned ring, pinned tensors and tensors on the device
give the same bits (parameters, Ranger's state, the metric EMAs), also
with two batches alternating through the ring's slots; and
``upload_counts()`` counts each micro-step under its route.  The file
imports neither jax nor deepclr_tpu:

    python -m pytest tests/test_torch_train_upload.py -q -m cuda -p no:cacheprovider
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepclr_tpu_torch import solver  # noqa: E402
from deepclr_tpu_torch.configs import (KITTI_MODEL_CFG, KITTI_TRAIN_CFG, MODELNET40_MODEL_CFG,  # noqa: E402
                                       MODELNET40_TRAIN_CFG)
from deepclr_tpu_torch.engine import create_train_state, make_train_step  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.losses import MetricType, make_loss_fn, make_metric_fns  # noqa: E402
from deepclr_tpu_torch.models import OutputSimple, build_model  # noqa: E402
from deepclr_tpu_torch.synthetic import cad_train_batch, train_batch  # noqa: E402

LABEL = LabelType.POSE3D_DUAL_QUAT
# recipe -> (model, training recipe, pairs a micro-step, points a cloud, batch maker)
RECIPES = {"kitti_flagship": (KITTI_MODEL_CFG, KITTI_TRAIN_CFG, 4, 16384, train_batch),
           "modelnet40": (MODELNET40_MODEL_CFG, MODELNET40_TRAIN_CFG, 16, 2048, cad_train_batch)}
ROUTES = ("staged", "pinned", "resident")


def _labels(seed, b=6):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, 8)).astype(np.float32)
    return torch.from_numpy(y), torch.from_numpy(y + rng.normal(size=y.shape).astype(np.float32) * 0.1)


# --- the CPU ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("kind,weights", [("mae", [0.5, 1.0, 2.0, 0.25, 3.0, 1.5, 0.75, 4.0]),
                                          ("trans", [1.0]), ("rot", [200.0])])
def test_a_weighted_metric_copies_its_weights_once_a_device(kind, weights):
    """Two calls on one device reuse one weights tensor, a second device
    gets its own; the value is the unweighted term's per-component batch
    means weighted by hand."""
    mt = MetricType.create(kind)
    fn = mt.fn(LABEL, weights=weights)
    s, t = _labels(1)
    first = fn(s, t)
    kept = fn.device_weights[torch.device("cpu")]
    second = fn(s, t)
    assert torch.equal(first, second) and list(fn.device_weights) == [torch.device("cpu")]
    assert fn.device_weights[torch.device("cpu")] is kept
    per_component = mt.fn(LABEL)  # the unweighted term
    if kind == "mae":
        want = sum(w * per_component(s[:, i:i + 1], t[:, i:i + 1]) for i, w in enumerate(weights))
    else:
        want = weights[0] * per_component(s, t)
    torch.testing.assert_close(first, want, rtol=1e-6, atol=0.0)
    fn(s.to("meta"), t.to("meta"))
    on_meta = fn.device_weights[torch.device("meta")]
    fn(s.to("meta"), t.to("meta"))
    assert len(fn.device_weights) == 2 and fn.device_weights[torch.device("meta")] is on_meta
    assert fn.device_weights[torch.device("cpu")] is kept


def _tiny_model(seed=1):
    """The flagship architecture at reduced size, float32, on the CPU."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    params = cfg["params"]
    params["compute_dtype"] = "float32"
    params["cloud_features"]["params"].update(npoint=[16], nsamples=[[32, 64]])
    params["merge"]["params"].update(k=8, mlp=[64, 64, 128])
    params["output"]["params"].update(mlp=[128, 128, 256], linear=[256, 128, 64])
    return build_model(cfg, device="cpu", seed=seed)


def _recipe_parts(model, train_cfg):
    losses = train_cfg["metrics"]["loss"]
    return (solver.make_optimizer(train_cfg, model.parameters()), make_loss_fn(losses, LABEL),
            make_metric_fns(losses, train_cfg["metrics"]["other"], LABEL))


@pytest.mark.parametrize("form", ["numpy", "tensors"])
def test_the_cpu_step_stages_nothing_and_equals_a_plain_loop(form):
    """Four micro-steps at accumulation 2 on the CPU: every one counted
    ``resident``, and the parameters, Ranger's state and the losses equal
    a plain loop's (forward, loss / 2 backward, every 2nd the optimizer's
    step and zero_grad) bit for bit."""
    batches = [train_batch(2, 256, seed=30 + i) for i in range(4)]
    model = _tiny_model()
    opt, loss_fn, metric_fns = _recipe_parts(model, KITTI_TRAIN_CFG)
    seen = []

    def recorded(y_pred, y):
        value = loss_fn(y_pred, y)
        seen.append(value.detach().clone())
        return value

    step = make_train_step(model, opt, recorded, metric_fns, accumulation_steps=2)
    state = create_train_state(model)
    for b in batches:
        step(state, b if form == "numpy" else {k: torch.from_numpy(v) for k, v in b.items()}, 1e-3)
    assert step.upload_counts() == {"staged": 0, "pinned": 0, "resident": 4, "slot_waits": 0}

    plain = _tiny_model()
    popt, ploss, _ = _recipe_parts(plain, KITTI_TRAIN_CFG)
    plain.train()
    heads = [m for m in plain.modules() if isinstance(m, OutputSimple)]
    for g in popt.param_groups:
        g["lr"] = 1e-3
    for i, b in enumerate(batches):
        t = {k: torch.from_numpy(v) for k, v in b.items()}
        for head in heads:
            head.seed_dropout(i)
        y_pred, _ = plain(t["template"], t["source"], t["template_mask"], t["source_mask"], y=t["y"])
        loss = ploss(y_pred, t["y"])
        assert torch.equal(loss, seen[i]), i
        (loss / 2).backward()
        if i % 2 == 1:
            popt.step()
            popt.zero_grad(set_to_none=True)
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), n
        for key, v in opt.state[p].items():
            w = popt.state[q][key]
            assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), (n, key)


# --- the card --------------------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _as_route(batch, route, dev):
    if route == "staged":
        return batch
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    if route == "pinned":
        return {k: v.pin_memory() for k, v in tensors.items()}
    return {k: v.to(dev) for k, v in tensors.items()}


class _Run:
    """The recipe's model (seed 0), optimizer, loss and metrics on the card
    and the trainer's step; ``seen``: every micro-step's loss and poses."""

    def __init__(self, recipe, dev):
        model_cfg, train_cfg, _, _, _ = RECIPES[recipe]
        self.model = build_model(model_cfg, device=dev, seed=0)
        self.opt, loss_fn, metric_fns = _recipe_parts(self.model, train_cfg)
        self.seen = []

        def recorded(y_pred, y):
            value = loss_fn(y_pred, y)
            self.seen.append((value.detach().clone(), y_pred.detach().clone()))
            return value

        self.step = make_train_step(self.model, self.opt, recorded, metric_fns,
                                    accumulation_steps=train_cfg["optimizer"]["accumulation_steps"])
        self.state = create_train_state(self.model)

    def __call__(self, batch):
        return self.step(self.state, batch, 1e-4)

    def bits(self):
        """Everything the steps left, on the host."""
        torch.cuda.synchronize()
        params = {n: p.detach().cpu() for n, p in self.model.named_parameters()}
        opt = {n: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in self.opt.state[p].items()}
               for n, p in self.model.named_parameters()}
        ema = {k: v.cpu() for k, v in self.state.metrics_ema.items()}
        seen = [(v.cpu(), y.cpu()) for v, y in self.seen]
        return params, opt, ema, seen


def _same(a, b) -> bool:
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def _assert_same_bits(got, want):
    (params, opt, ema, seen), (wparams, wopt, wema, wseen) = got, want
    assert list(params) == list(wparams) and sorted(ema) == sorted(wema) and len(seen) == len(wseen)
    for n in params:
        assert torch.equal(params[n], wparams[n]), n
        assert sorted(opt[n]) == sorted(wopt[n]) and all(_same(v, wopt[n][k]) for k, v in opt[n].items()), n
    for k in ema:
        assert torch.equal(ema[k], wema[k]), k
    for i, ((v, y), (wv, wy)) in enumerate(zip(seen, wseen)):
        assert torch.equal(v, wv) and torch.equal(y, wy), i


def _batches(recipe, n, seed):
    _, _, pairs, points, make = RECIPES[recipe]
    return [make(pairs, points, seed=seed + i) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_micro_steps_never_synchronise(dev, recipe):
    """Micro-steps 3-6 of numpy batches (the ring's buffers and the loss
    weights were made in steps 1-2) under sync debug mode "error": no
    operation of the step makes the host wait for the card."""
    run = _Run(recipe, dev)
    batches = _batches(recipe, 2, seed=50)
    for i in range(2):
        run(batches[i % 2])
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, 6):
            run(batches[i % 2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, _, ema, _ = run.bits()
    assert all(torch.isfinite(v).all() for v in ema.values())
    assert run.step.upload_counts()["staged"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_a_profiled_micro_step_holds_no_pageable_copy_and_no_stream_synchronise(dev, recipe):
    """Sync debug mode does not flag a non_blocking copy from pageable
    memory, which drains the stream all the same: the profiler's record
    of two micro-steps after two warm ones holds no ``Pageable`` copy and
    no ``cudaStreamSynchronize``, and holds the pinned copies."""
    from torch.profiler import ProfilerActivity, profile

    run = _Run(recipe, dev)
    batches = _batches(recipe, 2, seed=60)
    for i in range(2):
        run(batches[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            run(batches[i])
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert not [n for n in names if "Pageable" in n], sorted(names)
    assert "cudaStreamSynchronize" not in names
    assert [n for n in names if "Pinned" in n and "HtoD" in n], sorted(names)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_every_route_gives_the_same_bits(dev, recipe):
    """Four micro-steps (two updates) on four batches: numpy through the
    ring, pinned tensors copied straight and tensors on the card give
    bit-equal parameters, Ranger's state, metric EMAs, losses and poses;
    ``upload_counts()`` counts every micro-step under its route."""
    batches = _batches(recipe, 4, seed=70)
    results = {}
    for route in ROUTES:
        run = _Run(recipe, dev)
        for b in batches:
            run(_as_route(b, route, dev))
        counts = run.step.upload_counts()
        assert counts[route] == 4 and sum(counts[r] for r in ROUTES) == 4, (route, counts)
        results[route] = run.bits()
    for route in ("staged", "pinned"):
        _assert_same_bits(results[route], results["resident"])


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_two_batches_alternating_through_the_ring_equal_the_resident_route(dev, recipe):
    """Two batches in turn for six micro-steps, nothing waiting in between:
    the host writes each ring slot again as soon as its last copy has
    finished.  Every micro-step's loss and poses, and the state after
    the six, equal those of the same batches already on the card, so no
    copy read a slot while it was written."""
    batches = _batches(recipe, 2, seed=80)
    ring, resident = _Run(recipe, dev), _Run(recipe, dev)
    on_card = [_as_route(b, "resident", dev) for b in batches]
    for i in range(6):
        ring(batches[i % 2])
    for i in range(6):
        resident(on_card[i % 2])
    counts = ring.step.upload_counts()
    assert counts["staged"] == 6 and counts["pinned"] == counts["resident"] == 0, counts
    _assert_same_bits(ring.bits(), resident.bits())
