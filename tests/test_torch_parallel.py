"""Data-parallel training in the PyTorch port (``deepclr_tpu_torch.parallel``)
on the CPU, over gloo:

(a) two processes of ``python -m deepclr_tpu_torch.training`` under the
    ``DEEPCLR_COORDINATOR`` contract, 4 pairs each, against one process of
    the global batch of 8 (the YAML and bound of
    ``tests/parallel/test_distributed_2proc.py``, its pack with 3.5 m steps
    so that the 100 m segment errors exist): the loss trajectory within
    rtol 5e-3 / atol 1e-5 (the JAX test's bound: the two runs sum the loss
    in another order), the validation scalars within 1e-6, one run
    directory, one ``scalars.jsonl``, and its ``weights.pt`` serving through
    ``load_trained_model``;
(b) two processes joined through torchrun's variables, on a model with
    batch norm (MotionEmbedding and the head) and dropout 0.5, through
    ``run_trainer``, against one process of the global batch in the same
    row order: the final parameters and running statistics within 1e-5.
    Without the global batch statistics of ``models.layers.BatchNorm`` or
    the global-shape dropout masks of ``OutputSimple`` this fails;
(c) in-process contracts: disjoint lock-step loader shards, the
    single-process no-op, the host gathers' identity in one process, a
    one-process gloo group running the data-parallel loop bit for bit like
    the plain one and resuming a checkpoint written without a group,
    checkpoint keys without ``module.``, nothing written by a non-primary
    rank, and every parameter of every model variant reached by the
    backward (DistributedDataParallel runs with ``find_unused_parameters``
    off).

The processes run one thread each; every one has its own timeout.
"""
import glob
import json
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu_torch import parallel  # noqa: E402
from deepclr_tpu_torch.config import Mode, load_config, load_model_config  # noqa: E402
from deepclr_tpu_torch.data import DataLoader, PackWriter, make_data_loader  # noqa: E402
from deepclr_tpu_torch.engine import run_trainer, train  # noqa: E402
from deepclr_tpu_torch.engine import trainer as trainer_mod  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns  # noqa: E402
from deepclr_tpu_torch.models import build_model, init_params, load_trained_model  # noqa: E402
from deepclr_tpu_torch.models.deepclr import DeepCLR, MotionEmbedding, OutputSimple, SetAbstraction  # noqa: E402
from deepclr_tpu_torch.solver import make_optimizer, make_schedule  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
N_FRAMES = 33          # 32 sequential pairs
N_PTS = 64             # == num_points: no subsample or pad randomness
GLOBAL_BATCH = 8
ITERATIONS = 12
STEP_M = 3.5           # 112 m in all: the 100 m KITTI segment errors exist, and depend on the frame order
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_pack(path):
    rng = np.random.default_rng(7)
    pose = np.eye(4)
    with PackWriter(str(path)) as w:
        for i in range(N_FRAMES):
            pose = pose.copy()
            pose[0, 3] += STEP_M
            pose[1, 3] += 0.05
            w.put(f"{i:08d}", {"idx": i, "timestamp": float(i), "pose": pose,
                               "cloud": rng.normal(size=(N_PTS, 4)).astype(np.float32)})


def _write_cfg(ws, run, batch_size, checkpoint_period=1000, **optimizer):
    """tests/parallel/test_distributed_2proc.py's YAML, on the CPU."""
    cfg = {
        "base_dir": str(ws / run), "identifier": run, "seed": 3, "device": "cpu",
        "data": {"training": str(ws / "train.pack"), "validation": str(ws / "train.pack"),
                 "dataset_type": "kitti_odometry_velodyne", "sequential": True},
        # no augmentation transforms: the batches hold the same samples however they are sharded
        "data_loader": {"batch_size": batch_size, "num_points": N_PTS, "num_workers": 0, "buffer_size": 0},
        "model": {"input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr",
                  "params": {"batch_norm": False, "dropout": 1.0,
                             "cloud_features": {"name": "SetAbstraction", "params": {
                                 "npoint": [16], "radii": [[0.6, 1.2]], "nsamples": [[4, 8]],
                                 "mlps": [[[4, 8], [4, 8]]]}},
                             "merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [8, 16]}},
                             "output": {"name": "OutputSimple", "params": {"mlp": [16, 32], "linear": [32, 16]}}}},
        "metrics": {"loss": [{"type": "trans", "weights": [1.0], "params": {"p": 2}},
                             {"type": "rot", "weights": [200.0], "params": {"p": 2}}]},
        "optimizer": {"name": "Adam", "max_iterations": ITERATIONS, "base_lr": 1e-4} | optimizer,
        "logging": {"summary_period": 1, "log_period": 100, "checkpoint_period": checkpoint_period,
                    "checkpoint_n_saved": 2, "validation_period": 1000},
    }
    (ws / run).mkdir(exist_ok=True)
    path = ws / f"{run}.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return str(path)


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in ("DEEPCLR_COORDINATOR", "DEEPCLR_DISTRIBUTED", "DEEPCLR_LOCAL_DEVICE_IDS",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    env.update(extra)
    return env


def _rank_env(port, rank):
    return _env(DEEPCLR_COORDINATOR=f"127.0.0.1:{port}", DEEPCLR_NUM_PROCESSES="2", DEEPCLR_PROCESS_ID=str(rank))


def _torchrun_env(port, rank):
    """What ``torchrun`` sets for a rank, and DEEPCLR_DISTRIBUTED=1."""
    return _env(DEEPCLR_DISTRIBUTED="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                RANK=str(rank), LOCAL_RANK=str(rank))


def _wait(procs):
    """Wait for every process, each within TIMEOUT_S; kill all on the first
    timeout.  Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(i, p.returncode, out[-3000:]) for i, (p, out) in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad
    return outs


def _popen(args, env):
    return subprocess.Popen([sys.executable, *args], env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _scalars(base_dir):
    files = sorted(glob.glob(osp.join(base_dir, "*", "scalars.jsonl")))
    assert len(files) == 1, f"expected one scalars.jsonl, got {files}"
    out = {}
    with open(files[0]) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _series(scalars, tag):
    return np.asarray([v for _, v in sorted(scalars[tag].items())])


# --- (a) two CLI processes against one --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("dp")
    _make_pack(ws / "train.pack")
    return ws


def _grad_acc(base_dir, iteration):
    path, = glob.glob(osp.join(base_dir, "*", f"ckpt_{iteration}.pt"))
    return torch.load(path, weights_only=True)["state"]["grad_acc"]


def test_two_processes_match_one_process_of_the_global_batch(ws):
    """Checkpoints every 5 micro-steps of accumulation 2: the one at 5 is
    mid-update and must hold the global batch's partial gradient (the
    ranks' mean), not rank 0's own."""
    single = _write_cfg(ws, "single", GLOBAL_BATCH, checkpoint_period=5, accumulation_steps=2)
    two = _write_cfg(ws, "twoproc", GLOBAL_BATCH // 2, checkpoint_period=5, accumulation_steps=2)
    port = _free_port()
    procs = [_popen(["-m", "deepclr_tpu_torch.training", single], _env())]
    procs += [_popen(["-m", "deepclr_tpu_torch.training", two], _rank_env(port, r)) for r in range(2)]
    outs = _wait(procs)
    assert "2 processes" in outs[1] and "1 processes" in outs[0]

    one_s, two_s = _scalars(str(ws / "single")), _scalars(str(ws / "twoproc"))
    loss1, loss2 = _series(one_s, "train/loss_fn"), _series(two_s, "train/loss_fn")
    assert len(loss1) == len(loss2) == ITERATIONS
    np.testing.assert_allclose(loss2, loss1, rtol=5e-3, atol=1e-5)

    val_tags = sorted(t for t in one_s if t.startswith("val/"))
    assert "val/kitti_t_err" in val_tags and "val/step_t_err" in val_tags
    assert sorted(t for t in two_s if t.startswith("val/")) == val_tags
    for tag in val_tags:
        assert np.isfinite(_series(one_s, tag)).all(), tag
        np.testing.assert_allclose(_series(two_s, tag), _series(one_s, tag), rtol=1e-6, atol=1e-7, err_msg=tag)

    want, got = _grad_acc(str(ws / "single"), 5), _grad_acc(str(ws / "twoproc"), 5)
    assert sorted(got) == sorted(want) and want
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0, atol=1e-4 * max(1e-6, g.abs().max().item()),
                                   err_msg=k)

    # rank 1 wrote nothing: one run directory, holding the final checkpoint
    runs = [d for d in glob.glob(str(ws / "twoproc" / "*")) if osp.isdir(d) and os.listdir(d)]
    assert len(runs) == 1, runs
    assert glob.glob(osp.join(runs[0], "ckpt_final_*.pt"))
    # its weights serve without a group: the model's own keys
    weights = osp.join(runs[0], "weights.pt")
    assert not [k for k in torch.load(weights, weights_only=True) if k.startswith("module.")]
    model = load_trained_model(load_model_config(osp.join(runs[0], "model_config.yaml"), weights), weights,
                               device="cpu")
    clouds = torch.from_numpy(np.random.default_rng(0).normal(size=(2, N_PTS, 4)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(model(clouds, clouds)[0]).all()


# --- (b) batch norm and dropout over the global batch --------------------------------------------------------

BN_ITERATIONS = 6


def _bn_dropout_model(seed):
    """The YAML's widths with batch norm in MotionEmbedding and the head and
    dropout 0.5 after the head's linear layer (a whole-model batch_norm
    raises in SetAbstraction, as in the JAX package)."""
    sa = SetAbstraction(4, npoint=[16], radii=[[0.6, 1.2]], nsamples=[[4, 8]], mlps=[[[4, 8], [4, 8]]])
    merge = MotionEmbedding(sa.out_dim - 3, mlp=[8, 16], k=4, radius=10.0, batch_norm=True)
    head = OutputSimple(3 + 16, mlp=[16, 32], linear=[32, 16], label_type=LabelType.POSE3D_DUAL_QUAT,
                        batch_norm=True, dropout_keep=0.5, dropout_seed=seed)
    model = DeepCLR(sa, merge, head, input_dim=4, point_dim=3, label_type=LabelType.POSE3D_DUAL_QUAT)
    return init_params(model, seed).eval()


class _GlobalBatches:
    """One process's batches of the global batch: the shards' batches side
    by side, rank 0's rows first (the rows a two-process run holds)."""

    def __init__(self, loaders):
        self.loaders = loaders

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0] if isinstance(parts[0][k], np.ndarray)}


def _bn_run(yaml_path, loader, output_dir=None):
    cfg = load_config(yaml_path, Mode.TEST)
    plain = cfg.to_dict()
    model = _bn_dropout_model(cfg.seed)
    run_trainer(plain, model, loader, None, make_optimizer(plain, model.parameters()), make_schedule(plain),
                make_loss_fn(plain["metrics"]["loss"], LabelType.POSE3D_DUAL_QUAT),
                make_metric_fns(plain["metrics"]["loss"], [], LabelType.POSE3D_DUAL_QUAT), output_dir=output_dir)
    return model


def bn_dropout_rank(yaml_path, output_dir):
    """One rank of (b), started by the test in its own process."""
    torch.set_num_threads(1)
    parallel.maybe_initialize()
    try:
        cfg = load_config(yaml_path, Mode.TEST)
        loader = DataLoader(cfg, True, shard_index=parallel.process_index(), num_shards=parallel.process_count())
        _bn_run(yaml_path, loader, output_dir)
    finally:
        parallel.shutdown()


def test_batch_norm_and_dropout_see_the_global_batch(ws, tmp_path):
    """Fails without the global statistics in ``BatchNorm`` (each rank would
    normalise over its 4 pairs) or without the global-shape masks in
    ``OutputSimple._dropout`` (rank 1 would draw rank 0's masks).  The
    ranks join through torchrun's variables (``env://``).  Ranger: its
    first steps are momentum alone, where Adam would turn the float-noise
    gradients of the biases that batch norm cancels into ±lr steps that
    differ between the runs."""
    path = _write_cfg(ws, "bn", GLOBAL_BATCH // 2, name="Ranger", base_lr=1e-3, max_iterations=BN_ITERATIONS)
    out = tmp_path / "bn_run"
    code = f"from tests.test_torch_parallel import bn_dropout_rank; bn_dropout_rank({path!r}, {str(out)!r})"
    port = _free_port()
    procs = [_popen(["-c", code], _torchrun_env(port, r)) for r in range(2)]
    try:
        cfg = load_config(path, Mode.TEST)
        ref = _bn_run(path, _GlobalBatches([DataLoader(cfg, True, shard_index=r, num_shards=2) for r in range(2)]))
    finally:
        _wait(procs)
    got = torch.load(str(out / f"weights_final_{BN_ITERATIONS}.pt"), weights_only=True)
    want = ref.state_dict()
    assert sorted(got) == sorted(want)
    assert any("running_var" in k for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5 * max(1.0, v.abs().max().item()),
                                   err_msg=k)


# --- (c) in-process contracts ---------------------------------------------------------------------------------

def _small_cfg(ws, name, **optimizer):
    return load_config(_write_cfg(ws, name, 2, **optimizer), Mode.TEST)


@pytest.mark.parametrize("num_shards", [2, 3])
def test_loader_shards_are_disjoint_and_in_lock_step(ws, num_shards):
    cfg = _small_cfg(ws, "shards")
    ids = []
    for shard in range(num_shards):
        loader = make_data_loader(cfg, True, shard_index=shard, num_shards=num_shards)
        stamps = [np.asarray(b["t"])[:, -1] for b in loader]
        assert len(stamps) == len(loader) == (N_FRAMES - 1) // num_shards // 2
        assert {len(s) for s in stamps} == {2}  # full batches only
        ids.append({float(t) for s in stamps for t in s})
    for i in range(num_shards):
        for j in range(i + 1, num_shards):
            assert not ids[i] & ids[j]
    assert sum(len(s) for s in ids) == num_shards * len(loader) * 2


def test_a_single_process_initialises_nothing(monkeypatch):
    for var in ("DEEPCLR_COORDINATOR", "DEEPCLR_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.maybe_initialize() is False
    monkeypatch.setenv("DEEPCLR_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DEEPCLR_NUM_PROCESSES", "1")
    monkeypatch.setenv("DEEPCLR_PROCESS_ID", "0")
    assert parallel.maybe_initialize() is False
    assert not parallel.initialized()
    assert (parallel.process_index(), parallel.process_count(), parallel.is_primary()) == (0, 1, True)
    assert parallel.local_device() == torch.device("cpu")


def test_a_failed_initialisation_raises(monkeypatch):
    monkeypatch.delenv("DEEPCLR_COORDINATOR", raising=False)
    monkeypatch.setenv("DEEPCLR_DISTRIBUTED", "1")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        parallel.maybe_initialize()
    assert not parallel.initialized()


def test_host_gathers_are_the_identity_in_one_process():
    stamps = np.asarray([1.6e9 + 0.001, 1.6e9 + 0.002], dtype=np.float64)  # float32 would round to 128 s
    out = parallel.allgather_host_f64(stamps)
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, stamps)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(parallel.allgather_host(x), x)
    assert parallel.allgather_host_strings(["00", 4]) == ["00", "4"]
    t = torch.arange(3.0)
    assert parallel.mean_over_processes(t) is t


def _trained(cfg, iterations, checkpoint=None, output_dir=None):
    plain = cfg.to_dict()
    plain["optimizer"]["max_iterations"] = iterations
    model = build_model(cfg.model, device="cpu", seed=cfg.seed)
    loader = make_data_loader(cfg, True)
    run_trainer(plain, model, loader, None, make_optimizer(plain, model.parameters()), make_schedule(plain),
                make_loss_fn(plain["metrics"]["loss"], cfg.model.label_type),
                make_metric_fns(plain["metrics"]["loss"], [], cfg.model.label_type),
                output_dir=output_dir, checkpoint=checkpoint)
    return model


def test_one_process_group_trains_like_no_group_and_resumes_its_checkpoint(ws, tmp_path):
    """A group of one runs the data-parallel loop (DistributedDataParallel,
    the all-reduced metrics) and must equal the plain loop bit for bit,
    both resuming one checkpoint written without a group (accumulation 3,
    so the checkpoint at 4 micro-steps holds a partial gradient); the
    group's checkpoints carry no ``module.`` prefix."""
    cfg = _small_cfg(ws, "onegroup", accumulation_steps=3)
    first = str(tmp_path / "first" / "ckpt.pt")
    _trained(cfg, 4, output_dir=osp.dirname(first))
    plain = _trained(cfg, 8, checkpoint=first).state_dict()
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                                         rank=0, timeout=parallel.distributed.TIMEOUT)
    try:
        resumed = _trained(cfg, 8, checkpoint=first, output_dir=str(tmp_path / "dp"))
    finally:
        parallel.shutdown()
    for k, v in plain.items():
        assert torch.equal(resumed.state_dict()[k], v), k
    # 8 micro-steps are 2 updates and 2 of the next: the checkpoint holds a partial gradient
    ckpt = torch.load(str(tmp_path / "dp" / "ckpt.pt"), weights_only=True)
    for keys in (ckpt["state"]["model"], ckpt["state"]["grad_acc"], torch.load(str(tmp_path / "dp" / "weights.pt"),
                                                                                weights_only=True)):
        assert keys and not [k for k in keys if k.startswith("module.")]


def test_a_non_primary_rank_writes_nothing(ws, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "is_primary", lambda: False)
    monkeypatch.setattr(trainer_mod, "process_index", lambda: 1)
    cfg = _small_cfg(ws, "rank1", max_iterations=2)
    cfg.defrost()
    cfg.output_dir = str(tmp_path / "rank1_out")
    cfg.logging.checkpoint_period = 1
    cfg.freeze()
    state = train(cfg)
    assert state.step == 2
    assert not osp.exists(cfg.output_dir), os.listdir(cfg.output_dir)


@pytest.mark.parametrize("params", [
    {},
    {"loss": {"name": "TransformUncertaintyLoss", "params": {"sx": 0.0, "sq": -2.5}}},
    {"fused": False},
    {"merge": {"name": "MotionEmbedding", "params": {"k": 0, "radius": 10.0, "mlp": [8, 16]}}},
    {"merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [8, 16],
                                                     "append_features": False}}},
    {"dropout": 0.5},
], ids=["flagship", "loss_module", "exact", "k0", "no_append", "dropout"])
def test_every_parameter_gets_a_gradient(ws, params):
    """DistributedDataParallel runs with find_unused_parameters off, which
    raises at the next step if a parameter got no gradient: every variant's
    backward reaches every parameter, through the loss the train step uses
    (the model's loss module when it has one, else loss_fn)."""
    cfg = yaml.safe_load(open(_write_cfg(ws, "variant", 2)))
    cfg["model"]["params"].update(params)
    model = build_model(cfg["model"], device="cpu", seed=0).train()
    rng = np.random.default_rng(1)
    clouds = [torch.from_numpy(rng.normal(size=(2, N_PTS, 4)).astype(np.float32)) for _ in range(2)]
    y = torch.tensor([[1.0, 0, 0, 0, 0, 0.1, 0, 0]] * 2)
    y_pred, model_loss = model(*clouds, y=y)
    loss = model_loss if model.loss_module is not None else make_loss_fn(cfg["metrics"]["loss"], model.label_type)(
        y_pred, y)
    loss.backward()
    assert not [n for n, p in model.named_parameters() if p.grad is None]
    bn = _bn_dropout_model(0).train()
    bn(*clouds)[0].sum().backward()
    assert not [n for n, p in bn.named_parameters() if p.grad is None]


def test_the_model_computes_locally_until_the_trainer_sets_its_group(ws, tmp_path, monkeypatch):
    """``models/`` imports nothing of ``parallel/``: under a process group a
    training forward of a bare model is local (no all-reduce), and only
    ``wrap_data_parallel`` makes its batch norms and dropout collective;
    ``run_trainer`` sets them back to local when its loop ends."""
    import ast

    for path in glob.glob(osp.join(REPO, "deepclr_tpu_torch", "models", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom):
                assert "parallel" not in (node.module or "").split("."), (path, node.module)

    import torch.distributed.nn.functional as dist_fn

    calls = []
    all_reduce = dist_fn.all_reduce
    monkeypatch.setattr(dist_fn, "all_reduce", lambda t, *a, **k: calls.append(1) or all_reduce(t, *a, **k))
    rng = np.random.default_rng(1)
    clouds = [torch.from_numpy(rng.normal(size=(2, N_PTS, 4)).astype(np.float32)) for _ in range(2)]
    model = _bn_dropout_model(0).train()
    norms = [m for m in model.modules() if isinstance(m, (parallel.mesh.BatchNorm, OutputSimple))]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                                         rank=0, timeout=parallel.distributed.TIMEOUT)
    try:
        local = model(*clouds)[0]
        assert not calls and all(m.process_group is None for m in norms)
        parallel.wrap_data_parallel(model)
        assert all(m.process_group is torch.distributed.group.WORLD for m in norms)
        model.output.seed_dropout(0)  # the masks of the first forward again
        grouped = model(*clouds)[0]
        n_bn = sum(isinstance(m, parallel.mesh.BatchNorm) for m in norms)
        assert n_bn and len(calls) == n_bn
        torch.testing.assert_close(grouped, local, rtol=1e-6, atol=1e-6)  # a group of one: the same statistics
        trained = _trained(_small_cfg(ws, "regroup"), 2)
    finally:
        parallel.shutdown()
    assert all(m.process_group is None for m in trained.modules() if isinstance(m, OutputSimple))
