"""Training from a YAML in the PyTorch port (deepclr_tpu_torch.engine.train,
``python -m deepclr_tpu_torch.training`` and ``.timing``) on the CPU:

(a) ``run_trainer`` against the JAX package's: 8 micro-steps, accumulation
    2, Ranger, float32, validation every 4 (and after the final checkpoint),
    each package with its own loader over one pack, the same initial weights
    (the port's through ``load_jax_params``); the ``scalars.jsonl`` values of
    every tag and the final weights agree.  The ``on_validation`` case holds
    the validation counter that drives its schedule to JAX's;
(b) the training CLI: the JAX artifact set and tags, then the run directory
    as a model directory of ``python -m deepclr_tpu_torch.inference``;
(c) SIGINT to the CLI leaves an interrupt checkpoint, and ``--ckpt``
    resumes to the parameters of an uninterrupted run, bit for bit;
(d) validation without matplotlib still writes ``val/kitti_*``;
(e) the timing CLI prints one line a pair and three summary lines.

Tolerances: (a) float32 on both sides, but the two forwards sum matmuls and
distances in other orders (``test_torch_train.py`` holds one micro-step's
metrics to 1e-4), and Ranger's normalised steps carry those differences into
the weights over 4 updates: 1e-3 of each value (of each weight array's scale).
"""
import glob
import json
import os
import os.path as osp
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepclr_tpu.config import Mode as JaxMode  # noqa: E402
from deepclr_tpu.config import load_config as jax_load_config  # noqa: E402
from deepclr_tpu.data import make_data_loader as jax_make_data_loader  # noqa: E402
from deepclr_tpu.engine import run_trainer as jax_run_trainer  # noqa: E402
from deepclr_tpu.losses import make_loss_fn as jax_make_loss_fn  # noqa: E402
from deepclr_tpu.losses import make_metric_fns as jax_make_metric_fns  # noqa: E402
from deepclr_tpu.models import build_model as jax_build_model, init_params as jax_init_params  # noqa: E402
from deepclr_tpu.models.torch_convert import convert_torch_state_dict  # noqa: E402
from deepclr_tpu.solver import make_optimizer as jax_make_optimizer  # noqa: E402
from deepclr_tpu.solver import make_schedule as jax_make_schedule  # noqa: E402
from deepclr_tpu_torch import solver  # noqa: E402
from deepclr_tpu_torch.config import Mode, load_config  # noqa: E402
from deepclr_tpu_torch.data import PackWriter, make_data_loader  # noqa: E402
from deepclr_tpu_torch.engine import run_trainer, train  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns  # noqa: E402
from deepclr_tpu_torch.models import build_model, load_jax_params  # noqa: E402

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
NUM_POINTS = 128
TAGS = ("train/loss", "params/lr", "val/loss_fn", "val/step_t_err", "val/kitti_t_err")


def _write_sequence(path, n_frames, seed=0, n_points=None):
    rng = np.random.default_rng(seed)
    with PackWriter(str(path)) as w:
        for i in range(n_frames):
            pose = np.eye(4)
            pose[0, 3] = i * 1.0
            pose[1, 3] = 0.1 * np.sin(i)
            n = n_points or 100 + 5 * i
            w.put(f"{i:08d}", {"idx": i, "timestamp": i * 0.1e6, "pose": pose,
                               "cloud": rng.normal(size=(n, 4)).astype(np.float32) * 5})


def _cfg_dict(ws, identifier, device="cpu", **overrides):
    """The widths of tests/engine/test_train_end_to_end.py, float32."""
    cfg = {
        "base_dir": str(ws / "models"), "identifier": identifier, "seed": 1, "device": device,
        "data": {"training": str(ws / "00.pack"), "validation": str(ws / "00.pack"),
                 "dataset_type": "kitti_odometry_velodyne", "sequential": True},
        "transforms": {"point_noise": {"scale": 0.01}, "translation_noise": {"scale": [0.1, 0.01, 0.01]},
                       "rotation_noise_deg": {"scale": [0.1, 0.1, 0.5]}},
        "data_loader": {"batch_size": 4, "num_points": NUM_POINTS, "num_workers": 0, "buffer_size": 0},
        "model": {"input_dim": 4, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr",
                  "params": {"batch_norm": False, "dropout": 1.0, "compute_dtype": "float32",
                             "cloud_features": {"name": "SetAbstraction", "params": {
                                 "npoint": [32], "radii": [[1.0, 2.0]], "nsamples": [[8, 16]],
                                 "mlps": [[[8, 8, 16], [8, 8, 16]]]}},
                             "merge": {"name": "MotionEmbedding", "params": {"k": 4, "radius": 10.0, "mlp": [16, 32]}},
                             "output": {"name": "OutputSimple", "params": {"mlp": [32, 64], "linear": [64, 32]}}}},
        "metrics": {"loss": [{"type": "trans", "weights": [1.0], "params": {"p": 2}},
                             {"type": "rot", "weights": [200.0], "params": {"p": 2}}],
                    "other": [{"type": "quat_norm"}]},
        "optimizer": {"name": "Ranger", "base_lr": 0.001, "max_iterations": 8, "accumulation_steps": 2},
        "scheduler": {"name": "CyclicLRWithFlatAndCosineAnnealing", "on_iteration": True,
                      "params": {"cyclic_iterations": 4, "flat_iterations": 2, "annealing_iterations": 2,
                                 "base_lr": 1e-4, "max_lr": 1e-3, "step_size_up": 2, "mode": "triangular"}},
        "logging": {"log_period": 2, "summary_period": 2, "checkpoint_period": 4, "validation_period": 4,
                    "checkpoint_n_saved": 3},
    }
    for key, value in overrides.items():
        section, name = key.split(".")
        cfg[section][name] = value
    return cfg


def _write_yaml(ws, name, cfg):
    path = ws / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return str(path)


def _scalars(run_dir):
    out = {}
    with open(osp.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return out


def _env(ws):
    return dict(os.environ, MODEL_PATH=str(ws / "models"), JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _run(cmd, env, timeout=300):
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, f"{cmd}\nSTDOUT:\n{out.stdout[-2000:]}\nSTDERR:\n{out.stderr[-3000:]}"
    return out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("train_yaml")
    _write_sequence(ws / "00.pack", 17)
    return ws


# --- (a) run_trainer against the JAX package's ----------------------------------------------------

def _nonzero_biases(params, seed=5):
    """Non-zero biases: JAX's maximum(x, 0) has gradient 0.5 at 0, torch's 0."""
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(randomize, params)


class _Recorded:
    """A schedule that records the counts it is called with."""

    def __init__(self, schedule):
        self.schedule, self.counts = schedule, []

    def __call__(self, count):
        self.counts.append(int(count))
        return self.schedule(count)


@pytest.mark.parametrize("counter", ["on_iteration", "on_validation"])
def test_run_trainer_matches_jax(ws, counter):
    sched = {"on_iteration": counter == "on_iteration", "on_validation": counter == "on_validation"}
    d = _cfg_dict(ws, f"parity_{counter}", **{"scheduler.on_iteration": sched["on_iteration"],
                                              "scheduler.on_validation": sched["on_validation"]})
    if counter == "on_validation":
        d["logging"]["validation_period"] = 2
        d["scheduler"]["params"].update(cyclic_iterations=2, flat_iterations=1, annealing_iterations=1,
                                        step_size_up=1)
    path = _write_yaml(ws, f"parity_{counter}", d)
    jcfg = jax_load_config(path, JaxMode.NEW)
    cfg = load_config(path, Mode.NEW)

    jmodel = jax_build_model(jcfg.model)
    variables = jax.jit(lambda key: jax_init_params(jmodel, key, num_points=NUM_POINTS, batch_size=1))(
        jax.random.PRNGKey(cfg.seed))
    params = _nonzero_biases(variables["params"])
    jsched = _Recorded(jax_make_schedule(jcfg))
    jloss = jax_make_loss_fn(jcfg.metrics.loss, jcfg.model.label_type)
    jmetrics = jax_make_metric_fns(jcfg.metrics.loss, jcfg.metrics.other, jcfg.model.label_type)
    jstate = jax_run_trainer(jcfg, jmodel, {"params": params}, jax_make_data_loader(jcfg, True),
                             jax_make_data_loader(jcfg, False), jax_make_optimizer(jcfg), jsched, jloss, jmetrics)

    plain = cfg.to_dict()
    model = build_model(cfg.model, device="cpu", seed=cfg.seed)
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    opt = solver.make_optimizer(plain, model.parameters())
    psched = _Recorded(solver.make_schedule(plain))
    loss_types = plain["metrics"]["loss"]
    assert [m["type"] for m in loss_types] == ["trans", "rot"]  # names make_loss_fn takes
    run_trainer(plain, model, make_data_loader(cfg, True), make_data_loader(cfg, False), opt, psched,
                make_loss_fn(loss_types, "pose3d_dual_quat"),
                make_metric_fns(loss_types, plain["metrics"]["other"], "pose3d_dual_quat"),
                output_dir=str(ws / f"port_parity_{counter}"))

    assert psched.counts == jsched.counts
    if counter == "on_validation":
        assert psched.counts == [0, 0, 1, 1, 2, 2, 3, 3]
    got, ref = _scalars(ws / f"port_parity_{counter}"), _scalars(jcfg.output_dir)
    assert sorted(got) == sorted(ref) and set(TAGS) <= set(got)
    n_val = 3 if counter == "on_iteration" else 5  # every period, then after the final checkpoint
    assert len(got["val/loss_fn"]) == n_val
    for tag, values in ref.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in values], tag
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in values], rtol=1e-3, atol=1e-6,
                                   equal_nan=True, err_msg=tag)
    trained = convert_torch_state_dict(model.state_dict(), strict=True)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(trained)[0])
    for path_, want in jax.tree_util.tree_flatten_with_path(jax.device_get(jstate.params))[0]:
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(flat_got[path_]), want, rtol=1e-3,
                                   atol=1e-3 * max(1e-6, np.abs(want).max()), err_msg=jax.tree_util.keystr(path_))


# --- (b) the CLI, then inference from its run directory -------------------------------------------

def test_training_cli_writes_a_model_directory_that_inference_loads(ws):
    path = _write_yaml(ws, "cli", _cfg_dict(ws, "cli"))
    env = _env(ws)
    _run([sys.executable, "-m", "deepclr_tpu_torch.training", path], env)
    (run_dir,) = glob.glob(str(ws / "models" / "*_cli"))
    for name in ("config.yaml", "model_config.yaml", "scalars.jsonl", "ckpt_final_8.pt", "weights_final_8.pt"):
        assert osp.exists(osp.join(run_dir, name)), name
    assert osp.exists(osp.join(run_dir, "models", "deepclr.py"))
    assert osp.islink(osp.join(run_dir, "ckpt.pt")) and osp.islink(osp.join(run_dir, "weights.pt"))
    assert os.readlink(osp.join(run_dir, "weights.pt")) == "weights_final_8.pt"
    assert glob.glob(osp.join(run_dir, "log_*.txt"))
    scalars = _scalars(run_dir)
    assert set(TAGS) <= set(scalars)
    assert all(np.isfinite(v) for tag in TAGS[:4] for _, v in scalars[tag])
    with open(osp.join(run_dir, "model_config.yaml")) as f:
        assert yaml.safe_load(f)["params"]["compute_dtype"] == "float32"

    scenario = ws / "scenario.yaml"
    with open(scenario, "w") as f:
        yaml.dump({"name": "synth", "dataset_type": "kitti_odometry_velodyne", "sequential": True,
                   "data": {"00": str(ws / "00.pack")}}, f)
    out = ws / "inference"
    _run([sys.executable, "-m", "deepclr_tpu_torch.inference", str(scenario), osp.basename(run_dir), str(out),
          "--model_path", str(ws / "models"), "--num_points", str(NUM_POINTS), "--device", "cpu"], env)
    (result,) = os.listdir(out)
    rows = np.loadtxt(out / result / "00.txt")
    assert rows.shape == (16, 26) and np.isfinite(rows).all()


# --- (c) SIGINT, then --ckpt resumes to the uninterrupted parameters ------------------------------

def test_interrupt_and_resume_give_the_uninterrupted_params(tmp_path):
    """One pair, no random transform and no subsample: every epoch is the
    same batch, so the resumed run sees what the uninterrupted one saw."""
    _write_sequence(tmp_path / "00.pack", 2, n_points=NUM_POINTS)
    iters = 400
    base = _cfg_dict(tmp_path, "full", **{"optimizer.max_iterations": iters})
    base["data"]["validation"] = None
    base["transforms"] = {}
    base["data_loader"]["batch_size"] = 1
    base["logging"].update(log_period=50, summary_period=50, checkpoint_period=5, checkpoint_n_saved=2)
    env = _env(tmp_path)
    full = _write_yaml(tmp_path, "full", base)
    cut = _write_yaml(tmp_path, "cut", dict(base, identifier="cut"))
    _run([sys.executable, "-m", "deepclr_tpu_torch.training", full], env)

    child = subprocess.Popen([sys.executable, "-u", "-m", "deepclr_tpu_torch.training", cut], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 240
    while time.time() < deadline and child.poll() is None:
        # any numbered checkpoint: the older ones are pruned (checkpoint_n_saved)
        if glob.glob(str(tmp_path / "models" / "*_cut" / "ckpt_[0-9]*.pt")):
            break
        time.sleep(0.05)
    child.send_signal(signal.SIGINT)
    out, _ = child.communicate(timeout=120)
    assert child.returncode == 0, out
    interrupts = glob.glob(str(tmp_path / "models" / "*_cut" / "ckpt_interrupt_*.pt"))
    assert len(interrupts) == 1 and not glob.glob(str(tmp_path / "models" / "*_cut" / "ckpt_final_*.pt")), out
    stopped_at = int(interrupts[0].rsplit("_", 1)[1][:-3])
    assert 5 <= stopped_at < iters

    resume = _write_yaml(tmp_path, "resume", dict(base, identifier="resumed"))
    _run([sys.executable, "-m", "deepclr_tpu_torch.training", resume, "--ckpt", interrupts[0]], env)
    (resumed,) = glob.glob(str(tmp_path / "models" / "*_resumed*" / f"weights_final_{iters}.pt"))
    (ref,) = glob.glob(str(tmp_path / "models" / "*_full" / f"weights_final_{iters}.pt"))
    got, want = torch.load(resumed), torch.load(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# --- (d) validation without matplotlib ------------------------------------------------------------

@pytest.mark.parametrize("matplotlib", [True, False])
def test_validation_writes_kitti_errors_with_or_without_matplotlib(ws, monkeypatch, matplotlib):
    import logging

    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` raises
    d = _cfg_dict(ws, f"mpl_{matplotlib}", **{"optimizer.max_iterations": 2})
    d["logging"].update(validation_period=1, checkpoint_period=100)
    cfg = load_config(_write_yaml(ws, f"mpl_{matplotlib}", d), Mode.NEW)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("deepclr_tpu_torch.engine.trainer")
    log.addHandler(handler)
    try:
        train(cfg)
    finally:
        log.removeHandler(handler)
    scalars = _scalars(cfg.output_dir)
    assert len(scalars["val/kitti_t_err"]) == len(scalars["val/kitti_r_err"]) == 3
    skipped = [r for r in records if "figures are skipped" in r.getMessage()]
    assert len(skipped) == (0 if matplotlib else 1)


# --- (e) the timing CLI ---------------------------------------------------------------------------

def test_timing_cli_prints_a_line_a_pair_and_the_summary(ws):
    path = _write_yaml(ws, "timing", _cfg_dict(ws, "timing"))
    out = _run([sys.executable, "-m", "deepclr_tpu_torch.timing", path, "--sequential"], _env(ws)).stdout
    lines = [ln for ln in out.splitlines() if ln.strip() and " INFO: " not in ln]
    assert len(lines) == 16 + 3, out
    assert all(float(ln) > 0 for ln in lines[:16])
    assert lines[16].startswith("# wall ms/frame") and "upload_dtype=float32" in lines[16]
    assert lines[17].startswith("# compute-only ms/frame") and lines[18].startswith("# upload+pad+dispatch tax")


def test_timing_pairwise_returns_both_passes(ws, capsys):
    from deepclr_tpu_torch.timing import timing

    cfg = load_config(_write_yaml(ws, "timing_pairs", _cfg_dict(ws, "timing_pairs")), Mode.TEST)
    result = timing(cfg, sequential=False, upload_dtype="uint16")
    assert len(result["wall_ms"]) == len(result["compute_ms"]) == 16
    assert "(upload_dtype=uint16)" in capsys.readouterr().out
