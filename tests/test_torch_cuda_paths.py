"""The port's paths on the card, end to end, each held to the CPU, to a
second run, or to one process of the global batch:

* serving and training of the flagship at full width (16 pairs and 5 pairs
  of 16384 points), the fused and the exact set abstraction; a micro-step
  under ``torch.use_deterministic_algorithms(True)``; float32 gradients
  against the CPU's;
* the kernels on a training batch of each recipe (ray-cast KITTI scans,
  CAD clouds), the gather backward at the batch's own kNN index;
* scenario inference on frames of a scan's size through
  ``inference.run_scenario``; the ICP CLI on ray-cast scans;
* training the shipped ModelNet40 YAML, then inference from its run
  directory; both demos;
* data-parallel training from the shipped ``kitti_base.yaml``: two runs
  without a group, a one-rank NCCL group, two gloo ranks sharing the card
  and, on a host with several cards, one NCCL rank a card (torchrun);
* the model's variant modules and the exact model on differently sized
  clouds against the CPU.

Every test needs an NVIDIA GPU and skips without one (the cases across
cards skip on a host with fewer than two); the file imports neither jax
nor deepclr_tpu.  Run on the card:

    python -m pytest tests/test_torch_cuda_paths.py -q -m cuda -p no:cacheprovider
"""
import copy
import importlib
import json
import logging
import os
import os.path as osp
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deepclr_tpu_torch import inference, ops, parallel, solver  # noqa: E402
from deepclr_tpu_torch.config import Mode, load_config, load_model_config  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG  # noqa: E402
from deepclr_tpu_torch.data import PackWriter, create_input_dataflow  # noqa: E402
from deepclr_tpu_torch.data.synthetic import cad_cloud, drive  # noqa: E402
from deepclr_tpu_torch.data.transforms import FarthestPointSampling, SystematicErasing  # noqa: E402
from deepclr_tpu_torch.engine import create_train_state, make_train_step, run_trainer  # noqa: E402
from deepclr_tpu_torch.engine import trainer  # noqa: E402
from deepclr_tpu_torch.evaluation import Evaluator, scenario_from_dict  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.geometry.hostmath import label_from_matrix_np  # noqa: E402
from deepclr_tpu_torch.icp import ICPRegistration  # noqa: E402
from deepclr_tpu_torch.icp import cli as icp_cli  # noqa: E402
from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns  # noqa: E402
from deepclr_tpu_torch.models import (BatchedSequentialHelper, FeaturePropagation, ModelInferenceHelper,  # noqa: E402
                                      MotionEmbedding, OutputSimple, build_model, init_params,
                                      load_trained_model)
from deepclr_tpu_torch.models.pointnet2 import SORT_MIN_POINTS  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa, grouping  # noqa: E402
from deepclr_tpu_torch.synthetic import cad_train_batch, kitti_like, kitti_like_sequence, train_batch  # noqa: E402

pytestmark = pytest.mark.cuda

REPO = osp.realpath(osp.join(osp.dirname(__file__), ".."))
NPTS = 16384                  # the flagship's clouds
TRAIN_BATCH = 5               # the flagship's pairs a micro-step
SCAN_POINTS = 120_000         # a ray-cast HDL-64 scan; the KITTI converter keeps every 2nd point
SERVING_KERNELS = ("fps", "min_d2", "fused_sa")
TRAIN_KERNELS = ("fps", "min_d2", "fused_sa", "fused_sa_bwd", "fused_sa_bwd_finish", "gather_bwd_index", "gather_bwd")
FUSED_KERNELS = ("min_d2", "fused_sa", "fused_sa_argmax", "fused_sa_bwd")
BF16_TOL = 2e-2               # card against CPU, or one batching against another, at bf16 (the upload bound too)
QUIET = logging.getLogger(__name__)  # the progress lines of run_scenario and the ICP CLI: warnings only


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _flagship(**params):
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"].update(params)
    return cfg


def _modelnet40_model_cfg():
    with open(osp.join(REPO, "configs", "training", "modelnet40.yaml")) as f:
        return yaml.safe_load(f)["model"]


def _train_parts(model_cfg, device, seed=0):
    """Model, optimizer, schedule, loss and metrics of the flagship recipe."""
    model = build_model(model_cfg, device=device, seed=seed)
    metrics = KITTI_TRAIN_CFG["metrics"]
    return (model, solver.make_optimizer(KITTI_TRAIN_CFG, model.parameters()), solver.make_schedule(KITTI_TRAIN_CFG),
            make_loss_fn(metrics["loss"], model_cfg["label_type"]),
            make_metric_fns(metrics["loss"], metrics["other"], model_cfg["label_type"]))


def _ray_cast_frames(frames, seed, keep=NPTS):
    """``frames`` ray-cast HDL-64 scans along a drive, every 2nd point kept
    (as the KITTI converter keeps them), then ``keep`` of them drawn."""
    rng = np.random.default_rng(seed)
    out = []
    for _, scan in drive(rng, frames, SCAN_POINTS):
        kept = scan[::2]
        out.append(kept[rng.choice(len(kept), keep, replace=False)])
    return np.stack(out)


# --- serving and training at full width ----------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_the_flagship_serves_16_pairs_at_full_width(dev, fused):
    """predict_batch on 16 pairs of 16384-point clouds (bf16, seed-0
    weights): (16, 8) finite; the fused model launches the serving kernels
    and, through a sequential helper, gives finite poses for 3 frames; the
    exact model launches FPS and no fused kernel."""
    model = build_model(_flagship(fused=fused), device=dev, seed=0)
    templates, sources = kitti_like(16, NPTS, seed=1), kitti_like(16, NPTS, seed=2)
    ops.reset_launch_counts()
    y = ModelInferenceHelper(model, num_points=NPTS).predict_batch(list(sources), list(templates))
    counts = ops.launch_counts()
    assert y.shape == (16, 8) and np.isfinite(y).all()
    if not fused:
        assert counts["fps"] >= 1 and not any(counts[k] for k in FUSED_KERNELS), counts
        return
    assert all(counts[k] >= 1 for k in SERVING_KERNELS), counts
    helper = ModelInferenceHelper(model, is_sequential=True, num_points=NPTS)
    ops.reset_launch_counts()
    poses = [helper.predict(templates[i]) for i in range(3)]
    assert poses[0] is None and all(p.shape == (8,) and np.isfinite(p).all() for p in poses[1:])
    assert all(ops.launch_counts()[k] >= 1 for k in SERVING_KERNELS)


@pytest.mark.parametrize("fused,micro_steps", [(True, 4), (False, 2)])
def test_the_flagship_trains_at_full_width(dev, fused, micro_steps):
    """run_trainer with the flagship recipe (Ranger, trans + 200 rot,
    accumulation 2) on 5 pairs of 16384 points: before every update each
    gradient finite and each set-abstraction weight's non-zero, the loss
    finite; the fused model changes every parameter and launches every
    training kernel, the exact model launches FPS and no fused kernel."""
    model, opt, schedule, loss_fn, metric_fns = _train_parts(_flagship(fused=fused), dev)
    sa_weights = [n for n, _ in model.named_parameters() if n.startswith("_cloud_layers") and n.endswith("weight")]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []

    def inspect_grads(optimizer, args, kwargs):
        grads = {n: p.grad for n, p in model.named_parameters()}
        seen.append(([n for n, g in grads.items() if g is None or not torch.isfinite(g).all()],
                     [n for n in sa_weights if grads[n].abs().max().item() == 0.0]))

    cfg = copy.deepcopy(KITTI_TRAIN_CFG)
    cfg["optimizer"]["max_iterations"] = micro_steps
    cfg["logging"].update(log_period=1, checkpoint_period=10**9)
    batches = [train_batch(TRAIN_BATCH, NPTS, seed=20 + i) for i in range(micro_steps)]
    hook = opt.register_step_pre_hook(inspect_grads)
    ops.reset_launch_counts()
    try:
        state = run_trainer(cfg, model, batches, None, opt, schedule, loss_fn, metric_fns)
    finally:
        hook.remove()
    counts = ops.launch_counts()
    assert state.step == micro_steps and seen == [([], [])] * (micro_steps // 2), seen
    assert all(np.isfinite(v.item()) for v in state.metrics_ema.values())
    if fused:
        assert all(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
        assert all(counts[k] >= 1 for k in TRAIN_KERNELS), counts
    else:
        assert counts["fps"] >= 1 and not any(counts[k] for k in FUSED_KERNELS), counts


def test_a_micro_step_under_deterministic_algorithms_raises_nothing(dev, monkeypatch):
    """torch raises on any op of the path without a deterministic form (the
    hand-written kernels sum in fixed orders themselves): one flagship
    micro-step at 5 x 16384 under the mode, with the cuBLAS workspace
    setting it asks for, raises nothing and gives a finite loss."""
    model, opt, schedule, loss_fn, metric_fns = _train_parts(KITTI_MODEL_CFG, dev)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        metrics = make_train_step(model, opt, loss_fn, metric_fns)(
            create_train_state(model), train_batch(TRAIN_BATCH, NPTS, seed=21), schedule(4))
        loss = float(metrics["loss"])
    finally:
        torch.use_deterministic_algorithms(saved)
    assert np.isfinite(loss)


@pytest.mark.parametrize("fused", [True, False])
def test_float32_micro_step_gradients_on_card_match_cpu(dev, fused):
    """One float32 micro-step of the flagship on 2 pairs x 4096: every
    parameter's gradient on the card (kernels) within 2e-3 of its scale of
    the CPU's (plain twins)."""
    cfg = _flagship(fused=fused, compute_dtype="float32")
    batch = train_batch(2, 4096, seed=40)
    grads = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model, _, _, loss_fn, _ = _train_parts(cfg, device, seed=3)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        y_pred, _ = model(b["template"], b["source"], b["template_mask"], b["source_mask"])
        loss_fn(y_pred, b["y"]).backward()
        grads[where] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    for name, g in grads["cpu"].items():
        err = (grads["card"][name] - g).abs().max().item()
        assert err <= 2e-3 * max(1e-6, g.abs().max().item()), (name, err)


# --- the kernels at a training batch's density ---------------------------------------------------

def _sa_operands(model, points, mask):
    """The first set-abstraction stage's operands of the fused op, as
    SetAbstractionMSG.forward forms them: Morton sort, FPS, gather, centre
    sort (both sorts only from SORT_MIN_POINTS points), multi-scale bundle.
    Returns (prepared operands, centres)."""
    sa = model.cloud_features._sa0
    xyz = points[..., :3].contiguous()
    feats = points[..., 3:].contiguous() if points.shape[-1] > 3 else None
    sort = points.shape[1] >= SORT_MIN_POINTS
    if sort:
        xyz, feats, mask = ops.spatial_sort(xyz, feats, mask)
    centers = ops.gather_points(xyz, ops.furthest_point_sample(xyz, sa.npoint, mask))
    if sort:
        centers = ops.spatial_sort(centers)[0]
    weights, biases, radius = ops.multi_scale_bundle(
        [[m.dense(i).weight.detach().t() for i in range(m.depth)] for m in sa.mlps],
        [[m.dense(i).bias.detach() for i in range(m.depth)] for m in sa.mlps], sa.radii)
    op = fused_sa.prepare(xyz.contiguous(), centers.contiguous(), weights, biases, radius, feats, mask,
                          sa.compute_dtype)
    return op, centers


@pytest.mark.parametrize("recipe", ["kitti_ray_cast", "modelnet40"])
def test_kernels_on_a_training_batch_match_their_twins(dev, recipe):
    """B1-B4 on a training batch of the recipe (10 clouds: 6 ray-cast scans
    paired along a drive, or 5 CAD self-pairs of 2048 points): the culling
    bitmap equal to cull_bitmap of its min-d^2, B2 within 1e-5 of
    max(1, max|twin|), B4 fed B2's output within 1e-4 of each result's
    scale; MotionEmbedding's gather backward at the batch's own kNN index
    (skewed, where a uniform index is not) equal bit for bit to the CPU's
    sum and to itself, its run index equal to the CPU's."""
    if recipe == "modelnet40":
        model = build_model(_modelnet40_model_cfg(), device=dev, seed=0)
        batch = cad_train_batch(TRAIN_BATCH, 2048, seed=74)
        both = torch.from_numpy(np.concatenate([batch["template"], batch["source"]])).to(dev)
    else:
        model = build_model(KITTI_MODEL_CFG, device=dev, seed=0)
        pts = torch.from_numpy(_ray_cast_frames(TRAIN_BATCH + 1, seed=70)).to(dev)
        both = torch.cat([pts[:-1], pts[1:]])
    mask = torch.ones(both.shape[:2], dtype=torch.bool, device=dev)
    with torch.no_grad():
        op, centers = _sa_operands(model, both, mask)
        min_d2, active = fused_sa.block_min_d2_and_cull(op.pts4, op.centers, op.r2max)
        assert torch.equal(active, fused_sa.cull_bitmap(min_d2, op.r2max))
        out, ref = fused_sa.fused_sa_core(op, active), fused_sa._fused_sa_plain(op)
        assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(dev)
        got, want = fused_sa.fused_sa_bwd(op, active, out, g), fused_sa._fused_sa_bwd_plain(op, ref, g)
        for what, x, y in zip(["da", "dbc", "dw2", "dw3", "db2", "db3"], [got[0], got[1], *got[2], *got[3]],
                              [want[0], want[1], *want[2], *want[3]]):
            assert (x - y).abs().max().item() <= 1e-4 * max(1e-3, y.abs().max().item()), what

        half = centers.shape[0] // 2
        idx = ops.knn(centers[:half], centers[half:], model.merge.k)[0].reshape(half, -1).long().contiguous()
        n = centers.shape[1]
        cot = torch.randn(*idx.shape, model.merge.mlp.dense(0).weight.shape[0],
                          generator=torch.Generator().manual_seed(73)).to(dev)
        summed = ops.gather_points_grad(cot, idx, n)
        assert torch.equal(summed, ops.gather_points_grad(cot, idx, n))
        assert torch.equal(summed.cpu(), ops.gather_points_grad(cot.cpu(), idx.cpu(), n))
        perm, offsets = grouping.gather_bwd_index(idx, n)
        ref_perm, ref_offsets = grouping.gather_bwd_index(idx.cpu(), n)
        assert torch.equal(perm.cpu(), ref_perm) and torch.equal(offsets.cpu(), ref_offsets)


# --- scenario inference on frames of a scan's size -----------------------------------------------

SCENE_FRAMES = 8              # frames a sequence: 7 registrations
SCENE_PAIRS, PAIR_POINTS = 8, 12_000  # the pair pack: clouds below 16384 points, so padded


def _write_scene_packs(tmp):
    """Two KITTI-like sequences of 120000-point frames (every frame is
    subsampled) and one pack of pairs of 12000-point clouds (padded)."""
    frames = {}
    for k, seq in enumerate(("00", "01")):
        clouds, poses = kitti_like_sequence(SCENE_FRAMES, SCAN_POINTS, seed=60 + k)
        frames[seq] = clouds
        with PackWriter(osp.join(tmp, f"{seq}.pack")) as w:
            for i, (cloud, pose) in enumerate(zip(clouds, poses)):
                w.put(f"{i:06d}", {"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": cloud})
    clouds, poses = kitti_like_sequence(SCENE_PAIRS + 1, PAIR_POINTS, seed=62)
    with PackWriter(osp.join(tmp, "08.pack")) as w:
        for i in range(SCENE_PAIRS):
            w.put(f"{i:06d}", {"idx": [i, i + 1], "timestamps": [i * 1e5, (i + 1) * 1e5],
                               "clouds": [clouds[i], clouds[i + 1]],
                               "transform": np.linalg.inv(poses[i]) @ poses[i + 1]})
    return frames


def _assert_rows(ev, rows):
    """``rows`` registrations a sequence, every written value finite, and
    the step errors finite."""
    for name, n in rows.items():
        seq = ev.get_sequence(name)
        vals = np.array([[s, *p[:3].ravel(), *g[:3].ravel(), t] for s, p, g, t in
                         zip(seq.stamps, seq.prediction.transforms, seq.ground_truth.transforms, seq.times)])
        assert vals.shape == (n, 26) and np.isfinite(vals).all(), name
    total = ev.get_total_step_errors()
    errs = np.array([[x.translation.kitti, x.rotation.kitti, x.translation.rmse, x.rotation.chordal] for x in total])
    assert len(total) == sum(rows.values()) and np.isfinite(errs).all()


def _label_err(a, b):
    """The largest difference of the normalised dual-quaternion labels of
    two Evaluators' predicted transforms."""
    la, lb = ({name: label_from_matrix_np(LabelType.POSE3D_DUAL_QUAT, np.array(seq.prediction.transforms))
               for name, seq in ev.get_sequences().items()} for ev in (a, b))
    assert la.keys() == lb.keys() and all(la[k].shape == lb[k].shape for k in la)
    return max(float(np.abs(la[k] - lb[k]).max()) for k in la)


def test_scenarios_on_scan_sized_frames(dev, tmp_path):
    """inference.run_scenario with the flagship on packs of 120000-point
    frames: sequential at 1 and 2 lanes with float32 and uint16 uploads,
    pairwise one and 4 pairs a call; the rows finite, the serving kernels
    launched, uint16 within 2e-2 of float32 and 4 pairs a call within 2e-2
    of one (on the labels of the written transforms); a 2-lane
    BatchedSequentialHelper within 2e-2 of two helpers seeded as its lanes
    (cuBLAS picks its GEMM by the row count, so the lanes' float32 sums may
    run in another order before a bf16 rounding)."""
    frames = _write_scene_packs(str(tmp_path))
    model = build_model(KITTI_MODEL_CFG, device=dev, seed=0)
    seq_scen = scenario_from_dict({"name": "kitti_like_00-01", "dataset_type": "kitti_odometry_velodyne",
                                   "sequential": True, "data": {s: str(tmp_path / f"{s}.pack") for s in frames}})
    pair_scen = scenario_from_dict({"name": "kitti_like_pairs", "dataset_type": "generic", "sequential": False,
                                    "data": {"08": str(tmp_path / "08.pack")}})
    ops.reset_launch_counts()
    with torch.inference_mode():
        seq_runs = {(lanes, dt): inference.run_scenario(seq_scen, model, NPTS, dt, lanes, QUIET)
                    for lanes in (1, 2) for dt in ("float32", "uint16")}
        pair_runs = {b: inference.run_scenario(pair_scen, model, NPTS, "float32", b, QUIET) for b in (1, 4)}
    counts = ops.launch_counts()
    assert all(counts[k] >= 1 for k in SERVING_KERNELS), counts
    for ev in seq_runs.values():
        _assert_rows(ev, {s: SCENE_FRAMES - 1 for s in frames})
    for ev in pair_runs.values():
        _assert_rows(ev, {"08": SCENE_PAIRS})
    for lanes in (1, 2):
        assert _label_err(seq_runs[(lanes, "uint16")], seq_runs[(lanes, "float32")]) <= BF16_TOL
    assert _label_err(pair_runs[4], pair_runs[1]) <= BF16_TOL

    batched = BatchedSequentialHelper(model, batch=2, num_points=NPTS, seed=0)
    singles = [ModelInferenceHelper(model, is_sequential=True, num_points=NPTS, seed=i) for i in range(2)]
    with torch.inference_mode():
        for t in range(SCENE_FRAMES):
            pair = [frames["00"][t], frames["01"][t]]
            got = batched.step(pair)
            for lane, single in enumerate(singles):
                ref = single.predict(pair[lane])
                assert (got[lane] is None) == (ref is None) == (t == 0)
                if ref is not None:
                    np.testing.assert_allclose(got[lane], ref, atol=BF16_TOL, rtol=0)


# --- the ICP CLI on ray-cast scans ---------------------------------------------------------------

ICP_FRAMES = 6                # a drive cut in length only: 5 registrations of ~60000-point scans
ICP_MAX_ITERATIONS = 100      # the CLI's default
ICP_CUT_POINTS = 4096         # card against CPU on this cut of every pair
# card against CPU: the bound of test_icp_on_card_matches_cpu, 1e-4, except
# for po2po, whose update is a centroid: one correspondence that the two
# devices' last-bit differences move to a neighbour d away shifts it by
# d / 4096 (2.4e-4 at the 1 m gate), so it is held to four such flips
ICP_TOL = {"icp_po2po": 1e-3, "icp_po2pl": 1e-4, "gicp": 1e-4}


@pytest.fixture(scope="module")
def icp_pack(tmp_path_factory):
    """A KITTI sequence pack as the converter writes it: ray-cast HDL-64
    scans along a drive, every 2nd point kept."""
    path = str(tmp_path_factory.mktemp("icp") / "00.pack")
    erase = SystematicErasing(2)
    with PackWriter(path) as w:
        for i, (pose, scan) in enumerate(drive(np.random.default_rng(1100), ICP_FRAMES, SCAN_POINTS)):
            w.put(f"{i:08d}", erase({"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan}))
    return path


@pytest.mark.parametrize("algorithm", sorted(ICP_TOL))
def test_icp_cli_on_ray_cast_scans(dev, icp_pack, algorithm, tmp_path):
    """icp.cli.run (``python -m deepclr_tpu_torch.icp``) at --max-distance
    1.0 on the card: every transform finite and SE(3) within 1e-4, the
    iterations within the cap; on a seeded 4096-point cut of every pair the
    card within ICP_TOL of the CPU and the iterations within one, on every
    pair where both runs converged before the cap (at least one must: a
    capped run's last iterate carries every step's rounding)."""
    scen = scenario_from_dict({"name": "kitti_icp_synth", "dataset_type": "kitti_odometry_velodyne",
                               "sequential": True, "data": {"00": icp_pack}})
    infos = []
    run_dir = icp_cli.run(scen, algorithm, str(tmp_path), max_distance=1.0, device=dev, logger=QUIET, infos=infos)
    transforms = Evaluator.read(run_dir, ["00.txt"]).get_sequence("00").prediction.transforms
    assert len(transforms) == ICP_FRAMES - 1 and all(np.isfinite(m).all() for m in transforms)
    for m in transforms:
        assert max(np.abs(m[:3, :3] @ m[:3, :3].T - np.eye(3)).max(), np.abs(m[3] - [0, 0, 0, 1]).max()) <= 1e-4
    assert max(i["iterations"] for i in infos) <= ICP_MAX_ITERATIONS

    rng = np.random.default_rng(91)
    cut = [tuple(c[rng.choice(c.shape[0], ICP_CUT_POINTS, replace=False)] for c in (ds["clouds"][0][:, :3],
                                                                                  ds["clouds"][1][:, :3]))
           for ds in create_input_dataflow(scen.dataset_type, icp_pack, shuffle=False)]
    out = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        reg = ICPRegistration(algorithm, max_distance=1.0, device=device)
        out[where] = [reg.register(reg.prepare(t), reg.prepare(s), return_info=True) for t, s in cut]
    converged = 0
    for (m_card, i_card), (m_cpu, i_cpu) in zip(out["card"], out["cpu"]):
        if max(i_card["iterations"], i_cpu["iterations"]) < ICP_MAX_ITERATIONS:
            converged += 1
            np.testing.assert_allclose(m_card, m_cpu, atol=ICP_TOL[algorithm], rtol=0)
            assert abs(i_card["iterations"] - i_cpu["iterations"]) <= 1
    assert converged >= 1


# --- training from the shipped ModelNet40 YAML, and the demos ------------------------------------

def test_the_modelnet40_yaml_trains_and_its_run_directory_serves(dev, tmp_path, monkeypatch):
    """train(cfg) of the shipped modelnet40 recipe (extended, never
    written) for 2 micro-steps with a validation, on model stores of CAD
    clouds reduced to 2048 points by host FPS: every training kernel
    launches and the tags are finite; the run directory, loaded as a model
    directory, serves the validation pack through inference.run_scenario
    with the serving kernels and finite rows."""
    models = tmp_path / "modelnet40" / "models"
    models.mkdir(parents=True)

    def record(seed):
        return FarthestPointSampling(2048)({"idx": seed, "cloud": cad_cloud(np.random.default_rng(seed), 10_000)})

    with ThreadPoolExecutor(8) as pool:
        for name, seeds in (("train", range(10)), ("test_seen", range(100, 105))):
            with PackWriter(str(models / f"{name}.pack")) as w:
                for i, rec in enumerate(pool.map(record, seeds)):
                    w.put(f"{i:08d}", rec)
    monkeypatch.setenv("MODELNET40_PATH", str(tmp_path / "modelnet40"))
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "runs"))
    path = tmp_path / "train.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({"extends": osp.join(REPO, "configs", "training", "modelnet40.yaml"),
                        "optimizer": {"max_iterations": 2},
                        "logging": {"summary_period": 1, "log_period": 1, "checkpoint_period": 2,
                                    "validation_period": 2}}, f)
    cfg = load_config(str(path), Mode.NEW)
    ops.reset_launch_counts()
    state = trainer.train(cfg)
    counts = ops.launch_counts()
    assert state.step == 2 and all(counts[k] >= 1 for k in TRAIN_KERNELS), counts
    tags = {}
    with open(osp.join(cfg.output_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    for tag in ("train/loss", "params/lr", "val/loss_fn", "val/step_t_err"):
        assert tags.get(tag) and np.isfinite(tags[tag]).all(), (tag, tags.get(tag))

    weights = osp.join(cfg.output_dir, "weights.pt")
    scen = scenario_from_dict({"name": "synth_seen", "dataset_type": "modelnet40", "sequential": False,
                               "data": {"test_seen": str(models / "test_seen.pack")}})
    ops.reset_launch_counts()
    with torch.inference_mode():
        model = load_trained_model(load_model_config(osp.join(cfg.output_dir, "model_config.yaml"), weights), weights,
                                   device=dev)
        ev = inference.run_scenario(scen, model, 2048, logger=QUIET)
    assert all(ops.launch_counts()[k] >= 1 for k in SERVING_KERNELS)
    _assert_rows(ev, {"test_seen": 5})


def _run_main(module, argv, monkeypatch, env):
    """``python -m module argv`` in this process: its main() with sys.argv
    and the environment set for the call."""
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [module, *argv])
        for k, v in env.items():
            mp.setenv(k, v)
        importlib.import_module(module).main()


@pytest.mark.parametrize("demo", ["kitti", "modelnet40"])
def test_the_demos_run_on_the_card(dev, demo, tmp_path, monkeypatch, capsys):
    """The inference demo on raw data written by the synthetic-data CLI,
    with a model directory of seed-0 weights: a finite translation error
    for each registration (5 frames after the first of sequence 04; 3
    ModelNet40 test models), the serving kernels launched and no backward."""
    model_dir = tmp_path / "models" / "seed0"
    model_dir.mkdir(parents=True)
    with open(model_dir / "model_config.yaml", "w") as f:
        yaml.safe_dump(KITTI_MODEL_CFG if demo == "kitti" else _modelnet40_model_cfg(), f)
    data = str(tmp_path / "data")
    if demo == "kitti":
        _run_main("deepclr_tpu_torch.make_synthetic_kitti", [data, "--sequences", "04", "--frames", "7",
                                                             "--points", "32768"], monkeypatch, {})
        env, argv, want = {"KITTI_PATH": data}, ["--sequence", "04", "--num_frames", "6"], 5
    else:
        _run_main("deepclr_tpu_torch.make_synthetic_modelnet", [data, "--train-per-shape", "1",
                                                                "--test-per-shape", "1", "--points", "2100"],
                  monkeypatch, {})
        env, argv, want = {"MODELNET40_PATH": data}, ["--num_samples", "3"], 3
    capsys.readouterr()
    ops.reset_launch_counts()
    _run_main(f"deepclr_tpu_torch.examples.{demo}_inference", ["seed0", *argv], monkeypatch,
              dict(env, MODEL_PATH=str(tmp_path / "models")))
    counts = ops.launch_counts()
    errs = [float(line.split("translation error ")[1].split()[0]) for line in capsys.readouterr().out.splitlines()
            if "translation error" in line]
    assert len(errs) == want and np.isfinite(errs).all(), errs
    assert all(counts[k] >= 1 for k in SERVING_KERNELS) and not counts["fused_sa_bwd"], counts


# --- data-parallel training from kitti_base.yaml -------------------------------------------------

DP_MICRO_STEPS = 4            # each run: 2 updates of accumulation 2
DP_LR = 1e-5                  # a constant lr (see _dp_yaml)
DP_LOSS_RTOL, DP_LOSS_ATOL = 5e-3, 1e-5  # the bound of tests/test_torch_parallel.py: the ranks sum in another order
DP_VAL_TOL = 1e-5             # validation scalars, the ranks against one process (relative)
DP_WEIGHT_TOL = 1e-5          # final weights, the ranks' against one process's (_weights_rel_err)
DP_RANK_TIMEOUT_S = 600
# One rank: under DEEPCLR_COORDINATOR it joins the group over gloo itself
# (NCCL refuses two ranks on one card); under torchrun main() joins it from
# the environment, over NCCL.  Writes the train step's wrapper and the
# launches to OUT_DIR/rank<r>.json.
RANK_SCRIPT = """
import json, os, os.path as osp, sys
from deepclr_tpu_torch import ops, parallel, training
from deepclr_tpu_torch.engine import trainer

rank = int(os.environ.get("DEEPCLR_PROCESS_ID", os.environ.get("RANK", "0")))
if "DEEPCLR_COORDINATOR" in os.environ:
    parallel.initialize(os.environ["DEEPCLR_COORDINATOR"], int(os.environ["DEEPCLR_NUM_PROCESSES"]), rank, [0],
                        backend="gloo")
wrappers, make = [], trainer.make_train_step


def recording(model, *args, **kwargs):
    wrappers.append(type(model).__name__)
    return make(model, *args, **kwargs)


trainer.make_train_step = recording
training.main([sys.argv[1]])
with open(osp.join(sys.argv[2], f"rank{rank}.json"), "w") as f:
    json.dump({"rank": rank, "wrappers": wrappers, "launches": ops.launch_counts()}, f)
"""


@pytest.fixture(scope="module")
def dp_packs(tmp_path_factory):
    """A function of the rank count: a training and a validation KITTI
    sequence of ray-cast HDL-64 scans for that many ranks of 5 pairs (4
    micro-steps, and one global batch of validation), each scan subsampled
    once to 16384 points as it is written, so the loader neither
    subsamples nor pads (its draws would depend on the sharding)."""
    made = {}

    def packs(ranks):
        if ranks not in made:
            tmp = tmp_path_factory.mktemp(f"dp{ranks}")
            frames = {"train": ranks * TRAIN_BATCH * DP_MICRO_STEPS + 1, "val": ranks * TRAIN_BATCH + 1}

            def sequence(k, name):
                pick = np.random.default_rng(3000 + k)
                with PackWriter(str(tmp / f"{name}.pack")) as w:
                    for i, (pose, scan) in enumerate(drive(np.random.default_rng(2000 + k), frames[name],
                                                           SCAN_POINTS)):
                        keep = np.sort(pick.choice(len(scan), NPTS, replace=False))
                        w.put(f"{i:08d}", {"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan[keep]})

            with ThreadPoolExecutor(2) as pool:
                for f in [pool.submit(sequence, k, name) for k, name in enumerate(frames)]:
                    f.result()
            made[ranks] = tmp
        return made[ranks]

    return packs


def _dp_yaml(tmp, packs, name, batch_size, lr=DP_LR):
    """A YAML that extends the shipped kitti_base.yaml (no augmentation)
    with the packs, float32, DP_MICRO_STEPS micro-steps, a constant lr in
    place of the schedule (whose 1e-7 start would leave two updates too
    small to show an error in the gradients; from 1e-4 up the flagship's
    loss climbs after the first update, and ranks that sum the global batch
    in another order no longer agree with one process within the
    validation bound), no loader workers (their order is not fixed) and one
    validation, after the final checkpoint."""
    path = osp.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"extends": osp.join(REPO, "configs", "training", "kitti_base.yaml"),
                        "base_dir": osp.join(tmp, name), "identifier": name,
                        "data": {"training": str(packs / "train.pack"), "validation": str(packs / "val.pack"),
                                 "dataset_type": "kitti_odometry_velodyne", "sequential": True},
                        "data_loader": {"batch_size": batch_size, "num_workers": 0, "buffer_size": 0},
                        "model": {"params": {"compute_dtype": "float32"}},
                        "optimizer": {"max_iterations": DP_MICRO_STEPS, "base_lr": lr},
                        "scheduler": {"name": None, "params": {}, "on_iteration": False},
                        "logging": {"summary_period": 1, "log_period": 1, "checkpoint_period": 10**6,
                                    "validation_period": 10**6}}, f)
    return path


def _read_run(base_dir):
    """The one run directory under base_dir (only rank 0 writes): its
    scalars ({tag: values in step order}) and final weights."""
    runs = [d for d in sorted(os.listdir(base_dir)) if os.listdir(osp.join(base_dir, d))]
    assert len(runs) == 1, runs
    tags = {}
    with open(osp.join(base_dir, runs[0], "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    weights = torch.load(osp.join(base_dir, runs[0], f"weights_final_{DP_MICRO_STEPS}.pt"), map_location="cpu",
                         weights_only=True)
    return {t: [v for _, v in sorted(vals)] for t, vals in tags.items()}, weights


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_in_process(path, monkeypatch, nccl=False):
    """train(cfg) of one YAML in this process, without a group or in a
    one-rank NCCL group.  Returns the train step's wrappers, each train
    step's launches, the scalars and the final weights."""
    wrappers, step_launches = [], []
    make = trainer.make_train_step

    def recording(model, *args, **kwargs):
        wrappers.append(type(model).__name__)
        step = make(model, *args, **kwargs)

        def call(*a, **k):
            before = ops.launch_counts()
            out = step(*a, **k)
            step_launches.append({n: c - before[n] for n, c in ops.launch_counts().items()})
            return out
        return call

    cfg = load_config(path, Mode.NEW)
    if nccl:
        torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                                             rank=0, timeout=parallel.distributed.TIMEOUT)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(trainer, "make_train_step", recording)
            state = trainer.train(cfg)
    finally:
        parallel.shutdown()
    assert state.step == DP_MICRO_STEPS
    return (wrappers, step_launches, *_read_run(cfg.base_dir))


def _rel_err(a, b):
    """max |a - b| / max |b|; NaN where both are NaN counts as equal, NaN
    on one side only as infinite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    a, b = a[~np.isnan(b)], b[~np.isnan(b)]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) if b.size else 0.0


def _weights_rel_err(a, b):
    """The largest |a - b| of any weight over the largest |b| of any weight:
    one scale for the whole model (a bias that starts at zero has only its
    update's scale, and a neighbour that wins a max in one run and not in
    another moves that update far more than 1e-5 of it)."""
    assert sorted(a) == sorted(b)
    keys = [k for k, v in b.items() if v.is_floating_point()]
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
    return diff / max(max(float(b[k].abs().max()) for k in keys), 1e-30)


def test_two_runs_without_a_group_are_bit_equal(dev, dp_packs, tmp_path, monkeypatch):
    """Two train(cfg) runs of one recipe without a group at lr 1e-3 (where
    float atomics once showed): the same losses and weights, bit for bit."""
    packs = dp_packs(2)
    (_, _, sa, wa), (_, _, sb, wb) = (_train_in_process(_dp_yaml(str(tmp_path), packs, f"run{i}", TRAIN_BATCH,
                                                                 lr=1e-3), monkeypatch) for i in range(2))
    assert len(sa["train/loss_fn"]) == DP_MICRO_STEPS and sa["train/loss_fn"] == sb["train/loss_fn"]
    assert sorted(wa) == sorted(wb) and all(torch.equal(wa[k], wb[k]) for k in wb)


def test_a_one_rank_nccl_group_trains_bit_equal_to_no_group(dev, dp_packs, tmp_path, monkeypatch):
    """train(cfg) in a one-rank NCCL group (DistributedDataParallel, the
    kernels) against train(cfg) without one: each micro-step launches what
    the plain one launches, every training kernel among them; the loss
    trajectory and the final weights equal bit for bit."""
    packs = dp_packs(2)
    plain = _train_in_process(_dp_yaml(str(tmp_path), packs, "plain", TRAIN_BATCH), monkeypatch)
    group = _train_in_process(_dp_yaml(str(tmp_path), packs, "nccl1", TRAIN_BATCH), monkeypatch, nccl=True)
    assert set(plain[0]) == {"DeepCLR"} and set(group[0]) == {"DistributedDataParallel"}
    assert group[1] == plain[1] and len(group[1]) == DP_MICRO_STEPS
    assert all(sum(s[k] for s in group[1]) >= 1 for k in TRAIN_KERNELS), group[1]
    assert len(group[2]["train/loss_fn"]) == DP_MICRO_STEPS and group[2]["train/loss_fn"] == plain[2]["train/loss_fn"]
    assert sorted(group[3]) == sorted(plain[3]) and all(torch.equal(group[3][k], v) for k, v in plain[3].items())


def _wait_ranks(procs, out_dir, ranks):
    """Wait for the rank processes (all killed if one fails or the wait
    outlasts DP_RANK_TIMEOUT_S); their rank<r>.json."""
    logs = []
    try:
        deadline = time.monotonic() + DP_RANK_TIMEOUT_S
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, logs[r][-3000:] if r < len(logs) else "") for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    results = []
    for r in range(ranks):
        with open(osp.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _assert_ranks_match_the_global_batch(base_dir, ref, ranks):
    """The ranks' run against one process of the global batch: the loss
    trajectory within DP_LOSS_RTOL / DP_LOSS_ATOL, every validation scalar
    within DP_VAL_TOL of its scale, the final weights within DP_WEIGHT_TOL
    (ranks that kept their own gradients fail here and in validation); the
    train step run by DistributedDataParallel and every training kernel
    launched on every rank."""
    scalars, weights = _read_run(base_dir)
    ref_scalars, ref_weights = ref[2], ref[3]
    np.testing.assert_allclose(scalars["train/loss_fn"], ref_scalars["train/loss_fn"], rtol=DP_LOSS_RTOL,
                               atol=DP_LOSS_ATOL)
    val_tags = sorted(t for t in ref_scalars if t.startswith("val/"))
    assert "val/step_t_err" in val_tags and all(t in scalars for t in val_tags)
    val_err = {t: _rel_err(scalars[t], ref_scalars[t]) for t in val_tags}
    assert max(val_err.values()) <= DP_VAL_TOL, val_err
    assert _weights_rel_err(weights, ref_weights) <= DP_WEIGHT_TOL
    for r in ranks:
        assert set(r["wrappers"]) == {"DistributedDataParallel"}, r
        assert all(r["launches"][k] >= 1 for k in TRAIN_KERNELS), r


def _rank_env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in ("DEEPCLR_COORDINATOR", "DEEPCLR_DISTRIBUTED", "DEEPCLR_LOCAL_DEVICE_IDS", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    env.update(extra)
    return env


def test_two_gloo_ranks_on_one_card_match_one_process_of_the_global_batch(dev, dp_packs, tmp_path, monkeypatch):
    """Two processes of the training CLI on the one card, started with the
    DEEPCLR_COORDINATOR contract and joined over gloo, 5 pairs each,
    against one process of batch 10."""
    packs = dp_packs(2)
    ref = _train_in_process(_dp_yaml(str(tmp_path), packs, "global", 2 * TRAIN_BATCH), monkeypatch)
    script, path = tmp_path / "rank.py", _dp_yaml(str(tmp_path), packs, "gloo", TRAIN_BATCH)
    script.write_text(RANK_SCRIPT)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), path, str(tmp_path)], cwd=REPO, text=True,
                              env=_rank_env(DEEPCLR_COORDINATOR=f"127.0.0.1:{port}", DEEPCLR_NUM_PROCESSES="2",
                                            DEEPCLR_PROCESS_ID=str(r), DEEPCLR_LOCAL_DEVICE_IDS="0"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    _assert_ranks_match_the_global_batch(str(tmp_path / "gloo"), ref, _wait_ranks(procs, str(tmp_path), 2))


@pytest.mark.slow  # ~110 s on four H100s: the packs, the global batch's run and torchrun's start-up
def test_nccl_ranks_across_cards_match_one_process_of_the_global_batch(dev, dp_packs, tmp_path, monkeypatch):
    """One rank a card, started by torchrun with DEEPCLR_DISTRIBUTED=1 (the
    launch README.md gives; NCCL), 5 pairs each, against one process of the
    global batch on card 0."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    packs = dp_packs(n)
    ref = _train_in_process(_dp_yaml(str(tmp_path), packs, "global", n * TRAIN_BATCH), monkeypatch)
    script, path = tmp_path / "rank.py", _dp_yaml(str(tmp_path), packs, "cards", TRAIN_BATCH)
    script.write_text(RANK_SCRIPT)
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={n}",
                             f"--master_port={_free_port()}", str(script), path, str(tmp_path)], cwd=REPO, text=True,
                            env=_rank_env(DEEPCLR_DISTRIBUTED="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    _assert_ranks_match_the_global_batch(str(tmp_path / "cards"), ref, _wait_ranks([proc], str(tmp_path), n))


# --- the model's variants against the CPU ---------------------------------------------------------

VARIANT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
VARIANTS = ("motion_embedding_k0", "motion_embedding_append_features_false", "motion_embedding_batch_norm",
            "output_simple_batch_norm", "feature_propagation_batch_norm")


def _variant(name, dtype):
    """A small seeded instance of the variant module and its inputs, its
    running statistics (if any) those of a training forward on them."""
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(90 + VARIANTS.index(name))

    def feats():
        return torch.from_numpy(np.concatenate([rng.normal(size=(2, 256, 3)) * 5.0, rng.normal(size=(2, 256, 64))],
                                               -1).astype(np.float32))

    def grid(b, p):
        # coordinates on a 1/64 grid, so every distance is exact on both
        # devices: the expanded form (JAX's) cancels ~1e-7 of |x|^2, which
        # moves the weights of close neighbours by ~4e-5 at unit scale
        return torch.from_numpy((np.round(rng.normal(size=(b, p, 3)) * 64) / 64).astype(np.float32))

    me = dict(feat_dim=64, mlp=[128, 128, 256], compute_dtype=cd)
    if name == "motion_embedding_k0":
        module, inputs = MotionEmbedding(k=0, radius=10.0, **me), (feats(), feats())
    elif name == "motion_embedding_append_features_false":
        module, inputs = MotionEmbedding(k=20, append_features=False, **me), (feats(), feats())
    elif name == "motion_embedding_batch_norm":
        module, inputs = MotionEmbedding(k=20, batch_norm=True, **me), (feats(), feats())
    elif name == "output_simple_batch_norm":
        # 16 clouds, each its own offset and spread: the head's linear
        # layers normalise over the batch alone, and pooled features of iid
        # clouds differ so little across it that E[x^2] - E[x]^2 cancels
        x = rng.normal(size=(16, 1, 259)) * 2.0 + rng.normal(size=(16, 256, 259)) * rng.uniform(0.5, 2.0, (16, 1, 1))
        module = OutputSimple(259, [256, 512, 1024], [1024, 512, 256], LabelType.POSE3D_DUAL_QUAT, batch_norm=True,
                              compute_dtype=cd)
        inputs = (torch.from_numpy(x.astype(np.float32)),)
    else:
        mask = torch.ones(2, 256, dtype=torch.bool)
        mask[1, 200:] = False
        module = FeaturePropagation(68, [64, 32], batch_norm=True, compute_dtype=cd)
        inputs = (grid(2, 1024), grid(2, 256), torch.from_numpy(rng.normal(size=(2, 1024, 4)).astype(np.float32)),
                  torch.from_numpy(rng.normal(size=(2, 256, 64)).astype(np.float32)), mask)
    init_params(module, 100 + VARIANTS.index(name))
    with torch.no_grad():  # running statistics of a batch, so evaluation mode normalises too
        module.train()(*inputs)
    return module.eval(), inputs


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", sorted(VARIANT_TOL))
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_modules_on_card_match_cpu(dev, name, dtype, train):
    """Each variant module in evaluation or training mode: its output and
    running statistics on the card within 1e-5 (float32) or 2e-2 (bf16) of
    max(1, max|CPU|)."""
    module, inputs = _variant(name, dtype)
    results = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        m = copy.deepcopy(module).to(device).train(train)
        with torch.no_grad():
            y = m(*[x.to(device) for x in inputs]).float().cpu()
        results[where] = (y, {k: v.cpu() for k, v in m.state_dict().items() if "running" in k})
    (y_card, stats_card), (y_cpu, stats_cpu) = results["card"], results["cpu"]
    tol = VARIANT_TOL[dtype]
    assert (y_card - y_cpu).abs().max().item() <= tol * max(1.0, y_cpu.abs().max().item())
    assert stats_card.keys() == stats_cpu.keys()
    for k, v in stats_cpu.items():
        assert (stats_card[k] - v).abs().max().item() <= tol * max(1.0, v.abs().max().item()), k


def test_the_exact_model_on_differently_sized_clouds_matches_cpu(dev):
    """DeepCLR.forward of the exact flagship (bf16) on 16384-point
    templates and 12000-point sources: the card within 2e-2 of the CPU."""
    t, s = torch.from_numpy(kitti_like(2, NPTS, seed=91)), torch.from_numpy(kitti_like(2, 12000, seed=92))
    ys = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(_flagship(fused=False), device=device, seed=4)
        with torch.no_grad():
            ys[where] = model(t.to(device), s.to(device))[0].float().cpu()
    assert (ys["card"] - ys["cpu"]).abs().max().item() <= BF16_TOL
