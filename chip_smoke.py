#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (deepclr_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repository root, on an NVIDIA H100

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles every kernel in deepclr_tpu_torch/csrc, in parallel;
3. kernels vs plain: each CUDA kernel against its plain PyTorch twin on the
   card at full width (4 clouds x 16384 points -> 1024 centres, one cloud
   with a masked tail, one all masked), in float32 and bfloat16: FPS indices
   equal (also at the rule's cluster size for 1, 10 and 32 clouds, and at
   every cluster size 1-16 on a grid-tie cloud with a masked tail and an
   all-masked cloud), min-d^2 values equal (alone and from the launch that
   also writes the culling bitmap), that bitmap equal to cull_bitmap of the
   min-d^2 wherever a bitmap is made (every case below, phase 6's too),
   fused set abstraction within 1e-5 of
   max(1, max|plain|) (the twin rounds where the kernel rounds); the argmax
   forward's values equal the forward kernel's bit for bit and its indices
   equal the twin's; the backward kernel, fed the forward kernel's output
   (so its recompute must select that kernel's winners),
   within 1e-4 of each result's scale of the twin fed the plain forward's
   (the kernel sums with atomics, in a varying order), on these clouds and
   on a dense-ball case (4096 points in a 4 m cube, ~33 points a 0.5 m
   ball);
4. serving path: the flagship KITTI model (random weights from seed 0)
   through ModelInferenceHelper.predict_batch on 16 pairs of 16384-point
   KITTI-like clouds, and 3 sequential frames through encode_register;
   outputs finite and (., 8); every forward kernel's launch count > 0 on
   each run; the card's prediction on 2 small pairs within 2e-2 of the same
   model on the CPU;
5. train path (outside inference mode, a model of its own): run_trainer
   with the flagship recipe (KITTI_TRAIN_CFG: Ranger, trans + 200 rot,
   accumulation 2) for 4 micro-steps (2 optimizer updates) on 5 pairs of
   16384-point clouds whose sources are random small rigid motions of the
   templates; before each update every gradient is finite and every
   set-abstraction weight's gradient non-zero; the loss is finite, the
   parameters changed, and fps, min_d2, fused_sa and fused_sa_bwd launched;
   one micro-step with the argmax backward launches fused_sa_argmax; one
   float32 micro-step on 2 pairs x 4096 gives the CPU's gradients within
   2e-3 of each gradient's scale;
6. timing with CUDA events (medians after warm-up): forward pairs/s at
   16 x 16384, encode and register time, one sequential step (B = 1), the
   train micro-step and train pairs/s at 5 x 16384, and each kernel's time
   (back-to-back launches), its plain twin's time and its bound at its
   path's shapes, and its device time alone (device_ms: the calls queued
   behind a sleep kernel); FPS also at 1 and 10 clouds and at cluster size 1, and
   B4 (and B2) on the dense case beside the sparse one; min-d^2 also
   without the bitmap, and with a second bound at the float32 issue rate;
   the counts the fused forward's design rests on (kept chunks a tile,
   in-radius pairs a kept (chunk, tile) block).

Prints JSON lines; the one before the last two lists the kernels, then the
card's name and power limit, and the last is {"ok": true, "device": {...}}.
Imports nothing of jax or deepclr_tpu.
"""
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, NPTS = 16, 16384       # the flagship serving workload: 16 pairs of 16384 points
TRAIN_BATCH = 5               # the flagship training batch: 5 pairs of 16384 points
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores (a fused multiply-add counts two)
F32_ISSUE_PER_S = 33.5e12     # float32 instructions: 132 SMs x 128 lanes x 1.98 GHz
BF16_OPS_PER_S = 989e12       # dense bf16 tensor cores
FUSED_SA_PALLAS = "deepclr_tpu/ops/pallas/fused_sa_kernel.py"
TPU_KERNELS = {
    "fps": ("deepclr_tpu_torch/csrc/fps.cu", "deepclr_tpu/ops/pallas/fps_kernel.py:93"),
    "min_d2": ("deepclr_tpu_torch/csrc/min_d2.cu", f"{FUSED_SA_PALLAS}:119"),
    "fused_sa": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:441"),
    "fused_sa_argmax": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:441"),
    "fused_sa_bwd": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:787"),
}
SERVING_KERNELS = ("fps", "min_d2", "fused_sa")
TRAIN_KERNELS = ("fps", "min_d2", "fused_sa", "fused_sa_bwd")
FPS_BATCHES = (32, 10, 1)     # FPS's path shapes: serving encode (2B), train encode (2B), sequential step


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Median time of fn() in ms, one pair of CUDA events per call, after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps):
    """A kernel's time in ms: one pair of CUDA events around ``reps``
    back-to-back calls after a warm-up call, over ``reps``, so the host's
    preparation of a call overlaps the device's work on the one before."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """A kernel's device time in ms: ``reps`` calls queued behind a sleep
    kernel that outlasts their host work, so they run back to back on the
    card and the events see no host gap.  (kernel_ms is bound by the
    wrapper's host work when that is longer than the kernel.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * enqueue_s + 1e-3) * 2e9))  # cycles at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sa_operands(model, points, mask):
    """The first set-abstraction stage's steps up to the fused op, as
    SetAbstractionMSG.forward takes them: Morton sort, FPS, gather, centre
    sort, multi-scale bundle."""
    from deepclr_tpu_torch import ops

    sa = model.cloud_features._sa0
    xyz, feats, mask = ops.spatial_sort(points[..., :3].contiguous(), points[..., 3:], mask)
    idx = ops.furthest_point_sample(xyz, sa.npoint, mask)
    centers = ops.spatial_sort(ops.gather_points(xyz, idx))[0]
    weights, biases, radius = ops.multi_scale_bundle(
        [[m.dense(i).weight.t() for i in range(m.depth)] for m in sa.mlps],
        [[m.dense(i).bias for i in range(m.depth)] for m in sa.mlps], sa.radii)
    return dict(xyz=xyz.contiguous(), feats=feats.contiguous(), mask=mask, npoint=sa.npoint,
                centers=centers.contiguous(), weights=weights, biases=biases, radius=radius)


def dense_clouds(b, n=4096, side=4.0, seed=50):
    """Points uniform in a cube of ``side`` m (xyz + intensity): 4096 in 4 m
    put ~33 points in a 0.5 m ball and ~270 in a 1 m ball."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, side, size=(b, n, 3)), rng.uniform(size=(b, n, 1))],
                          -1).astype(np.float32)


def fused_operands(op, dtype):
    """Prepared fused-SA operands and their culling bitmap, from the
    pre-pass launch that writes both; raises unless that bitmap equals
    cull_bitmap of its min-d^2."""
    from deepclr_tpu_torch.ops import fused_sa

    sa_op = fused_sa.prepare(op["xyz"], op["centers"], op["weights"], op["biases"], op["radius"],
                             op["feats"], op["mask"], dtype)
    min_d2, active = fused_sa.block_min_d2_and_cull(sa_op.pts4, sa_op.centers, sa_op.r2max)
    ref = fused_sa.cull_bitmap(min_d2, sa_op.r2max)
    if not torch.equal(active, ref):
        raise AssertionError(f"min_d2 bitmap: {(active != ref).sum().item()} bytes differ from cull_bitmap")
    return sa_op, active


def culling_counts(sa_op, active, pairs):
    """Kept (chunk, tile) blocks a tile (mean, max) and in-radius pairs a
    kept block: the counts the fused forward's schedule rests on."""
    kept = active.sum(dim=1, dtype=torch.int64)  # (B, tiles)
    return {"kept_chunks_per_tile_mean": kept.float().mean().item(),
            "kept_chunks_per_tile_max": int(kept.max()), "chunks": active.shape[1],
            "in_radius_pairs_per_kept_block": pairs / max(1, int(kept.sum()))}


def check_kernels(model, dev):
    """Phase 3: each kernel against its plain twin on the card."""
    from deepclr_tpu_torch.ops import fps, fused_sa
    from deepclr_tpu_torch.synthetic import kitti_like

    pts = torch.from_numpy(kitti_like(4, NPTS, seed=3)).to(dev)
    mask = torch.ones(4, NPTS, dtype=torch.bool, device=dev)
    mask[1, NPTS * 3 // 4:] = False   # a masked tail
    mask[3] = False                   # an all-masked cloud
    op = sa_operands(model, pts, mask)
    errs = {}

    got = fps.furthest_point_sample(op["xyz"], op["npoint"], op["mask"])
    ref = fps._fps_plain(op["xyz"], op["npoint"], op["mask"])
    if not torch.equal(got, ref):
        raise AssertionError(f"fps: {(got != ref).sum().item()} indices differ from the plain version")
    check_fps(dev)
    errs["fps"] = 0.0

    pts4 = fused_sa._pack_points(op["xyz"], op["mask"])
    ref = fused_sa._block_min_d2_plain(pts4, op["centers"])
    for got in (fused_sa.block_min_d2(pts4, op["centers"]),
                fused_sa.block_min_d2_and_cull(pts4, op["centers"], 1.0)[0]):
        if not torch.equal(got, ref):
            raise AssertionError(f"min_d2: max |diff| {(got - ref).abs().max().item()} vs the plain version")
    errs["min_d2"] = 0.0

    g = torch.randn(4, op["npoint"], 64, generator=torch.Generator().manual_seed(4)).to(dev)
    # the path's dtype, bfloat16, is checked last, so errs keeps its errors
    for dtype in (torch.float32, torch.bfloat16):
        sa_op, active = fused_operands(op, dtype)
        # The twin rounds to the compute dtype where the kernel does, so both
        # agree to float32 summation order; a kernel that skipped a bfloat16
        # rounding would be off by ~2^-9 of the scale.
        out = fused_sa.fused_sa_core(sa_op, active)
        ref = fused_sa._fused_sa_plain(sa_op)
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        emit({"check": "fused_sa", "dtype": str(dtype), "max_abs_err": err, "max_abs_ref": scale,
              "tolerance": 1e-5 * scale, "visited_blocks": active.float().mean().item()})
        if not err <= 1e-5 * scale or out[3].abs().max().item() != 0.0:
            raise AssertionError(f"fused_sa {dtype}: max |diff| {err} > {1e-5 * scale} or a non-empty "
                                 "ball in the all-masked cloud")
        errs["fused_sa"] = err

        # B5: the same values bit for bit, the twin's tie rule (lowest index)
        out_a, jstar = fused_sa.fused_sa_argmax(sa_op, active)
        ref_a, ref_j = fused_sa._fused_sa_argmax_plain(sa_op)
        j_diff = int((jstar != ref_j).sum())
        emit({"check": "fused_sa_argmax", "dtype": str(dtype), "values_equal_forward_kernel":
              bool(torch.equal(out_a, out)), "index_mismatches": j_diff,
              "empty_balls": int((jstar == -1).sum()), "max_abs_err_vs_plain": (out_a - ref_a).abs().max().item()})
        if not torch.equal(out_a, out) or j_diff or not (jstar[3] == -1).all():
            raise AssertionError(f"fused_sa_argmax {dtype}: values differ from the forward kernel or "
                                 f"{j_diff} indices differ from the plain version")
        errs["fused_sa_argmax"] = (out_a - ref_a).abs().max().item()

        # B4: fed B2's output, so its equality select must find B2's
        # winners; the twin is fed the plain forward's
        got = fused_sa.fused_sa_bwd(sa_op, active, out, g)
        ref = fused_sa._fused_sa_bwd_plain(sa_op, fused_sa._fused_sa_plain(sa_op), g)
        worst = 0.0
        for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), [got[0], got[1], *got[2], *got[3]],
                              [ref[0], ref[1], *ref[2], *ref[3]]):
            scale = max(1e-3, y.abs().max().item())
            err = (x - y).abs().max().item()
            worst = max(worst, err)
            emit({"check": "fused_sa_bwd", "dtype": str(dtype), "result": name, "max_abs_err": err,
                  "scale": scale, "tolerance": 1e-4 * scale, "fed": "fused_sa kernel output"})
            if not err <= 1e-4 * scale:
                raise AssertionError(f"fused_sa_bwd {dtype} {name}: max |diff| {err} > 1e-4 of the scale {scale}")
        if got[2][1].abs().max().item() == 0.0 or got[0][3].any() or got[1][3].any():
            raise AssertionError(f"fused_sa_bwd {dtype}: no winner selected, or a gradient in the all-masked cloud")
        errs["fused_sa_bwd"] = max(worst, check_bwd_dense(model, dev, dtype))
    return errs


def check_fps(dev):
    """FPS indices equal the plain version's at the rule's cluster size for
    the path's batches, and at every cluster size on a grid-tie cloud (equal
    distances everywhere) with a masked tail and an all-masked cloud."""
    from deepclr_tpu_torch.ops import fps
    from deepclr_tpu_torch.synthetic import kitti_like

    chosen = {}
    for b in FPS_BATCHES:
        xyz = torch.from_numpy(kitti_like(b, NPTS, seed=30 + b)[..., :3].copy()).to(dev)
        mask = torch.ones(b, NPTS, dtype=torch.bool, device=dev)
        if b > 1:
            mask[-1, NPTS // 2:] = False  # a masked tail in the batch's last cloud
        chosen[b] = fps.device_cluster_size(dev, b, NPTS)
        got, ref = fps.furthest_point_sample(xyz, 1024, mask), fps._fps_plain(xyz, 1024, mask)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps at B={b}, cluster {chosen[b]}: {(got != ref).sum().item()} indices differ")
    xyz = torch.from_numpy(np.round(kitti_like(3, NPTS, seed=40)[..., :3] / 4)).to(dev)
    mask = torch.ones(3, NPTS, dtype=torch.bool, device=dev)
    mask[0, NPTS * 5 // 8:] = False
    mask[2] = False
    ref = fps._fps_plain(xyz, 1024, mask)
    for c in fps.CLUSTER_SIZES:
        got = fps.furthest_point_sample(xyz, 1024, mask, cluster=c)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps at cluster {c} on the grid-tie clouds: {(got != ref).sum().item()} differ")
    emit({"check": "fps", "points": NPTS, "npoint": 1024, "cluster_by_batch": chosen,
          "grid_tie_clusters_equal": list(fps.CLUSTER_SIZES)})


def check_bwd_dense(model, dev, dtype):
    """B4 on the dense-ball case (4 clouds x 4096 points in a 4 m cube, the
    model's first SA stage) within 1e-4 of each result's scale of its twin;
    returns the largest absolute error."""
    from deepclr_tpu_torch.ops import fused_sa

    pts = torch.from_numpy(dense_clouds(4)).to(dev)
    op = sa_operands(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    sa_op, active = fused_operands(op, dtype)
    pairs = pair_stats(sa_op)[0]
    out = fused_sa.fused_sa_core(sa_op, active)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    got = fused_sa.fused_sa_bwd(sa_op, active, out, g)
    ref = fused_sa._fused_sa_bwd_plain(sa_op, fused_sa._fused_sa_plain(sa_op), g)
    worst = 0.0
    for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), [got[0], got[1], *got[2], *got[3]],
                          [ref[0], ref[1], *ref[2], *ref[3]]):
        scale = max(1e-3, y.abs().max().item())
        err = (x - y).abs().max().item()
        worst = max(worst, err)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"fused_sa_bwd dense {dtype} {name}: max |diff| {err} > 1e-4 of the scale {scale}")
    emit({"check": "fused_sa_bwd_dense", "dtype": str(dtype), "clouds": 4, "points": 4096,
          "in_radius_pairs": pairs, "in_radius_pairs_per_centre": pairs / (4 * op["npoint"]),
          "max_abs_err": worst, "tolerance_of_scale": 1e-4, "fed": "fused_sa kernel output"})
    return worst


def run_main_path(model, dev):
    """Phase 4: predict_batch on the flagship workload, then sequential frames."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.models import ModelInferenceHelper
    from deepclr_tpu_torch.synthetic import kitti_like

    templates, sources = kitti_like(BATCH, NPTS, seed=1), kitti_like(BATCH, NPTS, seed=2)
    helper = ModelInferenceHelper(model, num_points=NPTS)
    ops.reset_launch_counts()
    y = helper.predict_batch(list(sources), list(templates))
    torch.cuda.synchronize()
    pair_counts = ops.launch_counts()
    if y.shape != (BATCH, 8) or not np.isfinite(y).all():
        raise AssertionError(f"predict_batch: shape {y.shape}, finite {np.isfinite(y).all()}")

    seq = ModelInferenceHelper(model, is_sequential=True, num_points=NPTS)
    ops.reset_launch_counts()
    outs = [seq.predict(templates[i]) for i in range(3)]
    torch.cuda.synchronize()
    seq_counts = ops.launch_counts()
    if outs[0] is not None or any(o.shape != (8,) or not np.isfinite(o).all() for o in outs[1:]):
        raise AssertionError(f"sequential predict: {outs}")
    for run, counts in (("predict_batch", pair_counts), ("sequential", seq_counts)):
        missing = [k for k in SERVING_KERNELS if counts.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"{run}: kernels {missing} never launched ({counts})")
    emit({"main_path": {"predict_batch_y0": y[0].tolist(), "launches_predict_batch": pair_counts,
                        "launches_sequential_3_frames": seq_counts}})

    # the same weights on the CPU's plain path, on two small pairs
    from deepclr_tpu_torch.models import build_model
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG

    cpu_model = build_model(KITTI_MODEL_CFG, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small_t, small_s = kitti_like(2, 4096, seed=5), kitti_like(2, 4096, seed=6)
    y_card = ModelInferenceHelper(model, num_points=4096).predict_batch(list(small_s), list(small_t))
    y_cpu = ModelInferenceHelper(cpu_model, num_points=4096).predict_batch(list(small_s), list(small_t))
    err = float(np.abs(y_card - y_cpu).max())
    emit({"check": "card_vs_cpu_predict_batch", "pairs": 2, "points": 4096, "max_abs_err": err,
          "tolerance": 2e-2})
    if not err <= 2e-2:
        raise AssertionError(f"card vs CPU prediction differ by {err}")
    return pair_counts, templates, sources


def train_parts(model_cfg, device, seed=0):
    """Model, optimizer, schedule, loss and metrics of the flagship recipe."""
    from deepclr_tpu_torch import solver
    from deepclr_tpu_torch.configs import KITTI_TRAIN_CFG
    from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns
    from deepclr_tpu_torch.models import build_model

    model = build_model(model_cfg, device=device, seed=seed)
    metrics = KITTI_TRAIN_CFG["metrics"]
    return (model, solver.make_optimizer(KITTI_TRAIN_CFG, model.parameters()),
            solver.make_schedule(KITTI_TRAIN_CFG), make_loss_fn(metrics["loss"], model_cfg["label_type"]),
            make_metric_fns(metrics["loss"], metrics["other"], model_cfg["label_type"]))


def run_train_path(dev):
    """Phase 5: the flagship train step on the card, through run_trainer."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG, KITTI_TRAIN_CFG
    from deepclr_tpu_torch.engine import create_train_state, make_train_step, run_trainer
    from deepclr_tpu_torch.synthetic import train_batch

    model, opt, schedule, loss_fn, metric_fns = train_parts(KITTI_MODEL_CFG, dev)
    sa_names = [n for n, _ in model.named_parameters() if n.startswith("_cloud_layers")]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []

    def inspect_grads(optimizer, args, kwargs):
        # before every update: all gradients finite, the SA weights' non-zero
        grads = {n: p.grad for n, p in model.named_parameters()}
        bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()]
        zero = [n for n in sa_names if n.endswith("weight") and grads[n].abs().max().item() == 0.0]
        seen.append({"non_finite_or_missing": bad, "zero_sa_weight_grads": zero,
                     "sa_weight_grad_absmax": max(grads[n].abs().max().item() for n in sa_names)})

    hook = opt.register_step_pre_hook(inspect_grads)
    cfg = copy.deepcopy(KITTI_TRAIN_CFG)
    cfg["optimizer"]["max_iterations"] = 4
    cfg["logging"].update(log_period=1, checkpoint_period=10**9)
    batches = [train_batch(TRAIN_BATCH, NPTS, seed=20 + i) for i in range(4)]
    ops.reset_launch_counts()
    state = run_trainer(cfg, model, batches, None, opt, schedule, loss_fn, metric_fns)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hook.remove()
    ema = {k: v.item() for k, v in state.metrics_ema.items()}
    changed = sum(int(not torch.equal(p.detach(), before[n])) for n, p in model.named_parameters())
    emit({"train_path": {"micro_steps": state.step, "updates": len(seen), "metrics_ema": ema,
                         "launches_4_micro_steps": counts, "grad_checks": seen,
                         "parameters_changed": changed, "parameters": len(before)}})
    if state.step != 4 or len(seen) != 2:
        raise AssertionError(f"train path: {state.step} micro-steps, {len(seen)} updates")
    if any(s["non_finite_or_missing"] or s["zero_sa_weight_grads"] for s in seen):
        raise AssertionError(f"train path: bad gradients {seen}")
    if not all(np.isfinite(v) for v in ema.values()) or changed != len(before):
        raise AssertionError(f"train path: loss {ema}, {changed} of {len(before)} parameters changed")
    missing = [k for k in TRAIN_KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"train path: kernels {missing} never launched ({counts})")

    # one micro-step with the argmax backward
    model.cloud_features._sa0.backward = "argmax"
    step = make_train_step(model, opt, loss_fn, metric_fns)
    ops.reset_launch_counts()
    step(create_train_state(model), batches[0], schedule(4))
    torch.cuda.synchronize()
    argmax_counts = ops.launch_counts()
    model.cloud_features._sa0.backward = "kernel"
    emit({"train_path_argmax_backward": {"launches_1_micro_step": argmax_counts}})
    if argmax_counts["fused_sa_argmax"] < 1 or argmax_counts["fused_sa_bwd"] != 0:
        raise AssertionError(f"argmax backward: launches {argmax_counts}")

    check_train_card_vs_cpu(dev)
    return model, opt, loss_fn, metric_fns, counts, argmax_counts, batches


def check_train_card_vs_cpu(dev, tol=2e-3):
    """One float32 micro-step on 2 pairs x 4096: every parameter's gradient
    on the card against the CPU (plain twins), within tol of its scale."""
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG
    from deepclr_tpu_torch.synthetic import train_batch

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["compute_dtype"] = "float32"
    batch = train_batch(2, 4096, seed=40)
    grads = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model, _, _, loss_fn, _ = train_parts(cfg, device, seed=3)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        y_pred, _ = model(b["template"], b["source"], b["template_mask"], b["source_mask"])
        loss_fn(y_pred, b["y"]).backward()
        grads[where] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    worst = max(((grads["card"][n] - g).abs().max() / max(1e-6, g.abs().max().item())).item()
                for n, g in grads["cpu"].items())
    emit({"check": "train_card_vs_cpu_gradients", "pairs": 2, "points": 4096, "dtype": "float32",
          "max_err_of_scale": worst, "tolerance": tol})
    if not worst <= tol:
        raise AssertionError(f"card vs CPU gradients differ by {worst} of their scale")


def nbytes(*ts):
    return sum(t_.numel() * t_.element_size() for t_ in ts)


def bound(byts, f32_ops, bf16_ops=0.0):
    t_bytes = byts / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pair_stats(sa_op):
    """In-radius pairs of this run's data, and the points they touch."""
    n = sa_op.pts4.shape[1]
    x, c = sa_op.pts4[..., None, :3], sa_op.centers[:, None]
    pairs = points_hit = 0
    for j in range(0, n, 1024):
        d2 = ((x[:, j:j + 1024] - c) ** 2).sum(-1)
        hit = (d2 < sa_op.r2max) & (sa_op.pts4[:, j:j + 1024, None, 3] == 0)
        pairs += int(hit.sum())
        points_hit += int(hit.any(-1).sum())
    return pairs, points_hit


def min_d2_ops(pts4, p):
    """The pre-pass's float32 operations on this data: 3 sub, 3 mul, 2 add
    and 1 min a (point, centre) pair, and the penalty add for the points of
    a chunk that holds an invalid point (an all-valid chunk needs none)."""
    from deepclr_tpu_torch.ops.fused_sa import CHUNK

    b, n, _ = pts4.shape
    pad = (0, -n % CHUNK)
    w = torch.nn.functional.pad(pts4[..., 3], pad, value=1.0)  # a ragged chunk takes the add
    real = torch.nn.functional.pad(torch.ones_like(pts4[..., 3]), pad).view(b, -1, CHUNK)
    penalty_points = int((real * (w.view(b, -1, CHUNK) != 0).any(-1, keepdim=True)).sum())
    return 9.0 * b * n * p + 1.0 * penalty_points * p


def sa_work(sa_op, active, pairs, points_hit, write_out=True):
    """Bytes, float32 and compute-dtype operations of one fused forward:
    the points, centres, centre term, bitmap, weights and (with `write_out`)
    the output once, plus the rows of the point term `a` of points inside
    some ball (the kernel reads no other row); layer-1 add + ReLU in
    float32, the two tail layers' multiply-adds in the compute dtype."""
    b, p = sa_op.bc.shape[:2]
    h1, h2, h3 = sa_op.a.shape[-1], sa_op.tail_w[0].shape[1], sa_op.tail_w[1].shape[1]
    byts = (nbytes(sa_op.pts4, sa_op.centers, sa_op.bc, active, *sa_op.tail_w, *sa_op.tail_b, sa_op.r2)
            + points_hit * h1 * 4 + (b * p * h3 * 4 if write_out else 0))
    return byts, 2.0 * pairs * h1, 2.0 * pairs * (h1 * h2 + h2 * h3)


def time_path(model, dev, templates, sources):
    """Phase 6, serving: end-to-end forward rate and the forward kernels at their path's shapes."""
    from deepclr_tpu_torch.ops import fps, fused_sa

    t = torch.from_numpy(templates).to(dev)
    s = torch.from_numpy(sources).to(dev)
    ones = torch.ones(BATCH, NPTS, dtype=torch.bool, device=dev)
    fwd_ms = cuda_ms(lambda: model(t, s, ones, ones), reps=10)
    both = torch.cat([t, s])
    both_mask = torch.cat([ones, ones])
    encode_ms = cuda_ms(lambda: model.encode(both, both_mask), reps=10)
    feats = model.encode(both, both_mask)
    register_ms = cuda_ms(lambda: model.register(feats[:BATCH], feats[BATCH:]), reps=10)
    # one odometry step: encode a new frame, register it against the cached one
    step_ms = cuda_ms(lambda: model.encode_register(feats[:1], s[:1], ones[:1]), reps=10)

    op = sa_operands(model, both, both_mask)
    b, n, p = op["xyz"].shape[0], op["xyz"].shape[1], op["npoint"]
    dtype = model.cloud_features._sa0.compute_dtype
    sa_op, active = fused_operands(op, dtype)
    pts4, centers, r2max = sa_op.pts4, sa_op.centers, sa_op.r2max
    min_d2 = fused_sa.block_min_d2(pts4, centers)
    pairs, points_hit = pair_stats(sa_op)
    pre_pass_ops = min_d2_ops(pts4, p)
    fps_shapes = {}
    for fb in FPS_BATCHES:
        x, m = op["xyz"][:fb], op["mask"][:fb]
        c = fps.device_cluster_size(dev, fb, n)
        fps_shapes[fb] = {"cluster": c, "ms": kernel_ms(lambda: fps.furthest_point_sample(x, p, m, cluster=c), 20),
                          "ms_cluster_1": kernel_ms(lambda: fps.furthest_point_sample(x, p, m, cluster=1), 20),
                          "bound_ms": bound(nbytes(x, m) + fb * p * 4, 9.0 * fb * (p - 1) * n)[0]}
    kernels = {
        "fps": dict(
            ms=kernel_ms(lambda: fps.furthest_point_sample(op["xyz"], p, op["mask"]), 20),
            device_ms=device_ms(lambda: fps.furthest_point_sample(op["xyz"], p, op["mask"]), 20),
            plain_ms=cuda_ms(lambda: fps._fps_plain(op["xyz"], p, op["mask"]), reps=3),
            # 3 sub, 3 mul, 2 add, 1 min per point and step; xyz + mask in, indices out
            bound=bound(nbytes(op["xyz"], op["mask"]) + b * p * 4, 9.0 * b * (p - 1) * n)),
        # the path's launch: min-d^2 and the culling bitmap
        "min_d2": dict(
            ms=kernel_ms(lambda: fused_sa.block_min_d2_and_cull(pts4, centers, r2max), 50),
            device_ms=device_ms(lambda: fused_sa.block_min_d2_and_cull(pts4, centers, r2max), 50),
            plain_ms=cuda_ms(lambda: fused_sa.cull_bitmap(fused_sa._block_min_d2_plain(pts4, centers), r2max),
                             reps=3),
            bound=bound(nbytes(pts4, centers, min_d2, active), pre_pass_ops),
            # every product rounded: no operation fuses, each is one instruction
            bound_issue_ms=pre_pass_ops / F32_ISSUE_PER_S * 1e3,
            min_d2_only_ms=kernel_ms(lambda: fused_sa.block_min_d2(pts4, centers), 50)),
        "fused_sa": dict(
            ms=kernel_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 50),
            device_ms=device_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 50),
            plain_ms=cuda_ms(lambda: fused_sa._fused_sa_plain(sa_op), reps=3),
            bound=bound(*sa_work(sa_op, active, pairs, points_hit))),
    }
    metrics = {
        "forward_pairs_per_s": BATCH / (fwd_ms / 1e3), "forward_ms": fwd_ms,
        "encode_2B_ms": encode_ms, "register_B_ms": register_ms, "sequential_step_ms": step_ms,
        "batch_pairs": BATCH, "points": NPTS, "compute_dtype": str(dtype),
        "in_radius_pairs": pairs, "in_radius_pairs_per_centre": pairs / (b * p), "points_in_a_ball": points_hit,
        "fps_by_batch": fps_shapes,
        "culling_chunks": min_d2.shape[1], "visited_block_share": active.float().mean().item(),
        "culling": culling_counts(sa_op, active, pairs),
        "min_d2_bound_issue_ms": kernels["min_d2"]["bound_issue_ms"],
        "min_d2_only_ms": kernels["min_d2"]["min_d2_only_ms"],
    }
    return metrics, kernels


def time_train(dev, model, opt, loss_fn, metric_fns, batches):
    """Phase 6, training: the flagship micro-step at 5 x 16384 (accumulation
    2, so every other micro-step updates), and the two training kernels at
    the train path's shapes (2B = 10 clouds)."""
    from deepclr_tpu_torch.engine import create_train_state, make_train_step
    from deepclr_tpu_torch.ops import fused_sa

    step = make_train_step(model, opt, loss_fn, metric_fns, accumulation_steps=2)
    state = create_train_state(model)
    dev_batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    times = []
    for i in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, dev_batches[i % len(dev_batches)], 1e-6)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times = times[2:]  # warm-up: one update and one accumulation
    micro_ms = statistics.mean(times)

    b0 = dev_batches[0]
    both = torch.cat([b0["template"], b0["source"]])
    with torch.no_grad():
        op = sa_operands(model, both, torch.cat([b0["template_mask"], b0["source_mask"]]))
        sa_op, active = fused_operands(op, model.cloud_features._sa0.compute_dtype)
    out = fused_sa.fused_sa_core(sa_op, active)
    g = torch.randn_like(out)
    pairs, points_hit = pair_stats(sa_op)
    byts, f32_ops, cd_ops = sa_work(sa_op, active, pairs, points_hit)
    b, p, h3 = out.shape
    kernels = {
        "fused_sa_argmax": dict(
            ms=kernel_ms(lambda: fused_sa.fused_sa_argmax(sa_op, active), 50),
            device_ms=device_ms(lambda: fused_sa.fused_sa_argmax(sa_op, active), 50),
            plain_ms=cuda_ms(lambda: fused_sa._fused_sa_argmax_plain(sa_op), reps=3),
            # the forward's work, plus the int32 winner per (centre, column)
            bound=bound(byts + b * p * h3 * 4, f32_ops, cd_ops)),
        "fused_sa_bwd": dict(
            ms=kernel_ms(lambda: fused_sa.fused_sa_bwd(sa_op, active, out, g), 50),
            device_ms=device_ms(lambda: fused_sa.fused_sa_bwd(sa_op, active, out, g), 50),
            plain_ms=cuda_ms(lambda: fused_sa._fused_sa_bwd_plain(sa_op, out, g), reps=3),
            bound=bwd_bound(sa_op, active, out, g, pairs, points_hit)),
    }
    dense = bwd_dense_timing(model, dev)
    metrics = {"train_micro_step_ms": micro_ms, "train_micro_step_ms_each": times, "bwd_dense": dense,
               "train_pairs_per_s": TRAIN_BATCH / (micro_ms / 1e3), "train_batch_pairs": TRAIN_BATCH,
               "train_accumulation_steps": 2, "train_in_radius_pairs": pairs,
               "train_in_radius_pairs_per_centre": pairs / (b * p),
               "train_visited_block_share": active.float().mean().item(),
               "train_culling": culling_counts(sa_op, active, pairs),
               # B2 at B5's shape, for the comparison of the two
               "fused_sa_train_shape_ms": kernel_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 50),
               "fused_sa_train_shape_device_ms": device_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 50)}
    return metrics, kernels


def bwd_bound(sa_op, active, out, g, pairs, points_hit):
    """B4's bound: the forward's recompute (reads only: out is read here,
    not written) plus the tail's backward multiply-adds (dW and the input
    delta per layer: twice the forward's); g and out read, da (every row),
    dbc, dW and db written."""
    byts, f32_ops, cd_ops = sa_work(sa_op, active, pairs, points_hit, write_out=False)
    b, n, h1 = sa_op.a.shape
    p = out.shape[1]
    dw_bytes = 4 * sum(w.numel() for w in (*sa_op.tail_w, *sa_op.tail_b))  # float32 dW and db
    return bound(byts + nbytes(out, g) + b * n * h1 * 4 + b * p * h1 * 4 + dw_bytes, f32_ops, 3.0 * cd_ops)


def bwd_dense_timing(model, dev):
    """B4 and B2 on the dense case at the train path's cloud count (10
    clouds x 4096 points in a 4 m cube)."""
    from deepclr_tpu_torch.ops import fused_sa

    with torch.no_grad():
        pts = torch.from_numpy(dense_clouds(2 * TRAIN_BATCH)).to(dev)
        op = sa_operands(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
        sa_op, active = fused_operands(op, model.cloud_features._sa0.compute_dtype)
        out = fused_sa.fused_sa_core(sa_op, active)
        g = torch.randn_like(out)
        pairs, points_hit = pair_stats(sa_op)
        bwd_ms = kernel_ms(lambda: fused_sa.fused_sa_bwd(sa_op, active, out, g), 10)
        fwd_ms = kernel_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 10)
        fwd_device_ms = device_ms(lambda: fused_sa.fused_sa_core(sa_op, active), 10)
    bound_ms, bound_by = bwd_bound(sa_op, active, out, g, pairs, points_hit)
    return {"clouds": 2 * TRAIN_BATCH, "points": 4096, "in_radius_pairs": pairs,
            "culling": culling_counts(sa_op, active, pairs),
            "in_radius_pairs_per_centre": pairs / (2 * TRAIN_BATCH * op["npoint"]), "fused_sa_bwd_ms": bwd_ms,
            "fused_sa_bwd_bound_ms": bound_ms, "bound_by": bound_by, "fused_sa_ms": fwd_ms,
            "fused_sa_device_ms": fwd_device_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG
    from deepclr_tpu_torch.models import build_model

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvidia_smi": card})

    t0 = time.perf_counter()
    paths = ops.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.parent / f"{name}.log"
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln] \
            if log.exists() else []
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    with torch.inference_mode():
        model = build_model(KITTI_MODEL_CFG, device="cuda", seed=0)
        errs = check_kernels(model, dev)
        emit({"phase": "kernels_vs_plain", "max_abs_err": errs})
        serve_counts, templates, sources = run_main_path(model, dev)
    # parameters built under inference mode cannot be trained: the train
    # path builds its own model
    train_model, opt, loss_fn, metric_fns, train_counts, argmax_counts, batches = run_train_path(dev)
    with torch.inference_mode():
        metrics, kernels = time_path(model, dev, templates, sources)
    train_metrics, train_kernels = time_train(dev, train_model, opt, loss_fn, metric_fns, batches)
    kernels.update(train_kernels)
    emit({"metrics": {**metrics, **train_metrics}, "card": card})
    launches = {**{k: serve_counts[k] for k in SERVING_KERNELS},
                "fused_sa_bwd": train_counts["fused_sa_bwd"],
                "fused_sa_argmax": argmax_counts["fused_sa_argmax"]}
    rows = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k = kernels[name]
        bound_ms, bound_by = k["bound"]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "device_ms": k["device_ms"],
                     **({"bound_issue_ms": k["bound_issue_ms"]} if "bound_issue_ms" in k else {})})
    emit({"launches_train_path_4_micro_steps": train_counts})
    emit({"kernels": rows})
    print(f"nvidia-smi: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
