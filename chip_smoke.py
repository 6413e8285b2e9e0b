#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (deepclr_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repository root, on an NVIDIA H100

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc compiles every kernel in deepclr_tpu_torch/csrc, in parallel;
3. kernels vs plain: each CUDA kernel against its plain PyTorch twin on the
   card at full width (4 clouds x 16384 points -> 1024 centres, one cloud
   with a masked tail, one all masked): FPS indices equal, min-d^2 values
   equal, fused set abstraction within 1e-5 of max(1, max|plain|) in float32
   and in bfloat16 (the twin rounds where the kernel rounds);
4. main path: the flagship KITTI model (random weights from seed 0) through
   ModelInferenceHelper.predict_batch on 16 pairs of 16384-point KITTI-like
   clouds, and 3 sequential frames through encode_register; outputs finite
   and (., 8); every kernel's launch count > 0 on each run; the card's
   prediction on 2 small pairs within 2e-2 of the same model on the CPU;
5. timing with CUDA events (medians after warm-up): forward pairs/s at
   16 x 16384, encode and register time, one sequential step (B = 1), each
   kernel's time, its plain twin's time and its bound at the path's shapes.

Prints JSON lines; the one before the last lists the kernels, the last is
{"ok": true, "device": {...}}.  Imports nothing of jax or deepclr_tpu.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, NPTS = 16, 16384       # the flagship serving workload: 16 pairs of 16384 points
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # dense bf16 tensor cores
TPU_KERNELS = {
    "fps": ("deepclr_tpu_torch/csrc/fps.cu", "deepclr_tpu/ops/pallas/fps_kernel.py:93"),
    "min_d2": ("deepclr_tpu_torch/csrc/min_d2.cu", "deepclr_tpu/ops/pallas/fused_sa_kernel.py:119"),
    "fused_sa": ("deepclr_tpu_torch/csrc/fused_sa.cu", "deepclr_tpu/ops/pallas/fused_sa_kernel.py:441"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def kitti_like(batch, n, seed):
    """Clouds with KITTI-like extent (~120 x 120 x 8 m) plus an intensity
    channel, made from a seed."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(batch, n, 3)).astype(np.float32) * np.array([30.0, 30.0, 2.0], np.float32)
    extra = rng.uniform(0.0, 1.0, size=(batch, n, 1)).astype(np.float32)
    return np.concatenate([pts, extra], axis=-1)


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


def check_kernels(model, dev):
    """Phase 3: each kernel against its plain twin on the card."""
    from deepclr_tpu_torch.ops import fps, fused_sa

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
    errs["fps"] = 0.0

    pts4 = fused_sa._pack_points(op["xyz"], op["mask"])
    got = fused_sa.block_min_d2(pts4, op["centers"])
    ref = fused_sa._block_min_d2_plain(pts4, op["centers"])
    if not torch.equal(got, ref):
        raise AssertionError(f"min_d2: max |diff| {(got - ref).abs().max().item()} vs the plain version")
    errs["min_d2"] = 0.0

    # The twin rounds to the compute dtype where the kernel does, so both agree
    # to float32 summation order; a kernel that skipped a bfloat16 rounding
    # would be off by ~2^-9 of the scale.
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5)):
        sa_op = fused_sa.prepare(op["xyz"], op["centers"], op["weights"], op["biases"], op["radius"],
                                 op["feats"], op["mask"], dtype)
        active = fused_sa.cull_bitmap(fused_sa.block_min_d2(sa_op.pts4, sa_op.centers), sa_op.r2max)
        got = fused_sa.fused_sa_core(sa_op, active)
        ref = fused_sa._fused_sa_plain(sa_op)
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        emit({"check": "fused_sa", "dtype": str(dtype), "max_abs_err": err, "max_abs_ref": scale,
              "tolerance": tol * scale, "visited_blocks": active.float().mean().item()})
        if not err <= tol * scale or got[3].abs().max().item() != 0.0:
            raise AssertionError(f"fused_sa {dtype}: max |diff| {err} > {tol * scale} or a non-empty "
                                 "ball in the all-masked cloud")
        errs["fused_sa"] = err  # the path's dtype, bfloat16, is checked last
    return errs


def run_main_path(model, dev):
    """Phase 4: predict_batch on the flagship workload, then sequential frames."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.models import ModelInferenceHelper

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
        missing = [k for k in TPU_KERNELS if counts.get(k, 0) < 1]
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


def time_path(model, dev, templates, sources):
    """Phase 5: end-to-end forward rate and per-kernel times at the path's shapes."""
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
    sa_op = fused_sa.prepare(op["xyz"], op["centers"], op["weights"], op["biases"], op["radius"],
                             op["feats"], op["mask"], dtype)
    pts4, centers = sa_op.pts4, sa_op.centers
    min_d2 = fused_sa.block_min_d2(pts4, centers)
    active = fused_sa.cull_bitmap(min_d2, sa_op.r2max)
    h1, h2, h3 = sa_op.a.shape[-1], sa_op.tail_w[0].shape[1], sa_op.tail_w[1].shape[1]
    x, c = pts4[..., None, :3], centers[:, None]
    pairs = points_hit = 0
    for j in range(0, n, 1024):  # in-radius pairs of this run's data, and the points they touch
        d2 = ((x[:, j:j + 1024] - c) ** 2).sum(-1)
        hit = (d2 < sa_op.r2max) & (pts4[:, j:j + 1024, None, 3] == 0)
        pairs += int(hit.sum())
        points_hit += int(hit.any(-1).sum())
    nc = min_d2.shape[1]

    def nbytes(*ts):
        return sum(t_.numel() * t_.element_size() for t_ in ts)

    def bound(byts, f32_ops, bf16_ops=0.0):
        t_bytes = byts / HBM_BYTES_PER_S
        t_ops = f32_ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    kernels = {
        "fps": dict(
            ms=cuda_ms(lambda: fps.furthest_point_sample(op["xyz"], p, op["mask"]), reps=10),
            plain_ms=cuda_ms(lambda: fps._fps_plain(op["xyz"], p, op["mask"]), reps=3),
            # 3 sub, 3 mul, 2 add, 1 min per point and step; xyz + mask in, indices out
            bound=bound(nbytes(op["xyz"], op["mask"]) + b * p * 4, 9.0 * b * (p - 1) * n)),
        "min_d2": dict(
            ms=cuda_ms(lambda: fused_sa.block_min_d2(pts4, centers), reps=20),
            plain_ms=cuda_ms(lambda: fused_sa._block_min_d2_plain(pts4, centers), reps=3),
            # 3 sub, 3 mul, 3 add, 1 min per pair
            bound=bound(nbytes(pts4, centers, min_d2), 10.0 * b * n * p)),
        "fused_sa": dict(
            ms=cuda_ms(lambda: fused_sa.fused_sa_core(sa_op, active), reps=20),
            plain_ms=cuda_ms(lambda: fused_sa._fused_sa_plain(sa_op), reps=3),
            # layer-1 add + ReLU in float32; the two tail layers' multiply-adds in the compute dtype.
            # Only the rows of the point term `a` of points inside some ball are read.
            bound=bound(nbytes(pts4, centers, sa_op.bc, active, *sa_op.tail_w, *sa_op.tail_b, sa_op.r2)
                        + points_hit * h1 * 4 + b * p * h3 * 4,
                        2.0 * pairs * h1, 2.0 * pairs * (h1 * h2 + h2 * h3))),
    }
    metrics = {
        "forward_pairs_per_s": BATCH / (fwd_ms / 1e3), "forward_ms": fwd_ms,
        "encode_2B_ms": encode_ms, "register_B_ms": register_ms, "sequential_step_ms": step_ms,
        "batch_pairs": BATCH, "points": NPTS, "compute_dtype": str(dtype),
        "in_radius_pairs": pairs, "in_radius_pairs_per_centre": pairs / (b * p), "points_in_a_ball": points_hit,
        "culling_chunks": nc, "visited_block_share": active.float().mean().item(),
    }
    return metrics, kernels


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
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] \
            if log.exists() else []
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    with torch.inference_mode():
        model = build_model(KITTI_MODEL_CFG, device="cuda", seed=0)
        errs = check_kernels(model, dev)
        emit({"phase": "kernels_vs_plain", "max_abs_err": errs})
        launches, templates, sources = run_main_path(model, dev)
        metrics, kernels = time_path(model, dev, templates, sources)
    emit({"metrics": metrics, "card": card})
    rows = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k = kernels[name]
        bound_ms, bound_by = k["bound"]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    emit({"kernels": rows})
    print(f"nvidia-smi: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
