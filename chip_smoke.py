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
   (the two sum in other fixed orders), on these clouds and on a
   dense-ball case (4096 points in a 4 m cube, ~33 points a 0.5 m ball);
   the backward (with its finishing launch) and B5's backward launched
   twice on the same operands bit-equal in every output, in both dtypes,
   on both cases; the backward fed a cotangent with one NaN and one inf at
   selected columns, in both dtypes, on both cases: da non-finite exactly
   where the twin's is, its other entries within 1e-4 of their scale, two
   launches bit-equal, NaN positions included; the backward fed a
   cotangent whose float32 bound 1.01 P G overflows (four selected entries
   at about 4 FLT_MAX / (1.01 P row sums), no output overflowing): its
   scale launch's S (negative) and flags equal the twin's, every output
   within 1e-4 of the twin's scale; the finishing launch against its twin
   on the backward's own workspace (da bit-equal, dW / db within 1e-5 of
   their scale, the scale launch's S and flags equal its twin's); the
   gather backward (its run-index launch equal to its twin, the sum twice
   bit-equal, equal bit for bit to the CPU's sequential scatter_add and
   within 1e-5 of the scale of the card's) at MotionEmbedding's train
   shape (5 x 20480 rows of 128 into 1024) on a uniform index and on the
   kNN index of a ray-cast train batch (6 HDL-64 scans along a drive), and
   at B5's backward scatter (4 x 65536 rows of 32 into 16384; the
   all-masked cloud is one run of 65536), each index's runs printed;
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
   micro-step under torch.use_deterministic_algorithms(True) (scoped, then
   restored) raises nothing; one
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
   in-radius pairs a kept (chunk, tile) block); B4's scale launch alone
   (torch.profiler); the gather backward on the uniform and the ray-cast
   kNN index: back to back, on the device, each of its two launches on the
   device, beside index_put_(accumulate=True) under
   torch.use_deterministic_algorithms(True) timed the same ways;
7. scenario inference: packs written with the port's PackWriter into a
   temporary directory (two 8-frame KITTI-like sequences of 120000 points a
   frame, about an HDL-64 scan, poses advancing by small random rigid
   motions, so every frame is subsampled; one generic pack of 8 pairs of
   12000-point clouds, which are padded) go through inference.run_scenario
   with the flagship model: sequential at 1 and 2 lanes with float32 and
   uint16 uploads, pairwise one pair a call and 4 pairs a call.  Checks:
   7 rows a sequence file and 8 a pair file, all finite; the Evaluator's
   step errors finite; uint16 within 2e-2 of float32 (the bound of
   tests/model/test_upload_quant.py) and 4 pairs a call within 2e-2 of one
   pair a call, on the normalised dual-quaternion labels of the written
   transforms; fps, min_d2 and fused_sa launched in the phase; a 2-lane
   BatchedSequentialHelper within 2e-2 of two ModelInferenceHelpers seeded
   0 and 1 (every kernel works per cloud, but cuBLAS picks its GEMM by the
   row count, so the lanes' float32 sums may run in another order before a
   bf16 rounding: the card-vs-CPU bf16 bound); a presorted flagship model on
   2 pairs x 4096 within 2e-2 of the same model on the CPU; the flagship
   at compute_dtype float32 within 1e-5 (the JAX contract) on both batch
   checks, 2 lanes against per-lane helpers and 4 pairs a call against
   one.  Timing (host clock, each step ending in a fetch): the per-frame sequential step at 1,
   2 and 8 lanes from raw 120000-point frames (median, and its share a
   lane), its host split (pad/subsample, stack/quantise, upload, device
   step, fetch), and pairwise pairs/s at 16 pairs a call from raw
   120000-point clouds beside phase 6's device-resident forward;
8. training from a YAML (outside inference mode, models of its own, in a
   temporary directory): packs written as the repository's converters
   write them (KITTI sequences 00 and 01 of 10 frames and 04 of 90 frames,
   each a ray-cast HDL-64 scan of 120000 points along a driven path with
   every 2nd point kept; ModelNet40 train.pack and test_seen.pack of CAD
   clouds reduced to 2048 points by host FPS); YAMLs that extend the
   shipped configs/training/kitti_synth.yaml and modelnet40.yaml (never
   written) and override only the iteration count and the logging periods;
   train(cfg), the function behind python -m deepclr_tpu_torch.training,
   in this process for 8 micro-steps each, with
   validation every 4 and after the final checkpoint, and the KITTI run
   resumed from its ckpt.pt for 4 more.  Checks: the run directory's
   artifacts (config.yaml, model_config.yaml, models/*.py, ckpt.pt and
   weights.pt links, ckpt_final_N.pt, scalars.jsonl), the tags train/loss,
   params/lr, val/loss_fn, val/step_t_err (and val/kitti_t_err for KITTI)
   all finite, fps, min_d2, fused_sa and fused_sa_bwd launched in each run,
   the run directory loaded as a model directory through
   inference.run_scenario on the validation pack with finite rows, B2 and
   B4 against their twins on a training batch of each recipe.  Timing: the
   loader alone (0 workers, 6 threads, 6 spawned processes), the KITTI
   micro-step (CUDA events around train_step) beside the loader wait,
   validation ms a batch, timing.timing(cfg, sequential=True) on the
   validation pack, and B1-B4 device time against their bounds with the
   culling counts on a training batch of each recipe, with B4's scale
   launch alone and the gather backward at the batch's kNN index (gated as
   in phase 3, its runs printed);
9. the ICP baselines and scoring without JAX (in a temporary directory): a
   KITTI sequence pack of ray-cast HDL-64 scans (120000 points, every 2nd
   kept, so ~60000 a frame), cut only in frame count (ICP_FRAMES), goes
   through icp.cli.run, the function behind python -m
   deepclr_tpu_torch.icp, with icp_po2po, icp_po2pl and gicp at
   --max-distance 1.0 (scripts/run_icp.sh) on the card.  Checks: every
   transform finite and SE(3) (rotation orthonormal to 1e-4), iterations
   <= max_iterations, and each algorithm on a seeded 4096-point cut of
   every pair on the card within ICP_TOL of the same on the CPU (1e-4, the
   CPU parity bound of tests/test_torch_icp.py; 1e-3 for po2po, whose
   centroid moves 2.4e-4 with one flipped correspondence), iterations within one, on
   every pair where both runs converged before the iteration cap (at least
   one must; a capped run's last iterate is printed, not gated).  The
   error against the known motion is printed, not gated.  Then the
   evaluation CLI (evaluation.cli.main, with pandas and matplotlib
   absent) scores the three runs alone and as one scenario, and the
   DeepCLR runs of phases 7 and 8 written as run directories; every step
   table is finite, and so is the segment table of phase 8's 106 m
   sequence (the others are shorter than KITTI's shortest segment, so
   their segment fields are empty); the devkit CLI on every run's pose
   files counts exactly the sequences that reach 100 m.  Printed: ms a
   pair (host clock, the pair's clouds on the host to its transform on
   the host) with the share spent in the per-iteration host reads and in
   the iteration loop, the device's busy share of the loop (CUDA events
   around each iteration), iterations, peak torch.cuda.max_memory_allocated,
   the errors against the known motion, the nearest-neighbour block size;
10. model variants (the exact set abstraction, with the reference's ball
   query, and the variant modules), through the port's entry points:
   (a) ops.ball_query_scales on the card against the CPU at the flagship's
   scales (r 0.5 / nsample 512, r 1.0 / nsample 1024) on 32 KITTI-like
   clouds of 16384 points (a masked tail, an all-masked cloud) around 1024
   FPS centres, and on the dense cube (10 x 4096 points in 4 m, r 1.0,
   nsample 64, where truncation bites): the indices equal on every ball
   without a valid point within 1e-3 m^2 of r^2 (by exact float64
   distances; the expanded float32 form may put such a point on either
   side); (b) the flagship with fused: False (seed-0 weights, bf16) through
   predict_batch on 16 pairs of 16384 points: output finite and (16, 8),
   fps launched and min_d2 / fused_sa not; the same weights through the
   fused model within 2e-2 on host-sorted clouds (presorted models: the
   fused path otherwise Morton-sorts before FPS, which then starts at
   another point), gated only when no ball exceeds its nsample (the
   largest is printed; the unsorted difference too); the exact model on 2
   pairs x 4096 within 2e-2 of the CPU; the fused-vs-exact drift at
   float32 on a ray-cast KITTI batch of phase 8 with its trained weights,
   as scripts/parity_fused_exact.py reports it, as loaded and host-sorted,
   with the largest and truncated balls (printed, not gated); (c) the
   exact flagship's train step through run_trainer at 5 x 16384 (2
   micro-steps, one update): loss and every gradient finite, every
   set-abstraction weight's gradient non-zero, fps launched and no fused
   kernel; a float32 micro-step on 2 pairs x 4096 within 2e-3 of the CPU's
   gradients; (d) MotionEmbedding with k=0, with append_features=False and
   with batch norm, OutputSimple with batch norm and FeaturePropagation
   with batch norm (running statistics from a training forward first), in
   evaluation and training mode, card against CPU within 1e-5 (float32)
   and 2e-2 (bf16) of max(1, max|CPU|), the running statistics too
   (OutputSimple on the serving batch of 16 clouds, each with its own
   offset and spread: its linear layers normalise over the batch alone);
   the exact DeepCLR.forward on 16384-point templates and 12000-point
   sources within 2e-2; (e) a reference-layout weights.tar
   ((out, in, 1) convolution weights) through python -m
   deepclr_tpu_torch.convert_weights and load_trained_model, both giving
   the source model's predictions exactly; (f) timing (CUDA events,
   medians after a warm-up): the exact forward's pairs/s at 16 x 16384
   beside phase 6's fused figure, the ball query at each scale and both
   from one distance pass, the grouped MLP, the exact train micro-step at
   5 x 16384, peak allocated memory, the ball query's block size;
11. data-parallel training (in a temporary directory): a training and a
   validation KITTI sequence of ray-cast HDL-64 scans, each scan subsampled
   once to 16384 points as it is written (41 and 11 frames: 4 micro-steps
   of 2 x 5 pairs, and one validation batch of 10), and YAMLs that extend
   the shipped configs/training/kitti_base.yaml (5 pairs of 16384 points a
   rank, accumulation 2, no augmentation) with float32, 4 micro-steps, a
   constant lr of 1e-5 in place of the schedule (which starts at 1e-7, too
   small for two updates to show an error in the gradients; see dp_yaml
   for why not more) and no loader workers.  Weights are compared on one
   scale for the whole model (weights_rel_err: the largest difference of
   any weight over the largest weight; the tensor that differs most on its
   own scale is printed beside it).  (a) train(cfg) in a one-rank NCCL
   process group (DistributedDataParallel, the kernels) against train(cfg)
   without one: the train/loss_fn trajectory and the final weights equal
   bit for bit, the train step run by the DistributedDataParallel wrapper,
   and B1-B4 (with the finishing launch and the gather backward) launched
   in that run, each micro-step exactly as often as without a group (the
   counts are zeroed just before the run); two runs without a group at lr
   1e-3 equal bit for bit (losses and weights).  (b) Two gloo
   ranks on the one card (python -m deepclr_tpu_torch.training's main()
   in two processes, started with the DEEPCLR_COORDINATOR contract, each
   joining the group over gloo itself and stopped within 600 s) against
   one process of batch 10: train/loss_fn within rtol 5e-3 / atol 1e-5
   (the bound of tests/parallel/test_distributed_2proc.py), every val/
   scalar of rank 0 within 1e-5 of its scale, rank 0's final weights
   within 1e-5 (ranks that kept their own gradients fail here and in
   validation; the update's own error is printed beside it), one
   run directory with files (rank 1 writes nothing), B1-B4 launched on
   both ranks.  Timing (CUDA events around
   each train step, 12 micro-steps a run, medians after the first update,
   local and all-reducing micro-steps apart): no group and the one-rank
   group in turns (no group, group, group, no group), then each gloo
   rank; the two runs without a group (lr 1e-5, 12 micro-steps) equal bit
   for bit; the gradient bytes all-reduced an update, the launches a
   data-parallel micro-step, and the host time of the trainer's
   end-of-iteration interrupt all-reduce (one-rank NCCL, each gloo rank).
   ``python3 chip_smoke.py --dp-rank YAML OUT_DIR`` is one such rank;
12. the data CLIs and demos (in a temporary directory, each through the
   main() its ``python -m`` line calls): make_synthetic_kitti (sequences
   00, 01, 04 of 7 frames of 32768 points) and make_synthetic_modelnet
   (one train and one test model a shape of 2100 points); the converters
   kitti_odometry, kitti_pairs, kitti_pairs_test, modelnet40 and
   modelnet40_test on them, each pack read back by the dataflow (6 pairs
   of 4-column clouds a sequence, 2048-point models, 22 noisy test packs);
   2 micro-steps of the shipped kitti_synth.yaml from the converted packs
   (the training kernels launched, the run directory complete); the KITTI
   demo on that run directory (5 finite translation errors) and the
   ModelNet40 demo from seed 0 (3), both on the card with fps, min_d2 and
   fused_sa launched; export_kitti_poses on predictions of sequence 04,
   its rows the predicted poses (calib.txt's Tr is the identity); then the
   paper tables: inference.run_scenario on the card under scenarios named
   as the shipped ones and cut to the converted packs (kitti_04_10 on
   sequence 04 with the trained run's weights, kitti_pairs on pairs_test
   with them, modelnet40_unseen on the 11 unseen packs with the ModelNet40
   model of seed 0), icp_po2pl through icp.cli.run on kitti_pairs, each
   written as a run directory; fps, min_d2 and fused_sa launched in those
   runs; the three tables' main() (python -m
   deepclr_tpu_torch.paper.{kitti_odometry_table,kitti_artificial_table,
   modelnet40_table}) with pandas and with pandas hidden, every number
   either prints equal, to its printed precision (pandas) or exactly (the
   standard-library table), to the evaluation CLI's step_errors.csv of
   the same run, and the rows the runs' (sequences, methods).  The
   phase's seconds are printed beside the card's name and power limit.

``python3 chip_smoke.py --dp-cards`` (a host with two or more cards, not
part of the run above) runs phase 11's comparison across every card:
torchrun with DEEPCLR_DISTRIBUTED=1, NCCL, 5 pairs a rank, against one
process of the global batch on card 0 (the same gates as (b), weights
included), then each
rank's micro-step beside one card's without a group.

Prints JSON lines; the one before the last two lists the kernels, then the
card's name and power limit, and the last is {"ok": true, "device": {...}}.
Imports nothing of jax or of the deepclr_tpu package.
"""
import contextlib
import copy
import importlib.util
import io
import json
import logging
import math
import os
import os.path as osp
import statistics
import subprocess
import sys
import tempfile
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
REPO = osp.dirname(osp.abspath(__file__))
KITTI_YAML = "configs/training/kitti_synth.yaml"
MODELNET_YAML = "configs/training/modelnet40.yaml"
MN_CLOUDS, MN_POINTS = 10, 2048  # the ModelNet40 train encode: 2B = 10 clouds of 2048 points
MN_RAW_POINTS = 10_000        # a PointNet++-preprocessed ModelNet40 model, reduced to MN_POINTS by host FPS
MN_TRAIN, MN_TEST = 10, 5     # models in train.pack / test_seen.pack
SCAN_POINTS = 120_000         # a ray-cast HDL-64 scan; the KITTI converter keeps every 2nd point
# frames a sequence: 04, the validation drive, is 106 m long at 1.2 m a frame, past the
# shortest KITTI segment (100 m), so its segment errors exist
KITTI_SEQUENCES = {"00": 10, "01": 10, "04": 90}
TPU_KERNELS = {
    "fps": ("deepclr_tpu_torch/csrc/fps.cu", "deepclr_tpu/ops/pallas/fps_kernel.py:93"),
    "min_d2": ("deepclr_tpu_torch/csrc/min_d2.cu", f"{FUSED_SA_PALLAS}:119"),
    "fused_sa": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:441"),
    "fused_sa_argmax": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:441"),
    "fused_sa_bwd": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:787"),
}
# the port's own kernels, each beside the TPU function whose work it serves
OWN_KERNELS = {
    "fused_sa_bwd_finish": ("deepclr_tpu_torch/csrc/fused_sa.cu", f"{FUSED_SA_PALLAS}:787"),
    "gather_bwd": ("deepclr_tpu_torch/csrc/gather.cu", "deepclr_tpu/ops/grouping.py:45"),
    "gather_bwd_index": ("deepclr_tpu_torch/csrc/gather.cu", "deepclr_tpu/ops/grouping.py:45"),
}
SERVING_KERNELS = ("fps", "min_d2", "fused_sa")
TRAIN_KERNELS = ("fps", "min_d2", "fused_sa", "fused_sa_bwd", "fused_sa_bwd_finish", "gather_bwd_index", "gather_bwd")
FPS_BATCHES = (32, 10, 1)     # FPS's path shapes: serving encode (2B), train encode (2B), sequential step
SCENE_POINTS = 120_000        # a frame of about an HDL-64 scan: subsampled to NPTS
SCENE_FRAMES = 8              # frames a sequence: 7 registrations
SCENE_PAIRS, PAIR_POINTS = 8, 12_000  # the pair pack: clouds that fit NPTS, so padded
SCENE_LANES = (1, 2, 8)
SCENE_TOL = 2e-2
F32_BATCH_TOL = 1e-5          # batch invariance at float32: B lanes equal B single helpers (the JAX contract)
ICP_FRAMES = 6                # frames of the ICP drive (5 registrations): a drive cut in length only
ICP_ALGORITHMS = ("icp_po2po", "icp_po2pl", "gicp")
ICP_MAX_DISTANCE = 1.0        # scripts/run_icp.sh
ICP_MAX_ITERATIONS = 100      # the CLI's default
ICP_CUT_POINTS = 4096         # card against CPU on this cut of every pair
# card against CPU: the CPU parity bound of tests/test_torch_icp.py, 1e-4,
# except for po2po, whose update is a centroid: one correspondence that the
# two devices' last-bit differences move to a neighbour d away shifts it by
# d / 4096 (2.4e-4 at the 1 m gate), so it is held to four such flips
ICP_TOL = {"icp_po2po": 1e-3, "icp_po2pl": 1e-4, "gicp": 1e-4}
KITTI_BASE_YAML = "configs/training/kitti_base.yaml"
DP_RANKS = 2                  # phase 11: two gloo ranks sharing the one card
DP_MICRO_STEPS = 4            # each comparison run: 2 updates of accumulation 2
DP_TIMING_STEPS = 12          # each timing run: the first update is the warm-up
DP_ONE_RANK_TOL = 0.0         # a one-rank group against no group: bit-equal (losses, weights as in weights_rel_err)
DP_LOSS_RTOL, DP_LOSS_ATOL = 5e-3, 1e-5  # the bound of tests/parallel/test_distributed_2proc.py
DP_VAL_TOL = 1e-5             # validation scalars, two ranks against one process (relative)
DP_WEIGHT_TOL = 1e-5          # final weights, the ranks' against one process's (as in weights_rel_err)
DP_LR = 1e-5                  # comparison runs: a constant lr (see dp_yaml)
DP_HIGH_LR = 1e-3             # two runs without a group at this lr, too, must be bit-equal
INTERRUPT_FLAG_CALLS = 50     # timed calls of the trainer's end-of-iteration interrupt all-reduce
DP_RANK_TIMEOUT_S = 600


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
    sort (both sorts only from SORT_MIN_POINTS points), multi-scale bundle;
    no point features when the cloud has only xyz."""
    from deepclr_tpu_torch import ops

    from deepclr_tpu_torch.models.pointnet2 import SORT_MIN_POINTS

    sa = model.cloud_features._sa0
    xyz, feats = points[..., :3].contiguous(), (points[..., 3:] if points.shape[-1] > 3 else None)
    sort = points.shape[1] >= SORT_MIN_POINTS  # smaller clouds stay unsorted, as in the model
    if sort:
        xyz, feats, mask = ops.spatial_sort(xyz, feats, mask)
    idx = ops.furthest_point_sample(xyz, sa.npoint, mask)
    centers = ops.gather_points(xyz, idx)
    if sort:
        centers = ops.spatial_sort(centers)[0]
    weights, biases, radius = ops.multi_scale_bundle(
        [[m.dense(i).weight.t() for i in range(m.depth)] for m in sa.mlps],
        [[m.dense(i).bias for i in range(m.depth)] for m in sa.mlps], sa.radii)
    return dict(xyz=xyz.contiguous(), feats=None if feats is None else feats.contiguous(), mask=mask, npoint=sa.npoint,
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
        check_repeat(f"fused_sa_bwd {dtype} 4 x {NPTS}", got, fused_sa.fused_sa_bwd(sa_op, active, out, g))
        check_bwd_non_finite(sa_op, active, out, g, f"{dtype} 4 x {NPTS}")
        check_bwd_overflow(sa_op, active, out, g, f"{dtype} 4 x {NPTS}")
        errs["fused_sa_bwd_finish"] = check_bwd_finish(sa_op, active, out, g)
        check_winner_grads_repeat(sa_op, jstar, g, f"{dtype} 4 x {NPTS}")
        errs["fused_sa_bwd"] = max(worst, check_bwd_dense(model, dev, dtype))
    errs["gather_bwd"] = max(check_gather_bwd(*gather_bwd_operands(dev), "uniform"),
                             check_gather_bwd(*raycast_gather_operands(model, dev), "ray-cast kNN"),
                             check_gather_bwd(*winner_gather_operands(sa_op, jstar), "B5 _winner_grads"))
    errs["gather_bwd_index"] = 0.0  # check_gather_bwd: equal to its twin, or raised
    return errs


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


def bits(x):
    """A float tensor's bits as integers (NaNs compare by their bits)."""
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(x.dtype, x.dtype))


def check_repeat(what, first, second):
    """Raise unless two results of the same call on the same operands
    (tensors, or nested lists of them) are equal bit for bit."""
    xs, ys = _tensors(first), _tensors(second)
    differ = [i for i, (x, y) in enumerate(zip(xs, ys)) if not torch.equal(bits(x), bits(y))]
    emit({"check": "bit_equal_repeat", "what": what, "outputs": len(xs), "outputs_differing": differ})
    if differ or len(xs) != len(ys):
        raise AssertionError(f"{what}: two launches on the same operands differ in outputs {differ}")


def check_bwd_finish(sa_op, active, out, g):
    """B4's second launch against its plain twin on B4's own workspace:
    dW / db within 1e-5 of each result's scale (the twin sums the rows in
    another order), da bit-equal (both convert the same integers with one
    rounding).  Returns the largest absolute error."""
    from deepclr_tpu_torch.ops import fused_sa

    _, part, da_fx, da_state = fused_sa._bwd_first_launch(sa_op, active, out, g, fused_sa.KERNEL_WIDTHS)
    check_da_scale(sa_op, g, da_state, "fused_sa_bwd_finish")
    got = fused_sa.fused_sa_bwd_finish(part, da_fx, da_state)
    ref = fused_sa._fused_sa_bwd_finish_plain(part, da_fx, da_state)
    if not torch.equal(bits(got[0]), bits(ref[0])):
        raise AssertionError("fused_sa_bwd_finish: da differs from the plain conversion")
    worst = 0.0
    for x, y in zip([*got[1], *got[2]], [*ref[1], *ref[2]]):
        err = (x - y).abs().max().item()
        worst = max(worst, err)
        if not err <= 1e-5 * max(1e-6, y.abs().max().item()):
            raise AssertionError(f"fused_sa_bwd_finish: dW / db max |diff| {err} vs the plain sum")
    emit({"check": "fused_sa_bwd_finish", "rows": part.shape[0], "da_exponent": int(da_state[0]),
          "max_abs_err": worst, "da_bit_equal": True})
    return worst


def check_da_scale(sa_op, g, da_state, what):
    """B4's scale launch (S and the flags in da_state) against its twin,
    fused_sa.da_scale, on CPU copies of the rounded tail and g: equal."""
    from deepclr_tpu_torch.ops import fused_sa

    want = fused_sa.da_scale(*(w.cpu() for w in fused_sa._rounded_tail(sa_op)), g.cpu(), sa_op.bc.shape[1])
    if not torch.equal(da_state[:2].cpu(), want):
        raise AssertionError(f"{what}: the scale launch wrote S, flags {da_state[:2].tolist()}, "
                             f"its twin {want.tolist()}")
    return want


def selected_entries(out, k):
    """k cotangent entries whose column has a winner (out > 0), so the
    equality select and relu' pass them, spread over cloud 0."""
    hits = torch.nonzero(out[0] > 0)
    return [(0, *hits[i * len(hits) // k].tolist()) for i in range(k)]


def check_bwd_non_finite(sa_op, active, out, g, what):
    """B4 fed g with one NaN and one inf at selected columns: da non-finite
    exactly where the twin's is (the kernel flags those (point, lane)
    sums and its finishing launch writes NaN there), its other entries and
    the other outputs' finite entries within 1e-4 of their scale, two
    launches bit-equal, NaN positions included."""
    from deepclr_tpu_torch.ops import fused_sa

    g = g.clone()
    i_nan, i_inf = selected_entries(out, 2)
    g[i_nan], g[i_inf] = float("nan"), float("inf")
    got = fused_sa.fused_sa_bwd(sa_op, active, out, g)
    ref = fused_sa._fused_sa_bwd_plain(sa_op, fused_sa._fused_sa_plain(sa_op), g)
    bad, bad_ref = ~torch.isfinite(got[0]), ~torch.isfinite(ref[0])
    if not bad.any() or not torch.equal(bad, bad_ref):
        raise AssertionError(f"fused_sa_bwd {what}, non-finite g: da non-finite at {int(bad.sum())} entries, "
                             f"the twin at {int(bad_ref.sum())}, {int((bad != bad_ref).sum())} differ")
    errs = {}
    for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), [got[0], got[1], *got[2], *got[3]],
                          [ref[0], ref[1], *ref[2], *ref[3]]):
        ok = torch.isfinite(x) & torch.isfinite(y)
        scale = max(1e-3, y[ok].abs().max().item()) if ok.any() else 1e-3
        errs[name] = (x[ok] - y[ok]).abs().max().item() if ok.any() else 0.0
        if not errs[name] <= 1e-4 * scale:
            raise AssertionError(f"fused_sa_bwd {what}, non-finite g, {name}: max |diff| {errs[name]} > 1e-4 of "
                                 f"the scale {scale}")
    check_repeat(f"fused_sa_bwd {what}, non-finite g", got, fused_sa.fused_sa_bwd(sa_op, active, out, g))
    emit({"check": "fused_sa_bwd_non_finite_g", "what": what, "nan_at": list(i_nan), "inf_at": list(i_inf),
          "da_non_finite": int(bad.sum()), "da_non_finite_equal_to_twin": True,
          "non_finite": {name: int((~torch.isfinite(x)).sum()) for name, x in
                         zip(("dbc", "dw2", "dw3", "db2", "db3"), [got[1], *got[2], *got[3]])},
          "max_abs_err_finite": errs, "tolerance_of_scale": 1e-4})


def check_bwd_overflow(sa_op, active, out, g, what):
    """B4 fed g whose float32 bound 1.01 P G overflows while no output
    does: four selected entries at +-4 FLT_MAX / (1.01 P max row sum |W2|
    max row sum |W3|).  The scale launch's S (negative) and flags equal its
    twin's; every output finite and within 1e-4 of the twin's scale."""
    from deepclr_tpu_torch.ops import fused_sa

    p = out.shape[1]
    w2, w3 = fused_sa._rounded_tail(sa_op)
    rows = w2.double().abs().sum(1).max().item() * w3.double().abs().sum(1).max().item()
    big = 4 * torch.finfo(torch.float32).max / (1.01 * p * rows)
    g = g.clone()
    for k, idx in enumerate(selected_entries(out, 4)):
        g[idx] = big if k % 2 else -big
    f32_bound = (w2.abs().sum(1).amax() * w3.abs().sum(1).amax() * g.abs().amax() * (1.01 * p)).item()
    _, _, _, da_state = fused_sa._bwd_first_launch(sa_op, active, out, g, fused_sa.KERNEL_WIDTHS)
    want = check_da_scale(sa_op, g, da_state, f"fused_sa_bwd {what}, overflowing bound")
    if not math.isinf(f32_bound) or want[0] >= 0 or want[1] != 0:
        raise AssertionError(f"fused_sa_bwd {what}: float32 bound {f32_bound}, S, flags {want.tolist()}")
    got = fused_sa.fused_sa_bwd(sa_op, active, out, g)
    ref = fused_sa._fused_sa_bwd_plain(sa_op, fused_sa._fused_sa_plain(sa_op), g)
    errs = {}
    for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), [got[0], got[1], *got[2], *got[3]],
                          [ref[0], ref[1], *ref[2], *ref[3]]):
        scale = max(1e-3, y.abs().max().item())
        errs[name] = (x - y).abs().max().item()
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()) or not errs[name] <= 1e-4 * scale:
            raise AssertionError(f"fused_sa_bwd {what}, overflowing bound, {name}: max |diff| {errs[name]} "
                                 f"against 1e-4 of the scale {scale}, or a non-finite output")
    emit({"check": "fused_sa_bwd_float32_bound_overflow", "what": what, "max_abs_g": big,
          "float32_bound": f32_bound, "da_exponent": int(want[0]), "max_abs_err": errs,
          "scale_da": ref[0].abs().max().item(), "tolerance_of_scale": 1e-4})


def check_winner_grads_repeat(sa_op, jstar, g, what):
    """B5's backward (the float32 MLP at the winners, then the gather
    backward's scatter) twice on the same operands: bit-equal.  Runs with
    autograd, outside inference mode, on copies of the operands."""
    from deepclr_tpu_torch.ops import fused_sa

    with torch.inference_mode(False):
        op = sa_op._replace(a=sa_op.a.clone(), bc=sa_op.bc.clone(), tail_w=[w.clone() for w in sa_op.tail_w],
                            tail_b=[x.clone() for x in sa_op.tail_b])
        js, gg = jstar.clone(), g.clone()
        check_repeat(f"B5 backward (_winner_grads) {what}", fused_sa._winner_grads(op, js, gg),
                     fused_sa._winner_grads(op, js, gg))


def gather_bwd_operands(dev, b=TRAIN_BATCH, p=1024, k=20, c=128, seed=6):
    """MotionEmbedding's gather at the train path's shapes: B pairs, P
    template centres, k neighbours among P source centres, the layer-1 width
    of the flagship's embedding (128); the cotangent of the gathered rows.
    The index is uniform."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, p, (b, p * k), generator=gen).to(dev)
    g = torch.randn(b, p * k, c, generator=gen).to(dev)
    return g, idx, p


_RAYCAST_KNN = {}


def motion_gather_operands(model, centers, seed):
    """MotionEmbedding's gather on a batch's set-abstraction centres (2B
    clouds, templates first): the model's k nearest source centres of each
    template centre (ops.knn, as models/deepclr.py calls it) flattened to
    (B, P k), and a seeded cotangent of the embedding's layer-1 width."""
    from deepclr_tpu_torch import ops

    half = centers.shape[0] // 2
    idx = ops.knn(centers[:half], centers[half:], model.merge.k)[0].reshape(half, -1).long().contiguous()
    c = model.merge.mlp.dense(0).weight.shape[0]
    g = torch.randn(*idx.shape, c, generator=torch.Generator().manual_seed(seed)).to(centers.device)
    return g, idx, centers.shape[1]


def raycast_gather_operands(model, dev):
    """MotionEmbedding's gather on a ray-cast train batch: TRAIN_BATCH + 1
    HDL-64 scans along a drive (every 2nd point kept, as the KITTI
    converter keeps them, then NPTS drawn), consecutive frames paired.  A
    real kNN index is skewed: centres near the sensor are named by many
    template centres.  The centres (FPS, Morton sorts) do not depend on
    the weights, so the operands are made once."""
    if not _RAYCAST_KNN:
        from deepclr_tpu_torch.data.synthetic import drive

        rng = np.random.default_rng(70)
        frames = []
        for _, scan in drive(rng, TRAIN_BATCH + 1, SCAN_POINTS):
            kept = scan[::2]
            frames.append(kept[rng.choice(len(kept), NPTS, replace=False)])
        pts = torch.from_numpy(np.stack(frames)).to(dev)
        both = torch.cat([pts[:-1], pts[1:]])
        with torch.no_grad():
            op = sa_operands(model, both, torch.ones(both.shape[:2], dtype=torch.bool, device=dev))
            _RAYCAST_KNN["operands"] = motion_gather_operands(model, op["centers"], seed=71)
    return _RAYCAST_KNN["operands"]


def winner_gather_operands(sa_op, jstar, seed=72):
    """B5's backward scatter as _winner_grads forms it: every (centre,
    column) winner's row of H1 layer-1 cotangents into the cloud's points
    (no winner: row 0)."""
    b, p, h3 = jstar.shape
    n, h1 = sa_op.a.shape[1:]
    g = torch.randn(b, p * h3, h1, generator=torch.Generator().manual_seed(seed)).to(jstar.device)
    return g, jstar.clamp(min=0).long().view(b, p * h3).contiguous(), n


def run_lengths(idx, n):
    """A gather index's runs: the mean and largest count of a named row,
    and the rows no index names."""
    counts = torch.zeros(idx.shape[0], n, dtype=torch.int64, device=idx.device).scatter_add_(
        1, idx, torch.ones_like(idx))
    named = counts > 0
    return {"mean": counts[named].double().mean().item(), "max": int(counts.max()),
            "rows_unnamed": int((~named).sum()), "rows": counts.numel()}


def check_gather_bwd(g, idx, n, what):
    """The gather backward's two launches on one index: the run index equal
    to its twin's, the sum twice bit-equal, equal bit for bit to the CPU's
    sequential scatter_add (both add in ascending order), and within 1e-5
    of the scale of the card's own scatter_add (atomics).  Prints the
    index's run lengths.  Returns the largest absolute error against the
    card's scatter_add."""
    from deepclr_tpu_torch.ops import grouping

    perm, offsets = grouping.gather_bwd_index(idx, n)
    twin = grouping._gather_bwd_index_plain(idx, n, grouping.segment_length(n))
    index_equal = torch.equal(perm, twin[0]) and torch.equal(offsets, twin[1])
    got = grouping.gather_points_grad(g, idx, n)
    check_repeat(f"gather_bwd {what} {tuple(g.shape)} -> {n} rows", got, grouping.gather_points_grad(g, idx, n))
    equal_cpu = torch.equal(bits(got.cpu()), bits(grouping.gather_points_grad(g.cpu(), idx.cpu(), n)))
    ref = grouping._gather_points_grad_plain(g, idx, n)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    emit({"check": "gather_bwd", "what": what, "shape": list(g.shape), "rows": n, "runs": run_lengths(idx, n),
          "segment_length": grouping.segment_length(n), "index_equal_to_twin": index_equal,
          "equal_to_cpu": equal_cpu, "max_abs_err_vs_card_scatter_add": err, "scale": scale,
          "tolerance": 1e-5 * scale})
    if not index_equal or not equal_cpu or not err <= 1e-5 * scale:
        raise AssertionError(f"gather_bwd {what}: run index equal to its twin {index_equal}, equal to the CPU's "
                             f"scatter_add {equal_cpu}, {err} from the card's")
    return err


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
    check_repeat(f"fused_sa_bwd {dtype} dense 4 x 4096", got, fused_sa.fused_sa_bwd(sa_op, active, out, g))
    check_bwd_non_finite(sa_op, active, out, g, f"{dtype} dense 4 x 4096")
    out_a, jstar = fused_sa.fused_sa_argmax(sa_op, active)
    check_winner_grads_repeat(sa_op, jstar, g, f"{dtype} dense 4 x 4096")
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

    check_deterministic_micro_step(model, opt, loss_fn, metric_fns, batches[1], schedule(4))
    check_train_card_vs_cpu(dev)
    return model, opt, loss_fn, metric_fns, counts, argmax_counts, batches


def check_deterministic_micro_step(model, opt, loss_fn, metric_fns, batch, lr):
    """One flagship micro-step under torch.use_deterministic_algorithms(True),
    scoped and then restored, with the cuBLAS workspace setting that mode
    asks for: torch raises on any op of the path that has no deterministic
    form (the hand-written kernels sum in fixed orders themselves), and it
    must raise nothing."""
    from deepclr_tpu_torch.engine import create_train_state, make_train_step

    prev_mode, prev_cfg = torch.are_deterministic_algorithms_enabled(), os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        metrics = make_train_step(model, opt, loss_fn, metric_fns)(create_train_state(model), batch, lr)
        loss = float(metrics["loss"])
    finally:
        torch.use_deterministic_algorithms(prev_mode)
        if prev_cfg is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cfg
    emit({"check": "deterministic_algorithms_micro_step", "raised": False, "loss": loss})
    if not np.isfinite(loss):
        raise AssertionError(f"deterministic-algorithms micro-step: loss {loss}")


def check_train_card_vs_cpu(dev, tol=2e-3, fused=True):
    """One float32 micro-step on 2 pairs x 4096: every parameter's gradient
    on the card against the CPU (plain twins), within tol of its scale; the
    fused or the exact set abstraction."""
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG
    from deepclr_tpu_torch.synthetic import train_batch

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"].update(compute_dtype="float32", fused=fused)
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
          "fused": fused, "max_err_of_scale": worst, "tolerance": tol})
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
        "fused_sa_bwd_finish": finish_timing(sa_op, active, out, g),
    }
    scale = da_scale_timing(sa_op, active, out, g)
    kernels["gather_bwd"], kernels["gather_bwd_index"] = gather_bwd_timing(dev, model)
    dense = bwd_dense_timing(model, dev)
    metrics = {"train_micro_step_ms": micro_ms, "train_micro_step_ms_each": times, "bwd_dense": dense,
               "train_pairs_per_s": TRAIN_BATCH / (micro_ms / 1e3), "train_batch_pairs": TRAIN_BATCH,
               "train_accumulation_steps": 2, "train_in_radius_pairs": pairs,
               "train_in_radius_pairs_per_centre": pairs / (b * p),
               "train_visited_block_share": active.float().mean().item(),
               "train_culling": culling_counts(sa_op, active, pairs), "da_scale_kernel": scale,
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


def finish_timing(sa_op, active, out, g):
    """B4's second launch on B4's own workspace at the train path's shapes:
    its time, its plain twin's, and its bound (the workspace rows and the
    int64 da read once, da and the dW / db sums written once)."""
    from deepclr_tpu_torch.ops import fused_sa

    _, part, da_fx, da_state = fused_sa._bwd_first_launch(sa_op, active, out, g, fused_sa.KERNEL_WIDTHS)
    return dict(
        ms=kernel_ms(lambda: fused_sa.fused_sa_bwd_finish(part, da_fx, da_state), 50),
        device_ms=device_ms(lambda: fused_sa.fused_sa_bwd_finish(part, da_fx, da_state), 50),
        plain_ms=cuda_ms(lambda: fused_sa._fused_sa_bwd_finish_plain(part, da_fx, da_state), reps=5),
        bound=bound(nbytes(part, da_fx, da_state) + da_fx.numel() * 4 + fused_sa.PART_WIDTH * 4,
                    float(part.numel() + da_fx.numel())),
        library_ms=None, rows=part.shape[0])


def da_scale_timing(sa_op, active, out, g, reps=20):
    """B4's scale launch alone (da_scale_kernel, which B4's entry point
    launches first, one a B4 call): its device time a launch from
    torch.profiler over ``reps`` B4 first launches, and its bound (g read
    once, W2 and W3 read once for their row sums, the 16-byte state
    written).  It has no library counterpart."""
    from torch.profiler import ProfilerActivity, profile

    from deepclr_tpu_torch.ops import fused_sa

    launch = lambda: fused_sa._bwd_first_launch(sa_op, active, out, g, fused_sa.KERNEL_WIDTHS)  # noqa: E731
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "da_scale_kernel" in e.key]
    if len(rows) != 1 or rows[0].count != reps:
        raise AssertionError(f"da_scale timing: {[(e.key, e.count) for e in rows]} in the trace, not {reps} launches")
    w2, w3 = fused_sa._rounded_tail(sa_op)
    bound_ms, bound_by = bound(nbytes(g, w2, w3) + 16, float(g.numel()))
    return {"device_ms": rows[0].self_device_time_total / rows[0].count / 1e3, "launches_per_bwd": 1,
            "bound_ms": bound_ms, "bound_by": bound_by, "g_shape": list(g.shape), "library_ms": None}


def gather_bwd_case_timing(dev, g, idx, n):
    """The gather backward on one index: the wrapper back to back and on the
    device alone, each of its launches on the device alone, its bound (g
    and the indices read once, the rows written once), and the same sum by
    index_put_(accumulate=True) under torch.use_deterministic_algorithms(True)
    (the library's deterministic form), timed as the wrapper is."""
    from deepclr_tpu_torch.ops import grouping

    b, m, c = g.shape
    perm, offsets = grouping.gather_bwd_index(idx, n)
    flat_idx = (idx + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
    flat_g = g.reshape(-1, c)
    timing = dict(
        ms=kernel_ms(lambda: grouping.gather_points_grad(g, idx, n), 50),
        device_ms=device_ms(lambda: grouping.gather_points_grad(g, idx, n), 50),
        index_device_ms=device_ms(lambda: grouping.gather_bwd_index(idx, n), 50),
        sum_device_ms=device_ms(lambda: grouping.gather_bwd_sum(g, perm, offsets, n), 50),
        bound=bound(nbytes(g, idx) + b * n * c * 4, float(b * m * c)), shape=[b, m, n, c],
        runs=run_lengths(idx, n))
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        put = lambda: torch.zeros(b * n, c, device=dev).index_put_((flat_idx,), flat_g, accumulate=True)  # noqa: E731
        timing["deterministic_index_put_ms"] = kernel_ms(put, 20)
        timing["deterministic_index_put_device_ms"] = device_ms(put, 20)
    finally:
        torch.use_deterministic_algorithms(saved)
    timing["beats_index_put_on_device"] = timing["device_ms"] < timing["deterministic_index_put_device_ms"]
    timing["within_twice_bound"] = timing["device_ms"] <= 2 * timing["bound"][0]
    return timing


def gather_bwd_timing(dev, model):
    """The gather backward at MotionEmbedding's train shape: on the uniform
    index (the kernels line's figures) and on a ray-cast train batch's kNN
    index (gather_bwd_case_timing), the wrapper's plain twin (scatter_add_,
    atomics on the card), index_add_ over the flattened rows (atomics) and
    torch.gather's own backward under torch.use_deterministic_algorithms(True)
    on the uniform index; and the run-index launch alone against its twin
    (torch.sort and searchsorted a segment), with its bound (the int64
    index read once, perm and the offsets written once).  Returns the
    kernels line's rows of gather_bwd and gather_bwd_index."""
    from deepclr_tpu_torch.ops import grouping

    g, idx, n = gather_bwd_operands(dev)
    b, m, c = g.shape
    timing = gather_bwd_case_timing(dev, g, idx, n)
    # clones: the cached operands may be inference tensors (phase 3)
    rg, ridx, rn = (t.clone() if isinstance(t, torch.Tensor) else t for t in raycast_gather_operands(model, dev))
    raycast = gather_bwd_case_timing(dev, rg, ridx, rn)
    flat_idx = (idx + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
    timing.update(
        plain_ms=cuda_ms(lambda: grouping._gather_points_grad_plain(g, idx, n), reps=5),
        index_add_ms=cuda_ms(lambda: torch.zeros(b * n, c, device=dev).index_add_(0, flat_idx, g.reshape(-1, c)),
                             reps=5))
    x = torch.zeros(b, n, c, device=dev, requires_grad=True)
    gathered = torch.gather(x, 1, idx[..., None].expand(-1, -1, c))
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        fn = lambda: torch.autograd.grad(gathered, x, g, retain_graph=True)  # noqa: E731
        timing["deterministic_gather_backward_ms"] = kernel_ms(fn, 20)
        timing["deterministic_gather_backward_device_ms"] = device_ms(fn, 20)
    finally:
        torch.use_deterministic_algorithms(saved)
    timing["library_ms"] = timing["deterministic_index_put_ms"]
    lseg = grouping.segment_length(n)
    perm, offsets = grouping.gather_bwd_index(idx, n)
    index = dict(ms=kernel_ms(lambda: grouping.gather_bwd_index(idx, n), 50),
                 device_ms=timing["index_device_ms"],
                 plain_ms=cuda_ms(lambda: grouping._gather_bwd_index_plain(idx, n, lseg), reps=5),
                 bound=bound(nbytes(idx, perm, offsets), 0.0), library_ms=None, segment_length=lseg,
                 segments=offsets.shape[1])
    emit({"timing": "gather_bwd", "uniform": {k: v for k, v in timing.items() if k != "bound"},
          "raycast_knn": {k: v for k, v in raycast.items() if k != "bound"},
          "bound_ms": timing["bound"][0], "raycast_bound_ms": raycast["bound"][0],
          "library_ms_is": "index_put_(accumulate=True), deterministic",
          "index_launch": {k: v for k, v in index.items() if k != "bound"}, "index_bound_ms": index["bound"][0]})
    return timing, index


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


def write_scene_packs(tmp):
    """Phase 7's packs: two KITTI-like sequences and one pair pack.
    Returns the sequences' raw frames."""
    from deepclr_tpu_torch.data import PackWriter
    from deepclr_tpu_torch.synthetic import kitti_like_sequence

    frames = {}
    for k, seq in enumerate(("00", "01")):
        clouds, poses = kitti_like_sequence(SCENE_FRAMES, SCENE_POINTS, seed=60 + k)
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


def pred_labels(ev):
    """Normalised dual-quaternion labels of an Evaluator's predicted transforms, sequence by sequence."""
    from deepclr_tpu_torch.geometry import LabelType
    from deepclr_tpu_torch.geometry.hostmath import label_from_matrix_np

    return {name: label_from_matrix_np(LabelType.POSE3D_DUAL_QUAT, np.array(seq.prediction.transforms))
            for name, seq in ev.get_sequences().items()}


def label_err(a, b):
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        raise AssertionError(f"scenario: different sequences or row counts {a.keys()} / {b.keys()}")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def check_scenario_run(tag, ev, rows):
    """Rows a file, every written value finite, the step errors finite."""
    for name, n in rows.items():
        seq = ev.get_sequence(name)
        vals = np.array([[s, *p[:3].ravel(), *g[:3].ravel(), t] for s, p, g, t in
                         zip(seq.stamps, seq.prediction.transforms, seq.ground_truth.transforms, seq.times)])
        if vals.shape != (n, 26) or not np.isfinite(vals).all():
            raise AssertionError(f"scenario {tag} {name}: rows {vals.shape}, finite {np.isfinite(vals).all()}")
    total = ev.get_total_step_errors()
    errs = np.array([[x.translation.kitti, x.rotation.kitti, x.translation.rmse, x.rotation.chordal] for x in total])
    if len(total) != sum(rows.values()) or not np.isfinite(errs).all():
        raise AssertionError(f"scenario {tag}: {len(total)} step errors, finite {np.isfinite(errs).all()}")
    return {"step_t_kitti_mean_m": float(total.mean.translation.kitti),
            "step_r_kitti_mean_rad": float(total.mean.rotation.kitti)}


def check_lanes(model, frames):
    """A 2-lane BatchedSequentialHelper against two ModelInferenceHelpers
    seeded as its lanes; returns the largest label difference."""
    from deepclr_tpu_torch.models import BatchedSequentialHelper, ModelInferenceHelper

    batched = BatchedSequentialHelper(model, batch=2, num_points=NPTS, seed=0)
    singles = [ModelInferenceHelper(model, is_sequential=True, num_points=NPTS, seed=i) for i in range(2)]
    worst = 0.0
    for t in range(SCENE_FRAMES):
        fr = [frames["00"][t], frames["01"][t]]
        got = batched.step(fr)
        for i, single in enumerate(singles):
            ref = single.predict(fr[i])
            if (got[i] is None) != (ref is None) or (t == 0) != (ref is None):
                raise AssertionError(f"lanes: frame {t} lane {i}: {got[i]} vs {ref}")
            if ref is not None:
                worst = max(worst, float(np.abs(got[i] - ref).max()))
    return worst


def check_presorted(dev):
    """A presorted flagship model on the card against the same model on
    the CPU, 2 pairs x 4096 points (the host Morton-sorts them, the first
    stage skips its device sort)."""
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG
    from deepclr_tpu_torch.models import ModelInferenceHelper, build_model
    from deepclr_tpu_torch.synthetic import kitti_like

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["presorted"] = True
    t, s = kitti_like(2, 4096, seed=7), kitti_like(2, 4096, seed=8)
    ys = [ModelInferenceHelper(build_model(cfg, device=d, seed=0), num_points=4096).predict_batch(list(s), list(t))
          for d in (dev, "cpu")]
    return float(np.abs(ys[0] - ys[1]).max())


def check_float32_batch_invariance(dev, frames, pair_scen, quiet):
    """The flagship at compute_dtype float32: a 2-lane BatchedSequentialHelper
    against per-lane helpers, and 4 pairs a call against one, on phase 7's
    frames and pair pack."""
    from deepclr_tpu_torch import inference
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG
    from deepclr_tpu_torch.models import build_model

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["compute_dtype"] = "float32"
    model = build_model(cfg, device=dev, seed=0)
    runs = {b: inference.run_scenario(pair_scen, model, NPTS, "float32", b, quiet) for b in (1, 4)}
    return {"2_lanes_vs_per_lane_helpers": check_lanes(model, frames),
            "pairwise_4_vs_1_a_call": label_err(pred_labels(runs[4]), pred_labels(runs[1]))}


def run_scenario_phase(model, dev):
    """Phase 7, checks: the scenario path through inference.run_scenario.
    Returns the raw frames, the launch counts and (the sequential scenario,
    its 1-lane float32 Evaluator), which phase 9 scores."""
    from deepclr_tpu_torch import inference, ops
    from deepclr_tpu_torch.evaluation import scenario_from_dict

    quiet = logging.getLogger("chip_smoke.scenario")  # run_scenario's progress lines: warnings only
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        frames = write_scene_packs(tmp)
        packs_s = time.perf_counter() - t0
        seq_scen = scenario_from_dict({"name": "kitti_like_00-01", "dataset_type": "kitti_odometry_velodyne",
                                       "sequential": True, "data": {s: osp.join(tmp, f"{s}.pack") for s in frames}})
        pair_scen = scenario_from_dict({"name": "kitti_like_pairs", "dataset_type": "generic", "sequential": False,
                                        "data": {"08": osp.join(tmp, "08.pack")}})
        ops.reset_launch_counts()
        seq_runs = {(lanes, dt): inference.run_scenario(seq_scen, model, NPTS, dt, lanes, quiet)
                    for lanes in (1, 2) for dt in ("float32", "uint16")}
        pair_runs = {b: inference.run_scenario(pair_scen, model, NPTS, "float32", b, quiet) for b in (1, 4)}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        f32_errs = check_float32_batch_invariance(dev, frames, pair_scen, quiet)
    missing = [k for k in SERVING_KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"scenario inference: kernels {missing} never launched ({counts})")
    seq_rows = {s: SCENE_FRAMES - 1 for s in frames}
    step_errors = {f"{lanes}_lanes_{dt}": check_scenario_run(f"{lanes} lanes {dt}", ev, seq_rows)
                   for (lanes, dt), ev in seq_runs.items()}
    step_errors.update({f"pairwise_{b}_a_call": check_scenario_run(f"pairwise B={b}", ev, {"08": SCENE_PAIRS})
                        for b, ev in pair_runs.items()})
    errs = {f"uint16_vs_float32_{lanes}_lanes": label_err(pred_labels(seq_runs[(lanes, "uint16")]),
                                                          pred_labels(seq_runs[(lanes, "float32")]))
            for lanes in (1, 2)}
    errs["pairwise_4_vs_1_a_call"] = label_err(pred_labels(pair_runs[4]), pred_labels(pair_runs[1]))
    errs["2_lanes_vs_per_lane_helpers"] = check_lanes(model, frames)
    errs["presorted_card_vs_cpu"] = check_presorted(dev)
    emit({"check": "batch_invariance_float32", "max_abs_err": f32_errs, "tolerance": F32_BATCH_TOL})
    emit({"check": "scenario_inference", "frames": SCENE_FRAMES, "points_a_frame": SCENE_POINTS,
          "pair_points": PAIR_POINTS, "pairs": SCENE_PAIRS, "max_abs_err": errs, "tolerance": SCENE_TOL,
          "launches": counts, "step_errors": step_errors, "packs_written_s": packs_s,
          "yaml_loaded": "yaml" in sys.modules, "matplotlib_loaded": "matplotlib" in sys.modules,
          "seconds": time.perf_counter() - start})
    bad = {k: v for k, v in errs.items() if not v <= SCENE_TOL}
    bad.update({f"float32_{k}": v for k, v in f32_errs.items() if not v <= F32_BATCH_TOL})
    if bad:
        raise AssertionError(f"scenario inference: {bad} above {SCENE_TOL} (bf16) / {F32_BATCH_TOL} (float32)")
    return frames, counts, (seq_scen, seq_runs[(1, "float32")])


def host_split(model, dev, streams, upload_dtype, reps=6):
    """A sequential step's parts, each ended by a synchronise: the
    helper's pad/subsample, stack (+ quantise for uint16), upload (+ the
    device dequantisation), the device's encode_register, the fetch."""
    from deepclr_tpu_torch.models import BatchedSequentialHelper
    from deepclr_tpu_torch.models.base import device_batch, host_batch

    helper = BatchedSequentialHelper(model, batch=len(streams), num_points=NPTS, upload_dtype=upload_dtype)
    parts = {k: [] for k in ("pad_subsample", "stack_quantise", "upload", "device_step", "fetch")}
    state = None
    for t in range(reps + 2):
        clouds = [s[t % SCENE_FRAMES] for s in streams]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        padded = helper.pad(clouds)
        t1 = time.perf_counter()
        host = host_batch(padded, upload_dtype)
        t2 = time.perf_counter()
        pts, mask = device_batch(host, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if state is None:
            state = model.encode(pts, mask)
            continue
        y, state = model.encode_register(state, pts, mask)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        y.cpu().numpy()
        t5 = time.perf_counter()
        if t >= 2:  # the first step is a warm-up
            for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t4, t5))):
                parts[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def time_scenario(model, dev, frames, forward_pairs_per_s, card):
    """Phase 7, timing: sequential steps from raw frames at 1, 2 and 8
    lanes with their host split, and pairwise pairs/s from raw clouds."""
    from deepclr_tpu_torch.models import BatchedSequentialHelper, ModelInferenceHelper, pad_cloud
    from deepclr_tpu_torch.models.base import device_batch, host_batch

    start = time.perf_counter()
    seqs = list(frames.values())
    lanes_out = {}
    for lanes in SCENE_LANES:
        streams = [seqs[i % len(seqs)] for i in range(lanes)]
        for dt in ("float32", "uint16"):
            helper = BatchedSequentialHelper(model, batch=lanes, num_points=NPTS, upload_dtype=dt)
            each = []
            for t in range(SCENE_FRAMES):
                t0 = time.perf_counter()
                helper.step([s[t] for s in streams])  # returns host arrays: the fetch synchronises
                each.append((time.perf_counter() - t0) * 1e3)
            steady = each[2:]  # frame 0 only encodes; frame 1 is a warm-up
            med = statistics.median(steady)
            lanes_out[f"{lanes}_{dt}"] = {"lanes": lanes, "upload_dtype": dt, "step_ms_median": med,
                                          "per_lane_ms": med / lanes, "step_ms_each": steady,
                                          "host_split_ms": host_split(model, dev, streams, dt)}
    raw = seqs[0] + seqs[1]  # 16 raw 120000-point clouds
    helper = ModelInferenceHelper(model, num_points=NPTS)
    templates, sources = raw, raw[1:] + raw[:1]
    helper.predict_batch(sources, templates)
    calls = []
    for _ in range(5):
        t0 = time.perf_counter()
        helper.predict_batch(sources, templates)
        calls.append((time.perf_counter() - t0) * 1e3)
    # the call's host part: pad/subsample the 2B clouds, then one upload
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    padded = [pad_cloud(c, NPTS, rng) for c in templates + sources]
    t1 = time.perf_counter()
    device_batch(host_batch(padded, "float32"), dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    med = statistics.median(calls)
    emit({"scenario_timing": {
        "sequential_from_raw_frames": lanes_out, "points_a_frame": SCENE_POINTS, "num_points": NPTS,
        "pairwise_raw": {"pairs_a_call": len(raw), "call_ms_median": med, "call_ms_each": calls,
                         "pairs_per_s": len(raw) / (med / 1e3), "pad_subsample_2B_clouds_ms": (t1 - t0) * 1e3,
                         "stack_upload_2B_clouds_ms": (t2 - t1) * 1e3,
                         "device_resident_forward_pairs_per_s": forward_pairs_per_s},
        "seconds": time.perf_counter() - start}, "card": card})


def modelnet_model_cfg():
    """The model section of the shipped ModelNet40 recipe."""
    import yaml

    with open(osp.join(REPO, MODELNET_YAML)) as f:
        return yaml.safe_load(f)["model"]


def check_fwd_bwd(sa_op, active, tag):
    """B2 within 1e-5 of its twin's scale, and B4, fed B2's output, within
    1e-4 of each result's scale of its twin; returns the two largest
    absolute errors."""
    from deepclr_tpu_torch.ops import fused_sa

    out = fused_sa.fused_sa_core(sa_op, active)
    ref = fused_sa._fused_sa_plain(sa_op)
    fwd_err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    if not fwd_err <= 1e-5 * scale:
        raise AssertionError(f"fused_sa {tag}: max |diff| {fwd_err} > {1e-5 * scale}")
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(out.device)
    got = fused_sa.fused_sa_bwd(sa_op, active, out, g)
    want = fused_sa._fused_sa_bwd_plain(sa_op, ref, g)
    bwd_err = 0.0
    for name, x, y in zip(("da", "dbc", "dw2", "dw3", "db2", "db3"), [got[0], got[1], *got[2], *got[3]],
                          [want[0], want[1], *want[2], *want[3]]):
        err, bscale = (x - y).abs().max().item(), max(1e-3, y.abs().max().item())
        bwd_err = max(bwd_err, err)
        if not err <= 1e-4 * bscale:
            raise AssertionError(f"fused_sa_bwd {tag} {name}: max |diff| {err} > 1e-4 of the scale {bscale}")
    return fwd_err, bwd_err


def modelnet_clouds(n_clouds, seed):
    """CAD clouds of MN_POINTS points (xyz) on the unit sphere's scale."""
    from deepclr_tpu_torch.data.synthetic import cad_cloud

    rng = np.random.default_rng(seed)
    return np.stack([cad_cloud(rng, MN_POINTS)[:, :3] for _ in range(n_clouds)])


def check_modelnet_kernels(dev):
    """Phase 3, the ModelNet40 shape: B1, B3, B2 and B4 against their twins
    on 10 CAD clouds x 2048 points (unsorted, below SORT_MIN_POINTS) -> 512
    centres, radii 0.1 / 0.2, no point features, float32 and bfloat16."""
    from deepclr_tpu_torch.models import build_model
    from deepclr_tpu_torch.ops import fps, fused_sa

    model = build_model(modelnet_model_cfg(), device=dev, seed=0)
    pts = torch.from_numpy(modelnet_clouds(MN_CLOUDS, seed=70)).to(dev)
    op = sa_operands(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    if op["feats"] is not None or op["npoint"] != 512 or model.cloud_features._sa0.radii != (0.1, 0.2):
        raise AssertionError("ModelNet40 shape: expected no point features, 512 centres and radii 0.1 / 0.2")
    got = fps.furthest_point_sample(op["xyz"], op["npoint"], op["mask"])
    ref = fps._fps_plain(op["xyz"], op["npoint"], op["mask"])
    if not torch.equal(got, ref):
        raise AssertionError(f"fps ModelNet40 shape: {(got != ref).sum().item()} indices differ")
    pts4 = fused_sa._pack_points(op["xyz"], op["mask"])
    ref = fused_sa._block_min_d2_plain(pts4, op["centers"])
    r2max = max(model.cloud_features._sa0.radii) ** 2
    for got in (fused_sa.block_min_d2(pts4, op["centers"]),
                fused_sa.block_min_d2_and_cull(pts4, op["centers"], r2max)[0]):
        if not torch.equal(got, ref):
            raise AssertionError(f"min_d2 ModelNet40 shape: max |diff| {(got - ref).abs().max().item()}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        sa_op, active = fused_operands(op, dtype)
        errs[str(dtype)] = dict(zip(("fused_sa", "fused_sa_bwd"), check_fwd_bwd(sa_op, active, f"ModelNet40 {dtype}")))
        errs[str(dtype)]["in_radius_pairs_per_centre"] = pair_stats(sa_op)[0] / (MN_CLOUDS * op["npoint"])
    emit({"check": "kernels_modelnet40_shape", "clouds": MN_CLOUDS, "points": MN_POINTS, "npoint": op["npoint"],
          "fps_equal": True, "min_d2_equal": True, "max_abs_err": errs,
          "tolerance": {"fused_sa": "1e-5 of max(1, max|plain|)", "fused_sa_bwd": "1e-4 of each result's scale"}})


class TimedLoader:
    """A loader whose batches are timed as they are waited for: ``waits``
    (host ms inside next()), and for each full pass its ms a batch."""

    def __init__(self, loader):
        self.loader, self.waits, self.pass_ms_per_batch = loader, [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        t_pass, n = time.perf_counter(), 0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    if n:
                        self.pass_ms_per_batch.append((time.perf_counter() - t_pass) * 1e3 / n)
                    return
                self.waits.append((time.perf_counter() - t0) * 1e3)
                n += 1
                yield batch
        finally:
            it.close()  # an early stop ends the loader's prefetch thread and workers


class TrainerProbe:
    """Patches the trainer's factories for one train(cfg): its loaders
    become TimedLoaders, and each train and eval step is timed with CUDA
    events (device work and the host work the device waited for).  Also
    kept: each train step's kernel launches, and the model the train step
    was made for (the DistributedDataParallel wrapper under a process
    group)."""

    def __init__(self):
        self.loaders, self.step_ms, self.eval_ms, self.step_launches, self.stepped = {}, [], [], [], []

    def __enter__(self):
        from deepclr_tpu_torch.engine import trainer

        self._trainer = trainer
        self._saved = {k: getattr(trainer, k) for k in ("make_data_loader", "make_train_step", "make_eval_step")}

        def make_data_loader(cfg, is_train, **kw):
            loader = self._saved["make_data_loader"](cfg, is_train, **kw)
            if loader is None:
                return None
            self.loaders["train" if is_train else "val"] = timed = TimedLoader(loader)
            return timed

        def timed(make, sink, launches=None):
            from deepclr_tpu_torch import ops

            def factory(*args, **kw):
                if launches is not None:
                    self.stepped.append(args[0])
                fn = make(*args, **kw)

                def call(*a, **k):
                    before = ops.launch_counts()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*a, **k)
                    end.record()
                    end.synchronize()
                    sink.append(start.elapsed_time(end))
                    if launches is not None:
                        launches.append({n: c - before.get(n, 0) for n, c in ops.launch_counts().items()})
                    return out
                return call
            return factory

        trainer.make_data_loader = make_data_loader
        trainer.make_train_step = timed(self._saved["make_train_step"], self.step_ms, self.step_launches)
        trainer.make_eval_step = timed(self._saved["make_eval_step"], self.eval_ms)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            setattr(self._trainer, k, v)


def write_yaml_packs(tmp):
    """Phase 8's packs, as the repository's converters write them: KITTI
    sequences of ray-cast HDL-64 scans (every 2nd point kept) along a
    driven path, and ModelNet40 model stores of CAD clouds reduced to 2048
    points by host FPS.  Returns the seconds each took."""
    from concurrent.futures import ThreadPoolExecutor

    from deepclr_tpu_torch.data import PackWriter
    from deepclr_tpu_torch.data.synthetic import cad_cloud, drive
    from deepclr_tpu_torch.data.transforms import FarthestPointSampling, SystematicErasing

    kitti, modelnet = osp.join(tmp, "kitti", "odometry"), osp.join(tmp, "modelnet40", "models")
    os.makedirs(kitti)
    os.makedirs(modelnet)

    def sequence(k, seq, frames):
        erase = SystematicErasing(2)
        with PackWriter(osp.join(kitti, f"{seq}.pack")) as w:
            for i, (pose, scan) in enumerate(drive(np.random.default_rng(1000 + k), frames, SCAN_POINTS)):
                w.put(f"{i:08d}", erase({"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan}))

    def model_record(seed):
        return FarthestPointSampling(MN_POINTS)({"idx": seed, "cloud": cad_cloud(np.random.default_rng(seed),
                                                                                    MN_RAW_POINTS)})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        done = [pool.submit(sequence, k, seq, n) for k, (seq, n) in enumerate(KITTI_SEQUENCES.items())]
        for f in done:
            f.result()
        t1 = time.perf_counter()
        for name, seeds in (("train", range(MN_TRAIN)), ("test_seen", range(100, 100 + MN_TEST))):
            with PackWriter(osp.join(modelnet, f"{name}.pack")) as w:
                for i, rec in enumerate(pool.map(model_record, seeds)):
                    w.put(f"{i:08d}", rec)
    return {"kitti_packs_s": t1 - t0, "modelnet40_packs_s": time.perf_counter() - t1}


def train_from_yaml(tmp, name, shipped, iterations, checkpoint=None):
    """Write a YAML that extends the shipped recipe (never written) and
    overrides only the iteration count and the logging periods, then
    train(cfg) in this process under a TrainerProbe.  Returns (cfg, probe,
    launches, seconds)."""
    import yaml

    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.config import Mode, load_config
    from deepclr_tpu_torch.engine import trainer

    path = osp.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"extends": osp.join(REPO, shipped), "optimizer": {"max_iterations": iterations},
                        "logging": {"summary_period": 2, "log_period": 2, "checkpoint_period": 4,
                                    "validation_period": 4}}, f)
    cfg = load_config(path, Mode.NEW if checkpoint is None else Mode.CONTINUE, ckpt_filename=checkpoint)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with TrainerProbe() as probe:
        state = trainer.train(cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if state.step != iterations:
        raise AssertionError(f"{name}: {state.step} micro-steps, expected {iterations}")
    missing = [k for k in TRAIN_KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} never launched ({counts})")
    return cfg, path, probe, counts, time.perf_counter() - t0


def check_run_dir(cfg, name, iterations, sequential):
    """The JAX artifact set, and the tags' values finite."""
    run_dir = cfg.output_dir
    for f in ("config.yaml", "model_config.yaml", "scalars.jsonl", f"ckpt_final_{iterations}.pt",
              osp.join("models", "deepclr.py")):
        if not osp.exists(osp.join(run_dir, f)):
            raise AssertionError(f"{name}: {f} missing in the run directory")
    for link in ("ckpt.pt", "weights.pt"):
        if not osp.islink(osp.join(run_dir, link)):
            raise AssertionError(f"{name}: {link} is not a link")
    tags = {}
    with open(osp.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    want = ["train/loss", "params/lr", "val/loss_fn", "val/step_t_err"] + (["val/kitti_t_err"] if sequential else [])
    bad = {t: tags.get(t) for t in want if not tags.get(t) or not np.isfinite(tags[t]).all()}
    if bad:
        raise AssertionError(f"{name}: tags missing or not finite: {bad}")
    return {t: tags[t] for t in want}


def infer_from_run_dir(run_dir, scen, rows, quiet):
    """The run directory as a model directory: its model_config.yaml and
    weights.pt through inference.run_scenario.  Returns the checks and the
    Evaluator."""
    from deepclr_tpu_torch import inference
    from deepclr_tpu_torch.config import load_model_config
    from deepclr_tpu_torch.models import load_trained_model

    weights = osp.join(run_dir, "weights.pt")
    with torch.inference_mode():
        model = load_trained_model(load_model_config(osp.join(run_dir, "model_config.yaml"), weights), weights)
        ev = inference.run_scenario(scen, model, logger=quiet)
    return check_scenario_run(osp.basename(run_dir), ev, rows), ev


def loader_rates(cfg, source):
    """Training batches a second from the loader alone, over ``source``:
    0 workers, 6 threads, 6 spawned processes (one epoch each; the first
    batch's wait holds a process pool's start-up)."""
    from deepclr_tpu_torch.data import DataLoader

    out = {}
    for workers, kind in ((0, "thread"), (6, "thread"), (6, "process")):
        cfg.defrost()
        cfg.data_loader.num_workers, cfg.data_loader.worker_type = workers, kind
        cfg.freeze()
        loader = TimedLoader(DataLoader(cfg, True, source=source))
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        total = time.perf_counter() - t0
        out[f"{workers}_{kind}"] = {"batches": n, "batches_per_s": n / total, "first_batch_ms": loader.waits[0],
                                    "batches_per_s_after_first": (n - 1) / (total - loader.waits[0] / 1e3)}
    return out


def density_kernels(model, batch, dev, tag):
    """B1-B4 on one training batch of the path (2B clouds): B2 and B4
    against their twins (check_fwd_bwd), device time, bound, and the counts
    the fused kernels' design rests on; B4's scale launch alone; the gather
    backward at MotionEmbedding's kNN index of the batch's centres, gated
    as in phase 3 (check_gather_bwd), with its runs."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.ops import fps, fused_sa

    both = torch.cat([torch.from_numpy(batch["template"]), torch.from_numpy(batch["source"])]).to(dev)
    mask = torch.cat([torch.from_numpy(batch["template_mask"]), torch.from_numpy(batch["source_mask"])]).to(dev)
    with torch.no_grad():
        op = sa_operands(model, both, mask)
        sa_op, active = fused_operands(op, model.cloud_features._sa0.compute_dtype)
        out = fused_sa.fused_sa_core(sa_op, active)
        fwd_err, bwd_err = check_fwd_bwd(sa_op, active, tag)
    g = torch.randn_like(out)
    pairs, points_hit = pair_stats(sa_op)
    b, n, p = op["xyz"].shape[0], op["xyz"].shape[1], op["npoint"]
    min_d2 = fused_sa.block_min_d2(sa_op.pts4, sa_op.centers)
    rows = {
        "fps": (lambda: fps.furthest_point_sample(op["xyz"], p, op["mask"]),
                bound(nbytes(op["xyz"], op["mask"]) + b * p * 4, 9.0 * b * (p - 1) * n)),
        "min_d2": (lambda: fused_sa.block_min_d2_and_cull(sa_op.pts4, sa_op.centers, sa_op.r2max),
                   bound(nbytes(sa_op.pts4, sa_op.centers, min_d2, active), min_d2_ops(sa_op.pts4, p))),
        "fused_sa": (lambda: fused_sa.fused_sa_core(sa_op, active), bound(*sa_work(sa_op, active, pairs, points_hit))),
        "fused_sa_bwd": (lambda: fused_sa.fused_sa_bwd(sa_op, active, out, g),
                         bwd_bound(sa_op, active, out, g, pairs, points_hit)),
    }
    # MotionEmbedding's gather backward at this batch's kNN index
    gg, gidx, gn = motion_gather_operands(model, op["centers"], seed=73)
    gather_err = check_gather_bwd(gg, gidx, gn, f"{tag} kNN")
    rows["gather_bwd"] = (lambda: ops.gather_points_grad(gg, gidx, gn),
                          bound(nbytes(gg, gidx) + gidx.shape[0] * gn * gg.shape[2] * 4, float(gg.numel())))
    kernels = {k: {"device_ms": device_ms(fn, 20), "bound_ms": bd[0], "bound_by": bd[1]}
               for k, (fn, bd) in rows.items()}
    kernels["gather_bwd"]["runs"] = run_lengths(gidx, gn)
    kernels["da_scale_kernel"] = da_scale_timing(sa_op, active, out, g)
    return {"clouds": b, "points": n, "npoint": p, "kernels": kernels, "gather_bwd_max_abs_err": gather_err,
            "max_abs_err": {"fused_sa": fwd_err, "fused_sa_bwd": bwd_err}, "in_radius_pairs": pairs,
            "in_radius_pairs_per_centre": pairs / (b * p), "culling": culling_counts(sa_op, active, pairs)}


def run_yaml_training_phase(dev, card):
    """Phase 8: training from the shipped YAMLs on ray-cast KITTI and CAD
    ModelNet40 packs, a resume, inference from the run directory, and the
    timing of the loader, the micro-step, validation and the timing CLI.
    Returns (the 04 scenario, the Evaluator of the inference from the KITTI
    run directory), which phase 9 scores, and a ray-cast KITTI training
    batch with the trained weights, for phase 10's drift report."""
    import io

    from deepclr_tpu_torch import timing
    from deepclr_tpu_torch.config import Mode, load_config
    from deepclr_tpu_torch.data import make_data_loader
    from deepclr_tpu_torch.evaluation import scenario_from_dict
    from deepclr_tpu_torch.models import build_model

    quiet = logging.getLogger("chip_smoke.scenario")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        packs_s = write_yaml_packs(tmp)
        env = {"KITTI_PATH": osp.join(tmp, "kitti"), "MODELNET40_PATH": osp.join(tmp, "modelnet40"),
               "MODEL_PATH": osp.join(tmp, "models")}
        saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            cfg, path, probe, counts, train_s = train_from_yaml(tmp, "kitti", KITTI_YAML, 8)
            kitti_tags = check_run_dir(cfg, "kitti", 8, sequential=True)
            resumed, _, _, resume_counts, resume_s = train_from_yaml(tmp, "kitti_resume", KITTI_YAML, 12,
                                                                     osp.join(cfg.output_dir, "ckpt.pt"))
            check_run_dir(resumed, "kitti resumed", 12, sequential=True)
            val_pack = osp.join(tmp, "kitti", "odometry", "04.pack")
            kitti_scen = scenario_from_dict({"name": "synth_04", "dataset_type": "kitti_odometry_velodyne",
                                             "sequential": True, "data": {"04": val_pack}})
            kitti_infer, kitti_ev = infer_from_run_dir(cfg.output_dir, kitti_scen, {"04": KITTI_SEQUENCES["04"] - 1},
                                                       quiet)

            mcfg, _, mprobe, mcounts, mtrain_s = train_from_yaml(tmp, "modelnet40", MODELNET_YAML, 8)
            modelnet_tags = check_run_dir(mcfg, "modelnet40", 8, sequential=False)
            mn_scen = scenario_from_dict({"name": "synth_seen", "dataset_type": "modelnet40", "sequential": False,
                                          "data": {"test_seen": osp.join(tmp, "modelnet40", "models",
                                                                         "test_seen.pack")}})
            mn_infer, _ = infer_from_run_dir(mcfg.output_dir, mn_scen, {"test_seen": MN_TEST}, quiet)
            checks_s = time.perf_counter() - start
            emit({"check": "yaml_training", "kitti": {"tags": kitti_tags, "launches_8_micro_steps": counts,
                                                      "launches_resumed_4_micro_steps": resume_counts,
                                                      "inference_from_run_dir": kitti_infer,
                                                      "train_s": train_s, "resume_s": resume_s},
                  "modelnet40": {"tags": modelnet_tags, "launches_8_micro_steps": mcounts,
                                 "inference_from_run_dir": mn_infer, "train_s": mtrain_s},
                  "packs_s": packs_s, "seconds": checks_s})

            # timing: the loader alone, the micro-step and validation of the
            # first KITTI run, the timing CLI, the kernels at this density
            t0 = time.perf_counter()
            test_cfg = load_config(path, Mode.TEST)
            rates = loader_rates(load_config(path, Mode.TEST), val_pack)
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                times = timing.timing(test_cfg, sequential=True)
            lines = printed.getvalue().splitlines()
            if len(lines) != len(times["wall_ms"]) + 3 or len(times["wall_ms"]) != KITTI_SEQUENCES["04"] - 1:
                raise AssertionError(f"timing: {len(lines)} lines for {len(times['wall_ms'])} pairs")
            batch = next(iter(make_data_loader(test_cfg, True)))
            raycast = {"batch": batch, "weights_from": "phase 8's KITTI run (12 micro-steps)",
                       "model_cfg": test_cfg.model.to_dict(),
                       "weights": torch.load(osp.join(resumed.output_dir, "weights.pt"), map_location="cpu",
                                             weights_only=True)}
            kitti_model = build_model(test_cfg.model, device=dev, seed=0)
            mn_cfg = load_config(osp.join(tmp, "modelnet40.yaml"), Mode.TEST)
            mn_batch = next(iter(make_data_loader(mn_cfg, True)))
            dens = {"kitti_raycast": density_kernels(kitti_model, batch, dev, "ray-cast KITTI batch"),
                    "modelnet40": density_kernels(build_model(mn_cfg.model, device=dev, seed=0), mn_batch, dev,
                                                  "ModelNet40 batch")}
            steps, waits = probe.step_ms[2:], probe.loaders["train"].waits[2:]  # 2 warm-up micro-steps
            emit({"yaml_training_timing": {
                "loader_alone_5x16384_from_60000_point_frames": rates,
                "kitti_micro_step": {"train_step_ms_median": statistics.median(steps), "train_step_ms_each": steps,
                                     "loader_wait_ms_median": statistics.median(waits), "loader_wait_ms_each": waits},
                "kitti_validation": {"eval_step_ms_median": statistics.median(probe.eval_ms),
                                     "ms_per_batch_with_loader": probe.loaders["val"].pass_ms_per_batch,
                                     "batches": len(probe.loaders["val"])},
                "modelnet40_micro_step_ms_median": statistics.median(mprobe.step_ms[2:]),
                "modelnet40_loader_wait_ms_median": statistics.median(mprobe.loaders["train"].waits[2:]),
                "timing_cli_sequential": {"frames": len(times["wall_ms"]),
                                          "wall_ms_median": statistics.median(times["wall_ms"][1:]),
                                          "compute_ms_median": statistics.median(times["compute_ms"][1:]),
                                          "summary": lines[-3:]},
                "kernels_at_path_density": dens, "seconds": time.perf_counter() - t0}, "card": card})
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    seconds = time.perf_counter() - start
    emit({"phase": "yaml_training", "seconds": seconds})
    return (kitti_scen, kitti_ev), raycast


def write_run_dir(base, scen, method, params, ev):
    """A run directory as the inference and ICP CLIs write it:
    {stamp}_{scenario}_{METHOD}/ with scenario.yaml (its method entry) and
    one 26-column file a sequence."""
    import yaml

    run_dir = osp.join(base, f"{time.strftime('%Y%m%d_%H%M%S')}_{scen.name}_{method}")
    os.makedirs(run_dir)
    with open(osp.join(run_dir, "scenario.yaml"), "w") as f:
        yaml.dump({**scen.to_dict(), "method": {"name": method, "params": params}}, f, default_flow_style=False,
                  sort_keys=False)
    ev.write(run_dir)
    return run_dir


def write_icp_pack(path, frames, seed):
    """A KITTI sequence pack as the converter writes it: ray-cast HDL-64
    scans of SCAN_POINTS along a driven path, every 2nd point kept."""
    from deepclr_tpu_torch.data import PackWriter
    from deepclr_tpu_torch.data.synthetic import drive
    from deepclr_tpu_torch.data.transforms import SystematicErasing

    erase = SystematicErasing(2)
    with PackWriter(path) as w:
        for i, (pose, scan) in enumerate(drive(np.random.default_rng(seed), frames, SCAN_POINTS)):
            w.put(f"{i:08d}", erase({"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan}))


def motion_errors(pred, gt):
    """Translation [m] and rotation [deg] of inv(gt) @ pred."""
    err = np.linalg.inv(gt) @ pred
    cos = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(err[:3, 3])), float(np.degrees(np.arccos(cos)))


def icp_cut_check(pairs, algorithm):
    """The algorithm on a seeded ICP_CUT_POINTS-point cut of every pair, on
    the card and on the CPU.  Returns, a pair, the largest transform
    difference, both iteration counts, and whether both runs converged
    (stopped below epsilon before the iteration cap).  A run that hits the
    cap has not settled on a transform: its 100th iterate carries the
    rounding differences of every step, so only converged pairs are held to
    the tolerance."""
    from deepclr_tpu_torch.icp import ICPRegistration

    out = {}
    for device in ("cuda", "cpu"):
        reg = ICPRegistration(algorithm, max_distance=ICP_MAX_DISTANCE, device=device)
        out[device] = [reg.register(reg.prepare(t), reg.prepare(s), return_info=True) for t, s in pairs]
    return [{"max_abs_err": float(np.abs(a[0] - b[0]).max()), "iterations_card": a[1]["iterations"],
             "iterations_cpu": b[1]["iterations"],
             "converged": max(a[1]["iterations"], b[1]["iterations"]) < ICP_MAX_ITERATIONS}
            for a, b in zip(out["cuda"], out["cpu"])]


def run_icp_phase(dev, card, deepclr_runs):
    """Phase 9: the ICP baselines through the ICP CLI's function on a
    ray-cast KITTI sequence at full density, scored with the DeepCLR runs of
    phases 7 and 8 (``deepclr_runs``: tag -> (scenario, Evaluator)) by the
    evaluation CLI and the devkit, with pandas and matplotlib absent."""
    from deepclr_tpu_torch.data import create_input_dataflow
    from deepclr_tpu_torch.evaluation import Evaluator, scenario_from_dict
    from deepclr_tpu_torch.evaluation import cli as evaluation_cli
    from deepclr_tpu_torch.icp import cli as icp_cli
    from deepclr_tpu_torch.icp import knn_block_size
    from deepclr_tpu_torch.kitti_devkit.__main__ import main as devkit_main

    quiet = logging.getLogger("chip_smoke.scenario")
    start = time.perf_counter()
    hidden = {m: sys.modules.get(m) for m in ("pandas", "matplotlib")}
    installed = {m: importlib.util.find_spec(m) is not None for m in hidden}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pack = osp.join(tmp, "00.pack")
        write_icp_pack(pack, ICP_FRAMES, seed=1100)
        pack_s = time.perf_counter() - t0
        scen = scenario_from_dict({"name": "kitti_icp_synth", "dataset_type": "kitti_odometry_velodyne",
                                   "sequential": True, "data": {"00": pack}})
        pairs = [(ds["clouds"][0][:, :3], ds["clouds"][1][:, :3], ds["transform"])
                 for ds in create_input_dataflow(scen.dataset_type, pack, shuffle=False)]
        n_points = [c.shape[0] for c, _, _ in pairs] + [pairs[-1][1].shape[0]]
        runs_dir = osp.join(tmp, "runs")
        os.makedirs(runs_dir)
        results, run_dirs, bad = {}, {}, []
        for algorithm in ICP_ALGORITHMS:
            infos = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            run_dirs[algorithm] = icp_cli.run(scen, algorithm, runs_dir, max_distance=ICP_MAX_DISTANCE,
                                              device=dev, logger=quiet, infos=infos)
            wall_s = time.perf_counter() - t0
            ev = Evaluator.read(run_dirs[algorithm], ["00.txt"])
            seq = ev.get_sequence("00")
            times = list(seq.times)
            errs = [motion_errors(p, g) for p, g in zip(seq.prediction.transforms, seq.ground_truth.transforms)]
            se3_err = max(max(float(np.abs(m[:3, :3] @ m[:3, :3].T - np.eye(3)).max()),
                              float(np.abs(m[3] - [0, 0, 0, 1]).max())) for m in seq.prediction.transforms)
            iterations = [i["iterations"] for i in infos]
            rng = np.random.default_rng(91)
            cut = []
            for t, s, _ in pairs:
                cut.append((t[rng.choice(t.shape[0], ICP_CUT_POINTS, replace=False)],
                            s[rng.choice(s.shape[0], ICP_CUT_POINTS, replace=False)]))
            cut_pairs = icp_cut_check(cut, algorithm)
            held = [c for c in cut_pairs if c["converged"]]
            results[algorithm] = {
                "pairs": len(times), "ms_a_pair_median": statistics.median(times), "ms_a_pair_each": times,
                "host_read_share": sum(i["host_read_ms"] for i in infos) / sum(times),
                "loop_share": sum(i["loop_ms"] for i in infos) / sum(times),
                "device_busy_share_of_loop": sum(i["device_ms"] for i in infos) / sum(i["loop_ms"] for i in infos),
                "iterations_each": iterations, "final_delta_each": [i["final_delta"] for i in infos],
                "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "memory_allocated_before_bytes": before,
                "translation_err_m_each": [e[0] for e in errs], "rotation_err_deg_each": [e[1] for e in errs],
                "se3_max_abs_err": se3_err, "card_vs_cpu_cut": cut_pairs, "wall_s": wall_s}
            if len(times) != ICP_FRAMES - 1 or not all(np.isfinite(m).all() for m in seq.prediction.transforms):
                bad.append(f"{algorithm}: {len(times)} rows or non-finite transforms")
            if not se3_err <= 1e-4:
                bad.append(f"{algorithm}: not SE(3): {se3_err}")
            if max(iterations) > ICP_MAX_ITERATIONS:
                bad.append(f"{algorithm}: iterations {iterations}")
            off = [c for c in held if not c["max_abs_err"] <= ICP_TOL[algorithm]
                   or abs(c["iterations_card"] - c["iterations_cpu"]) > 1]
            if off or not held:
                bad.append(f"{algorithm}: card vs CPU at {ICP_CUT_POINTS} points over {ICP_TOL[algorithm]} or "
                           f"iterations apart on converged pairs (or none converged): {cut_pairs}")

        emit({"check": "icp", "frames": ICP_FRAMES, "frames_cut_from": "a drive's length, points never",
              "points_a_frame": n_points, "max_distance": ICP_MAX_DISTANCE,
              "knn_block": knn_block_size(max(n_points)), "tolerance": ICP_TOL, "cut_points": ICP_CUT_POINTS,
              "algorithms": results, "pack_s": pack_s, "card": card})
        if bad:
            raise AssertionError(f"ICP: {'; '.join(bad)}")

        # score: the evaluation CLI on every run, alone and as one scenario, and the devkit
        for tag, (deepclr_scen, deepclr_ev) in deepclr_runs.items():
            run_dirs[tag] = write_run_dir(osp.join(runs_dir, tag), deepclr_scen, "DEEPCLR", {"phase": tag},
                                          deepclr_ev)
        t0 = time.perf_counter()
        sys.modules.update({m: None for m in hidden})  # as on a machine without them
        try:
            for run_dir in run_dirs.values():
                evaluation_cli.main([run_dir])
            evaluation_cli.main([runs_dir, "--scenario", scen.name])
            devkit = {tag: score_with_devkit(run_dir, devkit_main) for tag, run_dir in run_dirs.items()}
        finally:
            for m, mod in hidden.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        scoring_s = time.perf_counter() - t0
        tables = {}
        for tag, run_dir in run_dirs.items():
            for name in ("step_errors.csv", "segment_errors.csv"):
                tables[f"{tag}/{name}"] = read_csv(osp.join(run_dir, "evaluation", name))
        multi = osp.join(runs_dir, "evaluation", scen.name, f"{scen.name}_step_errors.csv")
        tables["multi_run/step_errors.csv"] = read_csv(multi)
        # a segment table is finite where its drives reach the shortest KITTI segment (100 m): phase 8's 04
        bad = {k: v for k, v in tables.items() if ("step_errors" in k or "phase8" in k) and not v["finite"]}
        if bad or len(tables["multi_run/step_errors.csv"]["rows"]) != len(ICP_ALGORITHMS):
            raise AssertionError(f"evaluation CLI: error tables not finite or incomplete: {tables}")
    emit({"check": "icp_scoring", "tables": tables, "devkit_sequences": devkit, "scoring_s": scoring_s,
          "installed": installed})
    seconds = time.perf_counter() - start
    emit({"phase": "icp", "seconds": seconds})
    return seconds


def score_with_devkit(run_dir, devkit_main):
    """The run's ground-truth and predicted poses as KITTI pose files, then
    the devkit CLI on them; returns its sequence count."""
    from deepclr_tpu_torch.evaluation import Evaluator

    gt_dir, pred_dir = osp.join(run_dir, "kitti_gt"), osp.join(run_dir, "kitti_pred")
    os.makedirs(gt_dir)
    os.makedirs(pred_dir)
    names = sorted(f[:-4] for f in os.listdir(run_dir) if f.endswith(".txt"))
    long_enough = 0  # the devkit evaluates a sequence that holds a 100 m segment
    for name, seq in Evaluator.read(run_dir, [f"{n}.txt" for n in names]).get_sequences().items():
        seq.ground_truth.write(osp.join(gt_dir, f"{name}.txt"), use_poses=True)
        seq.prediction.write(osp.join(pred_dir, f"{name}.txt"), use_poses=True)
        long_enough += seq.ground_truth.distances[-1] > 100.0
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        n = devkit_main([gt_dir, pred_dir])
    if n != long_enough or not osp.exists(osp.join(pred_dir, "result", "stats.txt")):
        raise AssertionError(f"devkit: {n} sequences of {names} in {run_dir}, {long_enough} reach 100 m")
    return n


def read_csv(path):
    """A table the evaluation CLI wrote: its rows, and whether every number in it is finite."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    values = [v for r in rows for k, v in r.items() if k not in ("name", "method", "params")]
    return {"rows": [r["name"] for r in rows], "finite": all(v != "" and np.isfinite(float(v)) for v in values),
            "empty_fields": sum(v == "" for v in values)}


EXACT_SCALES = ((0.5, 512), (1.0, 1024))  # the flagship's (radius, nsample) pairs, KITTI_MODEL_CFG
BOUNDARY_M2 = 1e-3            # a ball with a point this close to r^2 may differ between devices
VARIANT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DENSE_NSAMPLE = 64            # the dense cube at r = 1.0 (~190 points a ball): truncation bites


def exact_cfg(compute_dtype="bfloat16"):
    """The flagship KITTI configuration with fused: False (the exact path)."""
    from deepclr_tpu_torch.configs import KITTI_MODEL_CFG

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"].update(fused=False, compute_dtype=compute_dtype)
    return cfg


def ball_stats(xyz, centres, radius, mask, block=64):
    """Per ball, by exact float64 distances: the points inside, and whether
    a valid point lies within BOUNDARY_M2 of r^2 (where the expanded float32
    form may put it on either side)."""
    counts, ambiguous = [], []
    for lo in range(0, centres.shape[1], block):
        d2 = ((centres[:, lo:lo + block, None].double() - xyz[:, None].double()) ** 2).sum(-1)
        valid = mask[:, None] if mask is not None else torch.ones_like(d2, dtype=torch.bool)
        counts.append(((d2 < radius * radius) & valid).sum(-1))
        ambiguous.append((((d2 - radius * radius).abs() < BOUNDARY_M2) & valid).any(-1))
    return torch.cat(counts, 1), torch.cat(ambiguous, 1)


def compare_ball_query(tag, xyz, centres, mask, scales, dev):
    """ops.ball_query_scales on the card against the same on the CPU: the
    indices equal on every ball without a boundary point."""
    from deepclr_tpu_torch import ops

    card = ops.ball_query_scales(xyz, centres, [r for r, _ in scales], [n for _, n in scales], mask)
    cpu = ops.ball_query_scales(xyz.cpu(), centres.cpu(), [r for r, _ in scales], [n for _, n in scales],
                                None if mask is None else mask.cpu())
    out = {}
    for (radius, nsample), got, ref in zip(scales, card, cpu):
        counts, ambiguous = ball_stats(xyz, centres, radius, mask)
        differ = (got.cpu() != ref).any(-1)
        bad = differ & ~ambiguous.cpu()
        out[f"r{radius}_nsample{nsample}"] = {
            "balls": differ.numel(), "balls_differ": int(differ.sum()), "balls_near_boundary": int(ambiguous.sum()),
            "differ_off_boundary": int(bad.sum()), "largest_ball": int(counts.max()),
            "truncated_balls": int((counts > nsample).sum()), "empty_balls": int((counts == 0).sum())}
        if bad.any():
            raise AssertionError(f"ball query {tag} r={radius}: {int(bad.sum())} balls without a boundary point "
                                 "differ between card and CPU")
    return out


def check_ball_query(dev):
    """Phase 10a: the flagship's scales at full width (32 clouds x 16384 ->
    1024 FPS centres, a masked tail, an all-masked cloud) and the dense
    cube at nsample 64, card against CPU."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.synthetic import kitti_like

    xyz = torch.from_numpy(kitti_like(2 * BATCH, NPTS, seed=70)[..., :3]).to(dev)
    mask = torch.ones(2 * BATCH, NPTS, dtype=torch.bool, device=dev)
    mask[1, NPTS * 3 // 4:] = False
    mask[3] = False
    centres = ops.gather_points(xyz, ops.furthest_point_sample(xyz, 1024, mask))
    dense = torch.from_numpy(dense_clouds(10)[..., :3]).to(dev)
    dense_centres = ops.gather_points(dense, ops.furthest_point_sample(dense, 1024))
    return {f"kitti_like_{2 * BATCH}x{NPTS}": compare_ball_query("kitti-like", xyz, centres, mask, EXACT_SCALES, dev),
            "dense_10x4096": compare_ball_query("dense", dense, dense_centres, None, ((1.0, DENSE_NSAMPLE),), dev)}


def morton_sorted(batch):
    """A padded batch with each cloud's valid points (a prefix) Morton-sorted
    on the host, as ModelInferenceHelper sorts for a presorted model."""
    from deepclr_tpu_torch.ops import morton_argsort_np

    out = dict(batch)
    for key in ("template", "source"):
        clouds, mask = batch[key].copy(), batch[f"{key}_mask"]
        for i in range(len(clouds)):
            n = int(mask[i].sum())
            if not mask[i, :n].all():
                raise AssertionError("morton_sorted: the valid points are not a prefix")
            clouds[i, :n] = clouds[i, :n][morton_argsort_np(clouds[i, :n, :3])]
        out[key] = clouds
    return out


def raycast_drift(fused_f32, exact_f32, batch, dev):
    """scripts/parity_fused_exact.py's report on one ray-cast KITTI batch:
    the same weights through the fused and the exact path at float32, the
    pose outputs' drift and each path's error against the labels."""
    from deepclr_tpu_torch.geometry import LabelType, hostmath

    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if k in (
        "template", "source", "template_mask", "source_mask", "aug_template", "aug_source")}
    args = [b.get(k) for k in ("template", "source", "template_mask", "source_mask", "aug_template", "aug_source")]
    y_f = fused_f32(*args)[0].float().cpu().numpy()
    y_e = exact_f32(*args)[0].float().cpu().numpy()
    rows = []
    for j in range(len(y_f)):
        m_f, m_e, m_gt = (hostmath.label_to_matrix_np(LabelType.POSE3D_DUAL_QUAT, v[j])
                          for v in (y_f, y_e, batch["y"]))

        def rot_deg(m1, m2):
            c = np.clip((np.trace(m1[:3, :3] @ m2[:3, :3].T) - 1.0) / 2.0, -1.0, 1.0)
            return float(np.degrees(np.arccos(c)))

        rows.append({"dy_fused_exact": float(np.abs(y_f[j] - y_e[j]).max()),
                     "dt_fused_exact": float(np.linalg.norm(m_f[:3, 3] - m_e[:3, 3])),
                     "dr_fused_exact": rot_deg(m_f, m_e),
                     "t_err_fused": float(np.linalg.norm(m_f[:3, 3] - m_gt[:3, 3])),
                     "t_err_exact": float(np.linalg.norm(m_e[:3, 3] - m_gt[:3, 3])),
                     "r_err_fused": rot_deg(m_f, m_gt), "r_err_exact": rot_deg(m_e, m_gt)})
    return {k: {"mean": float(np.mean([r[k] for r in rows])), "max": float(np.max([r[k] for r in rows]))}
            for k in rows[0]}


def run_exact_path(model, dev, raycast):
    """Phase 10b: the exact flagship through predict_batch at 16 x 16384,
    bf16, seed-0 weights (the phase-4 model's); the fused model on the
    same clouds, the CPU on a small cut, the drift on a ray-cast batch."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.models import ModelInferenceHelper, build_model
    from deepclr_tpu_torch.synthetic import kitti_like

    exact = build_model(exact_cfg(), device=dev)
    exact.load_state_dict(model.state_dict())
    templates, sources = kitti_like(BATCH, NPTS, seed=1), kitti_like(BATCH, NPTS, seed=2)
    ops.reset_launch_counts()
    y = ModelInferenceHelper(exact, num_points=NPTS).predict_batch(list(sources), list(templates))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if y.shape != (BATCH, 8) or not np.isfinite(y).all():
        raise AssertionError(f"exact predict_batch: shape {y.shape}, finite {np.isfinite(y).all()}")
    if counts["fps"] < 1 or any(counts[k] for k in ("min_d2", "fused_sa", "fused_sa_argmax", "fused_sa_bwd")):
        raise AssertionError(f"exact predict_batch: launches {counts}")

    # the fused model on the same clouds.  The fused path Morton-sorts the
    # points before FPS, so FPS starts elsewhere and picks other centres:
    # the two agree only on host-sorted clouds (presorted models, the same
    # order for both), and there only where no ball exceeds its nsample
    xyz = torch.from_numpy(np.concatenate([sources, templates])[..., :3]).to(dev)
    centres = ops.gather_points(xyz, ops.furthest_point_sample(xyz, 1024))
    largest = {f"r{r}": int(ball_stats(xyz, centres, r, None)[0].max()) for r, _ in EXACT_SCALES}
    y_fused = ModelInferenceHelper(model, num_points=NPTS).predict_batch(list(sources), list(templates))
    unsorted_err = float(np.abs(y - y_fused).max())
    y_sorted = {}
    for fused in (True, False):
        cfg = exact_cfg()
        cfg["params"].update(fused=fused, presorted=True)
        m = build_model(cfg, device=dev)
        m.load_state_dict(model.state_dict())
        y_sorted[fused] = ModelInferenceHelper(m, num_points=NPTS).predict_batch(list(sources), list(templates))
    fused_err = float(np.abs(y_sorted[True] - y_sorted[False]).max())
    gated = all(largest[f"r{r}"] < n for r, n in EXACT_SCALES)
    if gated and not fused_err <= VARIANT_TOL["bfloat16"]:
        raise AssertionError(f"exact vs fused on presorted clouds, balls within nsample: {fused_err}")

    cpu = build_model(exact_cfg(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small_t, small_s = kitti_like(2, 4096, seed=5), kitti_like(2, 4096, seed=6)
    y_card = ModelInferenceHelper(exact, num_points=4096).predict_batch(list(small_s), list(small_t))
    y_cpu = ModelInferenceHelper(cpu, num_points=4096).predict_batch(list(small_s), list(small_t))
    cpu_err = float(np.abs(y_card - y_cpu).max())
    if not cpu_err <= VARIANT_TOL["bfloat16"]:
        raise AssertionError(f"exact model card vs CPU: {cpu_err}")

    drift = {}
    for order in ("as_loaded", "host_sorted"):
        f32 = {}
        for name in ("fused", "exact"):
            cfg = copy.deepcopy(raycast["model_cfg"])
            cfg["params"].update(fused=name == "fused", compute_dtype="float32", presorted=order == "host_sorted")
            f32[name] = build_model(cfg, device=dev)
            f32[name].load_state_dict(raycast["weights"])
        batch = raycast["batch"] if order == "as_loaded" else morton_sorted(raycast["batch"])
        drift[order] = raycast_drift(f32["fused"], f32["exact"], batch, dev)
    xyz = torch.from_numpy(np.concatenate([raycast["batch"]["template"], raycast["batch"]["source"]])[..., :3]).to(dev)
    mask = torch.from_numpy(np.concatenate([raycast["batch"]["template_mask"], raycast["batch"]["source_mask"]])).to(dev)
    centres = ops.gather_points(xyz, ops.furthest_point_sample(xyz, 1024, mask))
    raycast_balls = {}
    for r, n in EXACT_SCALES:
        counts_r = ball_stats(xyz, centres, r, mask)[0]
        raycast_balls[f"r{r}"] = {"largest": int(counts_r.max()), "truncated_balls": int((counts_r > n).sum()),
                                  "balls": counts_r.numel()}
    emit({"check": "exact_path", "predict_batch_y0": y[0].tolist(), "launches_predict_batch": counts,
          "vs_fused_presorted_max_abs_err": fused_err, "vs_fused_unsorted_max_abs_err": unsorted_err,
          "largest_ball_serving": largest, "vs_fused_gated": gated,
          "card_vs_cpu_2x4096_max_abs_err": cpu_err, "tolerance": VARIANT_TOL["bfloat16"],
          "raycast_fused_vs_exact_f32": drift, "raycast_balls": raycast_balls,
          "raycast_weights": raycast["weights_from"]})
    return exact, templates, sources


def run_exact_train(dev):
    """Phase 10c: the exact flagship's train step through run_trainer at
    5 x 16384 (2 micro-steps, one update), then a float32 micro-step on
    2 x 4096 against the CPU."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.configs import KITTI_TRAIN_CFG
    from deepclr_tpu_torch.engine import run_trainer
    from deepclr_tpu_torch.synthetic import train_batch

    model, opt, schedule, loss_fn, metric_fns = train_parts(exact_cfg(), dev)
    sa_names = [n for n, _ in model.named_parameters() if n.startswith("_cloud_layers") and n.endswith("weight")]
    seen = []

    def inspect_grads(optimizer, args, kwargs):
        grads = {n: p.grad for n, p in model.named_parameters()}
        seen.append({"non_finite_or_missing": [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()],
                     "zero_sa_weight_grads": [n for n in sa_names if grads[n].abs().max().item() == 0.0]})

    hook = opt.register_step_pre_hook(inspect_grads)
    cfg = copy.deepcopy(KITTI_TRAIN_CFG)
    cfg["optimizer"]["max_iterations"] = 2
    cfg["logging"].update(log_period=1, checkpoint_period=10**9)
    batches = [train_batch(TRAIN_BATCH, NPTS, seed=80 + i) for i in range(2)]
    ops.reset_launch_counts()
    state = run_trainer(cfg, model, batches, None, opt, schedule, loss_fn, metric_fns)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hook.remove()
    ema = {k: v.item() for k, v in state.metrics_ema.items()}
    emit({"check": "exact_train_path", "micro_steps": state.step, "metrics_ema": ema, "grad_checks": seen,
          "launches_2_micro_steps": counts})
    if state.step != 2 or len(seen) != 1 or seen[0]["non_finite_or_missing"] or seen[0]["zero_sa_weight_grads"]:
        raise AssertionError(f"exact train path: {state.step} micro-steps, gradient checks {seen}")
    if not all(np.isfinite(v) for v in ema.values()):
        raise AssertionError(f"exact train path: loss {ema}")
    if counts["fps"] < 1 or any(counts[k] for k in ("min_d2", "fused_sa", "fused_sa_argmax", "fused_sa_bwd")):
        raise AssertionError(f"exact train path: launches {counts}")
    check_train_card_vs_cpu(dev, fused=False)
    return model, opt, loss_fn, metric_fns, batches


def variant_modules(dtype):
    """Small instances of every variant module, seeded; (name, module, inputs)."""
    from deepclr_tpu_torch.geometry import LabelType
    from deepclr_tpu_torch.models import FeaturePropagation, MotionEmbedding, OutputSimple, init_params

    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(90)

    def feats(b, p, c, scale=5.0):
        return torch.from_numpy(np.concatenate([rng.normal(size=(b, p, 3)) * scale, rng.normal(size=(b, p, c))],
                                               -1).astype(np.float32))

    def per_cloud(b, p, c):
        # each cloud its own offset and spread: the head's linear layers
        # normalise over the batch alone, and pooled features of iid clouds
        # differ so little across it that E[x^2] - E[x]^2 cancels
        return torch.from_numpy((rng.normal(size=(b, 1, c)) * 2.0 + rng.normal(size=(b, p, c))
                                 * rng.uniform(0.5, 2.0, size=(b, 1, 1))).astype(np.float32))

    def grid(b, p):
        return torch.from_numpy((np.round(rng.normal(size=(b, p, 3)) * 64) / 64).astype(np.float32))

    f0, f1 = feats(2, 256, 64), feats(2, 256, 64)
    me = dict(feat_dim=64, mlp=[128, 128, 256], compute_dtype=cd)
    out = [("motion_embedding_k0", MotionEmbedding(k=0, radius=10.0, **me), (f0, f1)),
           ("motion_embedding_append_features_false", MotionEmbedding(k=20, append_features=False, **me), (f0, f1)),
           ("motion_embedding_batch_norm", MotionEmbedding(k=20, batch_norm=True, **me), (f0, f1)),
           ("output_simple_batch_norm", OutputSimple(259, [256, 512, 1024], [1024, 512, 256],
                                                     LabelType.POSE3D_DUAL_QUAT, batch_norm=True, compute_dtype=cd),
            (per_cloud(BATCH, 256, 259),)),
           # coordinates on a 1/64 grid, so every distance is exact on both
           # devices: the expanded form (JAX's) cancels ~1e-7 of |x|^2, which
           # moves the weights of close neighbours by ~4e-5 at unit scale
           ("feature_propagation_batch_norm", FeaturePropagation(68, [64, 32], batch_norm=True, compute_dtype=cd),
            (grid(2, 1024), grid(2, 256), torch.from_numpy(
                rng.normal(size=(2, 1024, 4)).astype(np.float32)), torch.from_numpy(
                rng.normal(size=(2, 256, 64)).astype(np.float32)), torch.ones(2, 256, dtype=torch.bool)))]
    out[-1][2][4][1, 200:] = False
    for i, (_, module, inputs) in enumerate(out):
        init_params(module, 100 + i)
        with torch.no_grad():  # running statistics of a batch, so evaluation mode normalises too
            module.train()(*inputs)
        module.eval()
    return out


def check_variants(dev):
    """Phase 10d: each variant module in evaluation and training mode (the
    running statistics too) on the card against the CPU, float32 and bf16;
    then DeepCLR.forward on 16384-point templates and 12000-point sources."""
    from deepclr_tpu_torch.models import build_model
    from deepclr_tpu_torch.synthetic import kitti_like

    errs = {}
    for dtype, tol in VARIANT_TOL.items():
        for name, module, inputs in variant_modules(dtype):
            for train in (False, True):
                results = {}
                for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
                    m = copy.deepcopy(module).to(device).train(train)
                    with torch.no_grad():
                        y = m(*[x.to(device) for x in inputs]).float().cpu()
                    results[where] = (y, {k: v.cpu() for k, v in m.state_dict().items() if "running" in k})
                (y_card, s_card), (y_cpu, s_cpu) = results["card"], results["cpu"]
                err = ((y_card - y_cpu).abs().max() / max(1.0, y_cpu.abs().max().item())).item()
                stat_err = max([((s_card[k] - v).abs().max() / max(1.0, v.abs().max().item())).item()
                                for k, v in s_cpu.items()] or [0.0])
                errs[f"{name}/{dtype}/{'train' if train else 'eval'}"] = {"output": err, "running_stats": stat_err}
                if not (err <= tol and stat_err <= tol):
                    raise AssertionError(f"{name} {dtype} train={train}: card vs CPU {err}, statistics {stat_err}")

    t = torch.from_numpy(kitti_like(2, NPTS, seed=91))
    s = torch.from_numpy(kitti_like(2, 12000, seed=92))
    ys = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(exact_cfg(), device=device, seed=4)
        with torch.no_grad():
            ys[where] = model(t.to(device), s.to(device))[0].float().cpu()
    err = (ys["card"] - ys["cpu"]).abs().max().item()
    errs[f"deepclr_forward_{NPTS}_vs_12000/bfloat16"] = {"output": err}
    if not err <= VARIANT_TOL["bfloat16"]:
        raise AssertionError(f"DeepCLR.forward on differently padded clouds: card vs CPU {err}")
    emit({"check": "variants_card_vs_cpu", "max_err_of_scale": errs, "tolerance": VARIANT_TOL})


def check_weight_files(exact, dev):
    """Phase 10e: a reference-layout weights.tar (the exact model's state
    dict with (out, in, 1) convolution weights) through python -m
    deepclr_tpu_torch.convert_weights and load_trained_model: the
    predictions equal the source model's."""
    import yaml

    from deepclr_tpu_torch.config import load_model_config
    from deepclr_tpu_torch.models import ModelInferenceHelper, load_trained_model
    from deepclr_tpu_torch.synthetic import kitti_like

    t, s = kitti_like(2, 4096, seed=93), kitti_like(2, 4096, seed=94)

    def predict(model):
        return ModelInferenceHelper(model, num_points=4096).predict_batch(list(s), list(t))

    want = predict(exact)
    with tempfile.TemporaryDirectory() as tmp:
        ref = {k: (v.unsqueeze(-1) if k.endswith("weight") and v.dim() == 2 and "output" not in k else v).cpu()
               for k, v in exact.state_dict().items()}
        tar, cfg_path, out = osp.join(tmp, "weights.tar"), osp.join(tmp, "model_config.yaml"), osp.join(tmp, "w.pt")
        torch.save(ref, tar)
        with open(cfg_path, "w") as f:
            yaml.safe_dump(exact_cfg(), f)
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", "deepclr_tpu_torch.convert_weights", tar, cfg_path, out],
                              cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                              timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"convert_weights failed: {done.stderr[-2000:]}")
        convert_s = time.perf_counter() - t0
        got = {name: predict(load_trained_model(load_model_config(cfg_path, path), path, device=dev))
               for name, path in (("weights_pt", out), ("weights_tar", tar))}
    same = {name: bool(np.array_equal(y, want)) for name, y in got.items()}
    emit({"check": "weight_files", "predictions_equal": same, "convert_weights_s": convert_s,
          "convert_weights_stdout": done.stdout.strip()})
    if not all(same.values()):
        raise AssertionError(f"converted weights predict otherwise: {same}")


def time_exact(exact, dev, templates, sources, train_parts_, fused_pairs_per_s, card):
    """Phase 10f: the exact path's forward rate at 16 x 16384, its ball
    query and grouped MLP, the exact train micro-step at 5 x 16384, peak
    memory; CUDA events, medians after a warm-up."""
    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.engine import create_train_state, make_train_step
    from deepclr_tpu_torch.ops import ball_grouping as bq

    t = torch.from_numpy(templates).to(dev)
    s = torch.from_numpy(sources).to(dev)
    ones = torch.ones(BATCH, NPTS, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: exact(t, s, ones, ones), reps=5)
    fwd_peak = torch.cuda.max_memory_allocated()

    sa = exact.cloud_features._sa0
    both = torch.cat([t, s])
    xyz, feats, mask = both[..., :3].contiguous(), both[..., 3:].contiguous(), torch.cat([ones, ones])
    with torch.inference_mode():
        centres = ops.gather_points(xyz, ops.furthest_point_sample(xyz, sa.npoint, mask))
        bq_ms = {f"r{r}_nsample{n}": cuda_ms(lambda r=r, n=n: ops.ball_query(xyz, centres, r, n, mask), reps=5)
                 for r, n in EXACT_SCALES}
        bq_ms["both_scales_one_distance_pass"] = cuda_ms(
            lambda: ops.ball_query_scales(xyz, centres, sa.radii, sa.nsamples, mask), reps=5)
        indices = ops.ball_query_scales(xyz, centres, sa.radii, sa.nsamples, mask)
        mlp_ms = cuda_ms(lambda: sa.grouped_mlp(xyz, feats, centres, indices), reps=5)

    model, opt, loss_fn, metric_fns, batches = train_parts_
    step = make_train_step(model, opt, loss_fn, metric_fns, accumulation_steps=2)
    state = create_train_state(model)
    dev_batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(8):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, dev_batches[i % len(dev_batches)], 1e-6)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    train_peak = torch.cuda.max_memory_allocated()
    train_ms = statistics.median(times[2:])
    metrics = {"exact_forward_pairs_per_s": BATCH / (fwd_ms / 1e3), "exact_forward_ms": fwd_ms,
               "fused_forward_pairs_per_s_phase6": fused_pairs_per_s,
               f"ball_query_ms_{2 * BATCH}x{NPTS}_to_{sa.npoint}": bq_ms, "grouped_mlp_ms_both_scales": mlp_ms,
               "exact_train_micro_step_ms": train_ms, "exact_train_micro_step_ms_each": times,
               "exact_train_pairs_per_s": TRAIN_BATCH / (train_ms / 1e3),
               "peak_allocated_gb_forward_16_pairs": fwd_peak / 1e9,
               "peak_allocated_gb_train_micro_step": train_peak / 1e9,
               "ball_query_block_centres": bq.block_centres(2 * BATCH, sa.npoint, NPTS),
               "ball_query_scratch_bytes": bq.SCRATCH_BYTES, "compute_dtype": str(sa.compute_dtype)}
    emit({"exact_path_timing": metrics, "card": card})
    return metrics


def run_variants_phase(model, dev, card, fused_pairs_per_s, raycast):
    """Phase 10: the model variants the JAX package builds, through the
    port's entry points: the exact flagship (ball query, nsample
    truncation) serving and training at full width, the variant modules
    card against CPU, the weight files, and the exact path's timing."""
    start = time.perf_counter()
    with torch.inference_mode():
        bq = check_ball_query(dev)
        emit({"check": "ball_query_card_vs_cpu", "scales": bq, "boundary_m2": BOUNDARY_M2})
        exact, templates, sources = run_exact_path(model, dev, raycast)
    train = run_exact_train(dev)
    check_variants(dev)
    with torch.inference_mode():
        check_weight_files(exact, dev)
    metrics = time_exact(exact, dev, templates, sources, train, fused_pairs_per_s, card)
    emit({"phase": "model_variants", "seconds": time.perf_counter() - start})
    return metrics


def write_dp_packs(tmp, ranks=DP_RANKS):
    """Phase 11's packs for ``ranks`` ranks: a training and a validation
    KITTI sequence of ray-cast HDL-64 scans, each scan subsampled once to
    NPTS points as it is written, so the loader neither subsamples nor pads
    (its draws would depend on how the samples are sharded).  Returns the
    seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    from deepclr_tpu_torch.data import PackWriter
    from deepclr_tpu_torch.data.synthetic import drive

    # validation: one global batch, so every rank's shard holds one full batch of it
    frames = {"train": ranks * TRAIN_BATCH * DP_MICRO_STEPS + 1, "val": ranks * TRAIN_BATCH + 1}

    def sequence(k, name):
        pick = np.random.default_rng(3000 + k)
        with PackWriter(osp.join(tmp, f"{name}.pack")) as w:
            for i, (pose, scan) in enumerate(drive(np.random.default_rng(2000 + k), frames[name], SCAN_POINTS)):
                if len(scan) < NPTS:
                    raise AssertionError(f"{name} frame {i}: {len(scan)} points")
                keep = np.sort(pick.choice(len(scan), NPTS, replace=False))
                w.put(f"{i:08d}", {"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan[keep]})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(sequence, k, name) for k, name in enumerate(frames)]:
            f.result()
    return time.perf_counter() - t0


def dp_yaml(tmp, name, batch_size, micro_steps=DP_MICRO_STEPS, lr=DP_LR):
    """A YAML that extends the shipped kitti_base.yaml (no augmentation
    transforms) with phase 11's packs, float32, ``micro_steps`` micro-steps,
    a constant lr (DP_LR) in place of the schedule (whose 1e-7 start would
    leave two updates too small to show an error in the gradients; from
    1e-4 up the flagship's loss climbs after the first update, and two
    ranks, which sum the global batch in another order than one process,
    no longer agree with it within the validation gate), loader workers off
    (their order is not fixed) and validation once, after the final
    checkpoint."""
    import yaml

    path = osp.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"extends": osp.join(REPO, KITTI_BASE_YAML), "base_dir": osp.join(tmp, name), "identifier": name,
                        "data": {"training": osp.join(tmp, "train.pack"), "validation": osp.join(tmp, "val.pack"),
                                 "dataset_type": "kitti_odometry_velodyne", "sequential": True},
                        "data_loader": {"batch_size": batch_size, "num_workers": 0, "buffer_size": 0},
                        "model": {"params": {"compute_dtype": "float32"}},
                        "optimizer": {"max_iterations": micro_steps, "base_lr": lr},
                        "scheduler": {"name": None, "params": {}, "on_iteration": False},
                        "logging": {"summary_period": 1, "log_period": 1, "checkpoint_period": 10**6,
                                    "validation_period": 10**6}}, f)
    return path


def read_run(base_dir, micro_steps):
    """The one run directory under base_dir: its scalars ({tag: values in
    step order}) and final weights; raises if any other directory holds a
    file (only rank 0 writes)."""
    runs = [d for d in sorted(os.listdir(base_dir)) if os.listdir(osp.join(base_dir, d))]
    if len(runs) != 1:
        raise AssertionError(f"{base_dir}: run directories with files {runs}, expected one")
    run_dir = osp.join(base_dir, runs[0])
    tags = {}
    with open(osp.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    scalars = {t: [v for _, v in sorted(vals)] for t, vals in tags.items()}
    weights = torch.load(osp.join(run_dir, f"weights_final_{micro_steps}.pt"), map_location="cpu",
                         weights_only=True)
    return scalars, weights


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_train_in_process(path, nccl, micro_steps=DP_MICRO_STEPS):
    """train(cfg) of one YAML in this process, with no process group or in a
    one-rank NCCL group.  Returns the probe, the run's launches, scalars and
    final weights."""
    from deepclr_tpu_torch import ops, parallel
    from deepclr_tpu_torch.config import Mode, load_config
    from deepclr_tpu_torch.engine import trainer

    cfg = load_config(path, Mode.NEW)
    if nccl:
        torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                                             rank=0, timeout=parallel.distributed.TIMEOUT)
    try:
        ops.reset_launch_counts()
        with TrainerProbe() as probe:
            state = trainer.train(cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        probe.flag_ms = interrupt_flag_ms(torch.device("cuda")) if nccl else None
    finally:
        parallel.shutdown()
    if state.step != micro_steps:
        raise AssertionError(f"{path}: {state.step} micro-steps")
    return probe, counts, *read_run(cfg.base_dir, micro_steps)


def interrupt_flag_ms(device):
    """Host time of one end-of-iteration interrupt agreement of the trainer
    (parallel.any_over_processes: a one-element MAX all-reduce and the host
    read of its result), the median of INTERRUPT_FLAG_CALLS calls after a
    warm-up call; every rank of the group calls it as often."""
    from deepclr_tpu_torch import parallel

    parallel.any_over_processes(False, device)
    times = []
    for _ in range(INTERRUPT_FLAG_CALLS):
        t0 = time.perf_counter()
        parallel.any_over_processes(False, device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(a, b):
    """max |a - b| / max |b| over one array; NaN where both are NaN (a
    segment error of a drive shorter than 100 m) counts as equal, NaN on one
    side only as infinite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    a, b = a[~np.isnan(b)], b[~np.isnan(b)]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) if b.size else 0.0


def weights_rel_err(a, b):
    """Two state dicts of the same keys: the largest |a - b| of any weight
    over the largest |b| of any weight, one scale for the whole model (a
    bias that starts at zero has only its update's scale, and a neighbour
    that wins a max in one run and not in another moves that update far
    more than 1e-5 of it between two runs without a group); and, reported
    beside it, the tensor that differs most relative to its own scale."""
    keys = [k for k, v in b.items() if v.is_floating_point()]
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
    scale = max(float(b[k].abs().max()) for k in keys)
    own = {k: rel_err(a[k], b[k]) for k in keys}
    worst = max(own, key=own.get)
    return diff / max(scale, 1e-30), {"tensor": worst, "rel_err_own_scale": own[worst]}


def bit_equal_runs(a, b, micro_steps):
    """Two runs' (scalars, final weights) without a group: raise unless
    their train/loss_fn trajectories and every weight are equal bit for bit."""
    (sa, wa), (sb, wb) = a, b
    differ = sorted(k for k in wb if not torch.equal(wa[k], wb[k]))
    out = {"micro_steps": micro_steps, "loss_fn": sa["train/loss_fn"], "loss_fn_equal":
           sa["train/loss_fn"] == sb["train/loss_fn"], "weights_differing": differ,
           "weights_rel_err": weights_rel_err(wa, wb)[0]}
    if differ or not out["loss_fn_equal"] or len(sa["train/loss_fn"]) != micro_steps:
        raise AssertionError(f"two identical runs without a group differ: {out}")
    return out


def micro_step_ms(step_ms):
    """Medians over the micro-steps after the first update (the warm-up) of
    accumulation 2: the local (no_sync) micro-steps, the all-reducing ones
    (with the optimizer step), and their mean."""
    local, synced = statistics.median(step_ms[2::2]), statistics.median(step_ms[3::2])
    return {"mean": (local + synced) / 2, "local": local, "all_reduce": synced}


def dp_rank_main(path, out_dir):
    """One rank of phase 11 or of --dp-cards (``chip_smoke.py --dp-rank YAML
    OUT_DIR``): python -m deepclr_tpu_torch.training's main() under a
    TrainerProbe; writes the probe's numbers to OUT_DIR/rank<r>.json.  With
    the DEEPCLR_COORDINATOR variables (phase 11's ranks, which share one
    card) the rank joins the group over gloo itself, since NCCL refuses two
    ranks on one card; under torchrun (--dp-cards) main() joins it from the
    environment, over NCCL."""
    from deepclr_tpu_torch import ops, parallel, training

    rank = int(os.environ.get("DEEPCLR_PROCESS_ID", os.environ.get("RANK", "0")))
    flag_ms = None
    if "DEEPCLR_COORDINATOR" in os.environ:
        parallel.initialize(os.environ["DEEPCLR_COORDINATOR"], int(os.environ["DEEPCLR_NUM_PROCESSES"]), rank,
                            [int(os.environ["DEEPCLR_LOCAL_DEVICE_IDS"])], backend="gloo")
        flag_ms = interrupt_flag_ms(parallel.local_device())
    ops.reset_launch_counts()
    with TrainerProbe() as probe:
        training.main([path])
    torch.cuda.synchronize()
    ddp = probe.stepped[0]
    with open(osp.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "wrapper": type(ddp).__name__,
                   "step_ms": probe.step_ms, "step_launches": probe.step_launches, "launches": ops.launch_counts(),
                   "interrupt_flag_ms": flag_ms,
                   "grad_bytes": sum(p.numel() * p.element_size() for p in ddp.parameters() if p.requires_grad)}, f)
    return 0


def initial_weights(path):
    """The weights that train(cfg) of the YAML starts from, on the card."""
    from deepclr_tpu_torch.config import Mode, load_config
    from deepclr_tpu_torch.models import build_model

    cfg = load_config(path, Mode.TEST)
    return {k: v.cpu() for k, v in build_model(cfg.model, device="cuda", seed=cfg.seed).state_dict().items()}


def check_ranks(tag, base_dir, ref_scalars, ref_weights, init, ranks):
    """The ranks' run (rank 0's run directory under base_dir, the only one
    with files) against one process of the global batch: train/loss_fn
    within DP_LOSS_RTOL / DP_LOSS_ATOL, every val/ scalar within DP_VAL_TOL
    of its scale, the final weights within DP_WEIGHT_TOL (weights_rel_err),
    the train step run by DistributedDataParallel and B1-B4 launched
    on every rank.  Also reported: each tensor's update (final - ``init``)
    against the global run's, relative to that update's scale."""
    scalars, weights = read_run(base_dir, DP_MICRO_STEPS)
    loss, ref_loss = np.asarray(scalars["train/loss_fn"]), np.asarray(ref_scalars["train/loss_fn"])
    val_tags = sorted(t for t in ref_scalars if t.startswith("val/"))
    val_err = {t: rel_err(scalars[t], ref_scalars[t]) for t in val_tags if t in scalars}
    if sorted(weights) != sorted(ref_weights):
        raise AssertionError(f"{tag}: weight keys {sorted(set(weights) ^ set(ref_weights))} differ")
    weight_err, weight_worst = weights_rel_err(weights, ref_weights)
    update_err = {k: rel_err(weights[k] - init[k], v - init[k]) for k, v in ref_weights.items()
                  if k in weights and v.is_floating_point()}
    out = {"loss_fn": loss.tolist(), "loss_fn_global_batch": ref_loss.tolist(),
           "loss_fn_max_abs_err": float(np.abs(loss - ref_loss).max()), "val_rel_err": val_err,
           "weights_rel_err": weight_err, "weights_worst": weight_worst,
           "update_rel_err": max(update_err.values()), "update_rel_err_median": statistics.median(update_err.values()),
           "update_scale": max(float((v - init[k]).abs().max()) for k, v in ref_weights.items() if k in update_err),
           "wrappers": [r["wrapper"] for r in ranks]}
    if (loss.shape != ref_loss.shape or not np.allclose(loss, ref_loss, rtol=DP_LOSS_RTOL, atol=DP_LOSS_ATOL)
            or "val/step_t_err" not in val_err or len(val_err) != len(val_tags)
            or max(val_err.values()) > DP_VAL_TOL or weight_err > DP_WEIGHT_TOL
            or any(r["wrapper"] != "DistributedDataParallel" for r in ranks)):
        raise AssertionError(f"{tag} against one process of the global batch: {out}")
    for r in ranks:
        missing = [k for k in TRAIN_KERNELS if r["launches"].get(k, 0) < 1]
        if missing:
            raise AssertionError(f"{tag}, rank {r['rank']}: kernels {missing} never launched")
    return out


def run_gloo_ranks(path, tmp):
    """DP_RANKS processes of dp_rank_main on the one card over gloo, with
    the DEEPCLR_COORDINATOR contract; all killed if one fails or outlasts
    DP_RANK_TIMEOUT_S."""
    port = free_port()
    procs = []
    for r in range(DP_RANKS):
        env = dict(os.environ, DEEPCLR_COORDINATOR=f"127.0.0.1:{port}", DEEPCLR_NUM_PROCESSES=str(DP_RANKS),
                   DEEPCLR_PROCESS_ID=str(r), DEEPCLR_LOCAL_DEVICE_IDS="0")
        procs.append(subprocess.Popen([sys.executable, osp.join(REPO, "chip_smoke.py"), "--dp-rank", path, tmp],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return wait_ranks(procs, tmp, DP_RANKS)


def wait_ranks(procs, out_dir, ranks):
    """Wait for the rank processes (all killed if one fails or the wait
    outlasts DP_RANK_TIMEOUT_S) and read their rank<r>.json."""
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
    bad = {r: (p.returncode, logs[r][-3000:] if r < len(logs) else "") for r, p in enumerate(procs) if p.returncode}
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    results = []
    for r in range(ranks):
        with open(osp.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def run_data_parallel_phase(card):
    """Phase 11: data-parallel training from kitti_base.yaml at the
    flagship's full width on ray-cast packs: (a) a one-rank NCCL group
    (DistributedDataParallel, the kernels) against no group; (b) two gloo
    ranks on the one card against one process of the global batch; the
    micro-step times, gradient bytes and launches a micro-step."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        packs_s = write_dp_packs(tmp)
        plain_probe, plain_counts, plain_scalars, plain_weights = dp_train_in_process(
            dp_yaml(tmp, "plain", TRAIN_BATCH), nccl=False)
        # (a) the main path of this phase: the counts are zeroed just before it
        dp_probe, dp_counts, dp_scalars, dp_weights = dp_train_in_process(dp_yaml(tmp, "nccl1", TRAIN_BATCH), nccl=True)
        ddp = dp_probe.stepped[0]
        if type(ddp).__name__ != "DistributedDataParallel":
            raise AssertionError(f"one-rank group: the train step ran {type(ddp).__name__}")
        missing = [k for k in TRAIN_KERNELS if dp_counts.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"data parallel: kernels {missing} never launched ({dp_counts})")
        if dp_probe.step_launches != plain_probe.step_launches or dp_counts != plain_counts:
            raise AssertionError(f"data parallel launches {dp_probe.step_launches} / {dp_counts} differ from "
                                 f"no group's {plain_probe.step_launches} / {plain_counts}")
        if sorted(dp_weights) != sorted(plain_weights):
            raise AssertionError(f"one-rank group: weight keys {sorted(set(dp_weights) ^ set(plain_weights))}")
        weights_err, weights_worst = weights_rel_err(dp_weights, plain_weights)
        one_rank = {"loss_fn": rel_err(dp_scalars["train/loss_fn"], plain_scalars["train/loss_fn"]),
                    "weights": weights_err, "weights_worst": weights_worst,
                    "weights_bit_equal": all(torch.equal(dp_weights[k], v) for k, v in plain_weights.items())}
        if len(dp_scalars["train/loss_fn"]) != DP_MICRO_STEPS or max(one_rank["loss_fn"], one_rank["weights"]) > \
                DP_ONE_RANK_TOL or not one_rank["weights_bit_equal"]:
            raise AssertionError(f"one-rank NCCL group against no group: {one_rank}")
        # two runs without a group at the lr that exposed float-atomic drift:
        # the same losses and weights bit for bit (phase 11's timing runs
        # give the same at DP_LR, 12 micro-steps)
        high = [dp_train_in_process(dp_yaml(tmp, f"high{i}", TRAIN_BATCH, lr=DP_HIGH_LR), nccl=False)
                for i in range(2)]
        repeat = {"lr_1e-3": bit_equal_runs(high[0][2:], high[1][2:], DP_MICRO_STEPS)}

        # (b) two gloo ranks of TRAIN_BATCH pairs against one process of the global batch
        global_yaml = dp_yaml(tmp, "global", DP_RANKS * TRAIN_BATCH)
        _, _, ref_scalars, ref_weights = dp_train_in_process(global_yaml, nccl=False)
        ranks = run_gloo_ranks(dp_yaml(tmp, "gloo", TRAIN_BATCH), tmp)
        two_rank = check_ranks("two gloo ranks", osp.join(tmp, "gloo"), ref_scalars, ref_weights,
                               initial_weights(global_yaml), ranks)
        emit({"check": "data_parallel", "one_rank_nccl_vs_no_group": one_rank, "two_gloo_ranks_vs_global_batch":
              two_rank, "tolerances": {"one_rank": DP_ONE_RANK_TOL, "loss": [DP_LOSS_RTOL, DP_LOSS_ATOL],
                                       "val": DP_VAL_TOL, "weights": DP_WEIGHT_TOL}, "lr": DP_LR})
        # timing: DP_TIMING_STEPS micro-steps a run, no group and the one-rank
        # group in turns (plain, group, group, plain), then two gloo ranks;
        # the two runs without a group also give the run-to-run spread
        timed, no_group_runs, flag_ms = {"no_group": [], "ddp_nccl_1_rank": []}, [], {"nccl_1_rank": []}
        for i, nccl in enumerate((False, True, True, False)):
            probe, _, scalars, weights = dp_train_in_process(dp_yaml(tmp, f"time{i}", TRAIN_BATCH, DP_TIMING_STEPS),
                                                             nccl, DP_TIMING_STEPS)
            timed["ddp_nccl_1_rank" if nccl else "no_group"].append(probe.step_ms)
            if nccl:
                flag_ms["nccl_1_rank"].append(probe.flag_ms)
            else:
                no_group_runs.append((scalars, weights))
        timed_ranks = run_gloo_ranks(dp_yaml(tmp, "gloo_time", TRAIN_BATCH, DP_TIMING_STEPS), tmp)
        for r in timed_ranks:
            timed[f"gloo_rank_{r['rank']}"] = [r["step_ms"]]
        flag_ms["gloo_2_ranks_one_card"] = [r["interrupt_flag_ms"] for r in (*ranks, *timed_ranks)]
        grad_bytes = sum(p.numel() * p.element_size() for p in ddp.parameters() if p.requires_grad)
        repeat[f"lr_{DP_LR}"] = bit_equal_runs(*no_group_runs, DP_TIMING_STEPS)
        emit({"check": "no_group_run_to_run_bit_equal", "runs": repeat})
        emit({"data_parallel_timing": {
            "micro_step_ms": {k: [micro_step_ms(run) for run in runs] for k, runs in timed.items()},
            "micro_step_ms_each": timed, "micro_steps_a_run": DP_TIMING_STEPS,
            "grad_bytes_all_reduced_per_update": grad_bytes, "gloo_rank_grad_bytes": [r["grad_bytes"] for r in ranks],
            "parameters": sum(p.numel() for p in ddp.parameters()),
            "launches_per_dp_micro_step": dp_probe.step_launches,
            "launches_per_gloo_micro_step": [r["step_launches"] for r in ranks],
            "interrupt_flag_all_reduce_ms": flag_ms, "packs_s": packs_s}, "card": card})
    emit({"phase": "data_parallel", "seconds": time.perf_counter() - start})
    return dp_probe.step_launches


CLI_FRAMES = 7                # frames a raw KITTI sequence: 6 pairs, so 00 and 01 hold 2 micro-steps of 5
CLI_KITTI_ARGS = ["--sequences", "00,01,04", "--frames", str(CLI_FRAMES), "--points", "32768"]  # 16384 converted
# 2100 points a model: just above the converter's 2048-point host FPS, whose time grows with the points
CLI_MODELNET_ARGS = ["--train-per-shape", "1", "--test-per-shape", "1", "--points", "2100"]
CLI_KITTI_FRAMES = 6          # frames the KITTI example registers (5 predictions)
CLI_MODELNET_SAMPLES = 3


def run_cli(module, argv, env):
    """``python -m module argv`` in this process: its main() with sys.argv
    and the environment set for the call; returns what it printed."""
    import importlib
    import io

    saved_argv, saved_env = sys.argv, {k: os.environ.get(k) for k in env}
    sys.argv = [module, *argv]
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            importlib.import_module(module).main()
    finally:
        sys.argv = saved_argv
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return printed.getvalue()


def count_samples(dataset_type, path):
    from deepclr_tpu_torch.data import DatasetType, create_input_dataflow

    samples = list(create_input_dataflow(DatasetType(dataset_type), path))
    if not samples or not all(np.isfinite(s["clouds"][0]).all() and np.isfinite(s["transform"]).all()
                              for s in samples):
        raise AssertionError(f"{path}: no samples, or a non-finite cloud or label")
    return len(samples), samples[0]["clouds"][0].shape


def printed_errors(text, want):
    """The translation errors an example printed: ``want`` of them, finite."""
    errs = [float(line.split("translation error ")[1].split()[0]) for line in text.splitlines()
            if "translation error" in line]
    if len(errs) != want or not np.isfinite(errs).all():
        raise AssertionError(f"expected {want} finite translation errors, got {errs}")
    return errs


# each paper table: the scenario and the run's step_errors.csv row it reads,
# and its columns -> the evaluation CLI's columns
PAPER_TABLES = {
    "kitti_odometry_table": ("kitti_04_10", None, {"t_rmse [m]": "t_rmse_mean [m]",
                                                    "r_rmse [deg]": "r_rmse_mean [deg]"}),
    "kitti_artificial_table": ("kitti_pairs", "TOTAL", {
        "Rot. Error Mean [deg]": "r_chordal_mean [deg]", "Rot. Error Max [deg]": "r_chordal_max [deg]",
        "Tran. Error Mean [m]": "t_kitti_mean [m]", "Tran. Error Max [m]": "t_kitti_max [m]",
        "Time [ms]": "time_mean [ms]"}),
    "modelnet40_table": ("modelnet40_unseen", "test_unseen_0.04", {
        "Rot. Error Mean [deg]": "r_chordal_mean [deg]", "Rot. Error Std [deg]": "r_chordal_std [deg]",
        "Tran. Error Mean [m]": "t_kitti_mean [m]", "Tran. Error Std [m]": "t_kitti_std [m]",
        "Time [ms]": "time_mean [ms]"}),
}


def printed_cells(text, labels):
    """{(row label, column name): number token} of a printed table: each
    header line names its block's columns (two or more spaces apart); a
    wrapped pandas frame repeats it a block, and pandas hides middle
    columns behind '...', which name no cell."""
    import re

    cells, header = {}, None
    for line in text.splitlines():
        tokens = line.split()
        if tokens and tokens[0] in labels and header is not None:
            if len(tokens) != len(header) + 1:
                raise AssertionError(f"table row {line!r} against the header {header}")
            cells.update(((tokens[0], col), tok) for col, tok in zip(header, tokens[1:]) if col != "...")
        elif line.startswith(" ") and line.strip():
            header = re.split(r"\s{2,}", line.strip().rstrip("\\").strip())
    return cells


def half_unit(token):
    """Half a unit in the last printed digit of a number token."""
    mantissa, _, exponent = token.lower().partition("e")
    return 0.5 * 10.0 ** (int(exponent or 0) - len(mantissa.partition(".")[2]))


def check_paper_table(name, printed, runs, with_pandas):
    """One table's stdout against the evaluation CLI's step_errors.csv of
    the runs it reads: every row, every number (to its printed precision
    from pandas, exactly from the standard-library table; NaN as NaN), and
    every column without pandas.  ``runs``: {method: run directory}."""
    import csv

    _, row_name, columns = PAPER_TABLES[name]
    csvs = {}
    for method, d in runs.items():
        with open(osp.join(d, "evaluation", "step_errors.csv"), newline="") as f:
            csvs[method] = {r["name"]: r for r in csv.DictReader(f)}
    if row_name is None:  # the DEEPCLR run's sequences
        want = {seq: row for seq, row in csvs["DEEPCLR"].items() if seq != "TOTAL"}
    else:
        want = {method: rows[row_name] for method, rows in csvs.items()}
    cells = printed_cells(printed, want)
    if not with_pandas and sorted(cells) != sorted((label, c) for label in want for c in columns):
        raise AssertionError(f"{name} without pandas: cells {sorted(cells)}")
    if not cells or {label for label, _ in cells} != set(want):
        raise AssertionError(f"{name}: rows {sorted({label for label, _ in cells})}, runs {sorted(want)}")
    for (label, column), token in cells.items():
        value = want[label][columns[column]]
        value = float("nan") if value == "" else float(value)
        if math.isnan(value) or math.isnan(float(token)):
            ok = math.isnan(value) and math.isnan(float(token))
        elif with_pandas:
            ok = abs(float(token) - value) <= half_unit(token) * (1 + 1e-9)
        else:
            ok = float(token) == value
        if not ok:
            raise AssertionError(f"{name}: {label} {column} printed {token}, the evaluation CLI {value!r}")
    if name == "kitti_odometry_table":
        line = printed.strip().splitlines()[-1]
        total = float(csvs["DEEPCLR"]["TOTAL"]["time_mean [ms]"])
        if line != f"Average Inference Time: {total:.2f} ms":
            raise AssertionError(f"{name}: {line!r} against the evaluation CLI's mean time {total}")
    return len(cells)


def run_paper_tables(tmp, kitti, modelnet, trained_dir, quiet):
    """The paper tables on card-produced runs (phase 12): the three
    scenarios through inference.run_scenario and icp_po2pl through
    icp.cli.run, each a run directory scored by the evaluation CLI; then
    each table with pandas and with pandas hidden, checked by
    check_paper_table."""
    from deepclr_tpu_torch import inference, ops
    from deepclr_tpu_torch.config import load_model_config
    from deepclr_tpu_torch.evaluation import cli as evaluation_cli
    from deepclr_tpu_torch.evaluation import scenario_from_dict
    from deepclr_tpu_torch.icp import cli as icp_cli
    from deepclr_tpu_torch.models import build_model, load_trained_model
    from deepclr_tpu_torch.paper import kitti_artificial_table, kitti_odometry_table, modelnet40_table

    base = osp.join(tmp, "paper_runs")
    os.makedirs(base)
    pairs = sorted(f[:-5] for f in os.listdir(osp.join(kitti, "pairs_test")) if f.endswith(".pack"))
    noise = [f"test_unseen_{s / 100:0.2f}" for s in range(11)]
    scenarios = {
        "kitti_04_10": ({"name": "kitti_04_10", "dataset_type": "kitti_odometry_velodyne", "sequential": True,
                         "data": {"04": osp.join(kitti, "odometry", "04.pack")}}, NPTS),
        "kitti_pairs": ({"name": "kitti_pairs", "dataset_type": "generic", "sequential": False,
                         "data": {s: osp.join(kitti, "pairs_test", f"{s}.pack") for s in pairs}}, NPTS),
        "modelnet40_unseen": ({"name": "modelnet40_unseen", "dataset_type": "generic", "sequential": False,
                               "data": {k: osp.join(modelnet, "test", f"{k}.pack") for k in noise}}, MN_POINTS),
    }
    weights = osp.join(trained_dir, "weights.pt")
    t0 = time.perf_counter()
    runs = {name: {} for name in scenarios}
    ops.reset_launch_counts()
    with torch.inference_mode():
        kitti_model = load_trained_model(load_model_config(osp.join(trained_dir, "model_config.yaml"), weights),
                                         weights)
        mn_model = build_model(modelnet_model_cfg(), device="cuda", seed=0)
        for name, (d, num_points) in scenarios.items():
            scen = scenario_from_dict(d)
            model = mn_model if name == "modelnet40_unseen" else kitti_model
            ev = inference.run_scenario(scen, model, num_points, logger=quiet)
            model_name = "modelnet40_seed0" if model is mn_model else osp.basename(trained_dir)
            runs[name]["DEEPCLR"] = write_run_dir(base, scen, "DEEPCLR", {"model_name": model_name}, ev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        runs["kitti_pairs"]["ICP_PO2PL"] = icp_cli.run(scenario_from_dict(scenarios["kitti_pairs"][0]), "icp_po2pl",
                                                        base, max_distance=ICP_MAX_DISTANCE, logger=quiet)
    missing = [k for k in SERVING_KERNELS if counts[k] < 1]
    if missing or counts["fused_sa_bwd"]:
        raise AssertionError(f"paper runs: launches {counts}")
    infer_s = time.perf_counter() - t0
    for by_method in runs.values():
        for run_dir in by_method.values():
            evaluation_cli.main([run_dir])
    out = {"inference_and_icp_s": infer_s, "launches": counts, "runs": {k: sorted(v) for k, v in runs.items()},
           "pairs_test": pairs}
    tables = {"kitti_odometry_table": kitti_odometry_table, "kitti_artificial_table": kitti_artificial_table,
              "modelnet40_table": modelnet40_table}
    for with_pandas in (True, False):
        saved = sys.modules.get("pandas", "absent")
        if not with_pandas:
            sys.modules["pandas"] = None
        try:
            for name, module in tables.items():
                with contextlib.redirect_stdout(io.StringIO()) as printed:
                    module.main([base])
                cells = check_paper_table(name, printed.getvalue(), runs[PAPER_TABLES[name][0]], with_pandas)
                out[f"{name}_{'pandas' if with_pandas else 'stdlib'}"] = {"cells_checked": cells,
                                                                          "stdout": printed.getvalue()}
        finally:
            if saved == "absent":
                sys.modules.pop("pandas", None)
            else:
                sys.modules["pandas"] = saved
    out["seconds"] = time.perf_counter() - t0
    return out


def run_cli_phase(dev, card):
    """Phase 12: the data CLIs and the inference examples, each through its
    main() as ``python -m`` runs it, in a temporary directory: synthetic raw
    KITTI and ModelNet40 layouts, every converter on them (each pack read
    back by the dataflow), a 2-micro-step training run of the shipped
    synthetic-KITTI YAML from the converted packs, both examples on the
    card (the KITTI one with that run's weights, the ModelNet40 one from
    seed 0) with fps, min_d2 and fused_sa launched, and the pose export."""
    import yaml

    from deepclr_tpu_torch import ops
    from deepclr_tpu_torch.evaluation import Evaluator

    start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        kitti, modelnet, models = osp.join(tmp, "kitti"), osp.join(tmp, "modelnet40"), osp.join(tmp, "models")
        t0 = time.perf_counter()
        run_cli("deepclr_tpu_torch.make_synthetic_kitti", [kitti, *CLI_KITTI_ARGS], {})
        run_cli("deepclr_tpu_torch.make_synthetic_modelnet", [modelnet, *CLI_MODELNET_ARGS], {})
        out["synthetic_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name in ("kitti_odometry", "kitti_pairs", "kitti_pairs_test"):
            run_cli(f"deepclr_tpu_torch.converter.{name}", [], {"KITTI_PATH": kitti})
        for name in ("modelnet40", "modelnet40_test"):
            run_cli(f"deepclr_tpu_torch.converter.{name}", [], {"MODELNET40_PATH": modelnet})
        out["converters_s"] = time.perf_counter() - t0
        packs = {"odometry/00": count_samples("kitti_odometry_velodyne", osp.join(kitti, "odometry", "00.pack")),
                 "odometry/04": count_samples("kitti_odometry_velodyne", osp.join(kitti, "odometry", "04.pack")),
                 "pairs/00": count_samples("generic", osp.join(kitti, "pairs", "00.pack")),
                 "pairs_test/00": count_samples("generic", osp.join(kitti, "pairs_test", "00.pack")),
                 "models/train": count_samples("modelnet40", osp.join(modelnet, "models", "train.pack")),
                 "test/test_unseen_0.10": count_samples("generic", osp.join(modelnet, "test",
                                                                               "test_unseen_0.10.pack"))}
        n_test = len(os.listdir(osp.join(modelnet, "test")))
        if packs["odometry/00"][0] != CLI_FRAMES - 1 or packs["odometry/00"][1][1] != 4 \
                or packs["models/train"][1][0] != MN_POINTS \
                or n_test != 22 \
                or packs["pairs/00"][0] != packs["pairs_test/00"][0]:
            raise AssertionError(f"converted packs: {packs}, {n_test} ModelNet40 test packs")
        out["packs"] = {k: [n, list(shape)] for k, (n, shape) in packs.items()}

        # two micro-steps of the shipped synthetic-KITTI recipe from the converted packs
        env = {"KITTI_PATH": kitti, "MODEL_PATH": models}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            cfg, _, _, counts, train_s = train_from_yaml(tmp, "cli_kitti", KITTI_YAML, 2)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # (the 7 m validation drive is shorter than KITTI's shortest segment: no segment errors)
        out["training"] = {"tags": check_run_dir(cfg, "cli_kitti", 2, sequential=False), "launches": counts,
                           "train_s": train_s}

        # the examples on the card: the trained run directory, and a ModelNet40 model from seed 0
        os.makedirs(osp.join(models, "modelnet40_seed0"), exist_ok=True)
        with open(osp.join(models, "modelnet40_seed0", "model_config.yaml"), "w") as f:
            yaml.safe_dump(modelnet_model_cfg(), f)
        runs = {"kitti_inference": (["--sequence", "04", "--num_frames", str(CLI_KITTI_FRAMES)],
                                    {"KITTI_PATH": kitti, "MODEL_PATH": osp.dirname(cfg.output_dir)},
                                    osp.basename(cfg.output_dir), CLI_KITTI_FRAMES - 1),
                "modelnet40_inference": (["--num_samples", str(CLI_MODELNET_SAMPLES)],
                                         {"MODELNET40_PATH": modelnet, "MODEL_PATH": models}, "modelnet40_seed0",
                                         CLI_MODELNET_SAMPLES)}
        for name, (argv, env, model_name, want) in runs.items():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            printed = run_cli(f"deepclr_tpu_torch.examples.{name}", [model_name, *argv], env)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            missing = [k for k in SERVING_KERNELS if counts[k] < 1]
            if missing or counts["fused_sa_bwd"]:
                raise AssertionError(f"{name}: launches {counts}")
            out[name] = {"translation_errors_m": printed_errors(printed, want), "launches": counts,
                         "seconds": time.perf_counter() - t0}

        # the pose export: ground truth with a drift as predictions of sequence 04
        rng = np.random.default_rng(12)
        poses = np.loadtxt(osp.join(kitti, "original", "poses", "04.txt")).reshape(-1, 3, 4)
        ev = Evaluator()
        for i in range(1, len(poses)):
            prev, cur = np.eye(4), np.eye(4)
            prev[:3], cur[:3] = poses[i - 1], poses[i]
            step = np.linalg.inv(prev) @ cur
            pred = step.copy()
            pred[:3, 3] += rng.normal(scale=0.01, size=3)
            ev.add_transforms("04", 0.1 * i, pred, step)
        pred_dir = osp.join(tmp, "predictions")
        ev.write(pred_dir)
        run_cli("deepclr_tpu_torch.export_kitti_poses", [pred_dir], {"KITTI_PATH": kitti})
        exported = np.loadtxt(osp.join(pred_dir, "kitti", "04.txt"))
        want = np.stack([p[:3].reshape(12) for p in Evaluator.read(pred_dir).get_sequence("04").prediction.poses])
        # calib.txt's Tr is the identity: the cam0 poses are the velodyne ones
        if exported.shape != want.shape or not np.allclose(exported, want, atol=1e-9):
            raise AssertionError(f"export_kitti_poses: {exported.shape} rows against {want.shape}")
        out["export_kitti_poses_rows"] = len(exported)
        out["paper_tables"] = run_paper_tables(tmp, kitti, modelnet, cfg.output_dir,
                                               logging.getLogger("chip_smoke.paper"))
    out["seconds"] = time.perf_counter() - start
    emit({"check": "cli", **out})
    emit({"phase": "cli", "seconds": out["seconds"], "paper_tables_s": out["paper_tables"]["seconds"],
          "card": card})


def run_torchrun_ranks(path, out_dir, n):
    """``n`` ranks of dp_rank_main started by torchrun with
    DEEPCLR_DISTRIBUTED=1 (the launch README.md gives; NCCL, one card a
    rank)."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={n}", f"--master_port={free_port()}",
           osp.join(REPO, "chip_smoke.py"), "--dp-rank", path, out_dir]
    proc = subprocess.Popen(cmd, env=dict(os.environ, DEEPCLR_DISTRIBUTED="1"), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return wait_ranks([proc], out_dir, n)


def run_multi_card(card, n):
    """``chip_smoke.py --dp-cards``: phase 11's comparison across the
    host's n cards (NCCL, torchrun), against one process of the global
    batch (n x 5 pairs) on card 0, then each rank's micro-step timing."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        packs_s = write_dp_packs(tmp, ranks=n)
        global_yaml = dp_yaml(tmp, "global", n * TRAIN_BATCH)
        _, _, ref_scalars, ref_weights = dp_train_in_process(global_yaml, nccl=False)
        ranks = run_torchrun_ranks(dp_yaml(tmp, "cards", TRAIN_BATCH), osp.join(tmp, "cards_out"), n)
        result = check_ranks(f"{n} NCCL ranks", osp.join(tmp, "cards"), ref_scalars, ref_weights,
                             initial_weights(global_yaml), ranks)
        emit({"check": "data_parallel_cards", "ranks": n, "vs_global_batch": result,
              "tolerances": {"loss": [DP_LOSS_RTOL, DP_LOSS_ATOL], "val": DP_VAL_TOL, "weights": DP_WEIGHT_TOL},
              "lr": DP_LR})
        plain = dp_train_in_process(dp_yaml(tmp, "time_plain", TRAIN_BATCH, DP_TIMING_STEPS), False,
                                    DP_TIMING_STEPS)[0]
        timed = run_torchrun_ranks(dp_yaml(tmp, "time_cards", TRAIN_BATCH, DP_TIMING_STEPS),
                                   osp.join(tmp, "time_out"), n)
        emit({"data_parallel_cards_timing": {
            "micro_step_ms": {"no_group_card_0": micro_step_ms(plain.step_ms),
                              **{f"nccl_rank_{r['rank']}": micro_step_ms(r["step_ms"]) for r in timed}},
            "micro_step_ms_each": {"no_group_card_0": plain.step_ms,
                                   **{f"nccl_rank_{r['rank']}": r["step_ms"] for r in timed}},
            "micro_steps_a_run": DP_TIMING_STEPS, "grad_bytes_all_reduced_per_update": ranks[0]["grad_bytes"],
            "launches_per_micro_step": [r["step_launches"] for r in ranks], "packs_s": packs_s}, "card": card})
    emit({"phase": "data_parallel_cards", "seconds": time.perf_counter() - start})


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
        check_modelnet_kernels(dev)
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
    with torch.inference_mode():
        frames, _, deepclr_run = run_scenario_phase(model, dev)
        time_scenario(model, dev, frames, metrics["forward_pairs_per_s"], card)
    trained_run, raycast = run_yaml_training_phase(dev, card)
    with torch.inference_mode():
        run_icp_phase(dev, card, {"deepclr_phase7": deepclr_run, "deepclr_phase8_04": trained_run})
    run_variants_phase(model, dev, card, metrics["forward_pairs_per_s"], raycast)
    dp_launches = run_data_parallel_phase(card)
    run_cli_phase(dev, card)
    launches = {**{k: serve_counts[k] for k in SERVING_KERNELS},
                **{k: train_counts[k] for k in ("fused_sa_bwd", *OWN_KERNELS)},
                "fused_sa_argmax": argmax_counts["fused_sa_argmax"]}
    rows = []
    for name, (source, replaces) in {**TPU_KERNELS, **OWN_KERNELS}.items():
        k = kernels[name]
        bound_ms, bound_by = k["bound"]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": k.get("library_ms"), "device_ms": k["device_ms"],
                     "launches_dp_micro_step": dp_launches[-1].get(name, 0), "own": name in OWN_KERNELS,
                     **({"bound_issue_ms": k["bound_issue_ms"]} if "bound_issue_ms" in k else {})})
    emit({"launches_train_path_4_micro_steps": train_counts})
    emit({"kernels": rows})
    print(f"nvidia-smi: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


def cards_main():
    """``chip_smoke.py --dp-cards``: data parallel across every card of the
    host (at least two); the device line, then the card's name and power
    limit, and the ok line as main() prints them."""
    if torch.cuda.device_count() < 2:
        print("chip_smoke --dp-cards: needs two or more CUDA cards", file=sys.stderr)
        return 1
    from deepclr_tpu_torch import ops

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi.splitlines()})
    ops.build_all()
    run_multi_card(smi.splitlines()[0], torch.cuda.device_count())
    print(f"nvidia-smi: {smi.splitlines()[0]}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dp-cards"]:
        sys.exit(cards_main())
    sys.exit(main())
