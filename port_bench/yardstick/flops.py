"""Algorithmic FLOPs of one DeepCLR registration and the card's peaks.

``model_flops_per_pair`` is a frozen copy of
``deepclr_tpu_torch/utils/flops.py::model_flops_per_pair``: the forward
FLOPs of one cloud pair under the published semantics (nsample-capped
balls, the k-NN motion embedding, the exact MLP widths), multiply + add = 2.
It reads 10.091237376 GFLOP for the KITTI flagship at 16384 points and
4.38593536 GFLOP for the ModelNet40 model at 2048.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16, dense
PEAK_FP32_FLOPS = 67e12    # CUDA cores, float32, no tensor cores
PEAK_HBM_BYTES = 3.35e12   # HBM3 bytes/s


def _mlp_macs(rows: int, dims) -> int:
    return sum(rows * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def model_flops_per_pair(model_cfg, num_points: int) -> float:
    """Algorithmic forward FLOPs for one pair."""
    params = model_cfg["params"]
    feat_dim = int(model_cfg.get("input_dim", 3)) - 3
    macs = 0
    cf = params["cloud_features"]["params"]
    n = num_points
    out_feat = 0
    for stage in range(len(cf["npoint"])):
        p = int(cf["npoint"][stage])
        cin = feat_dim if stage == 0 else out_feat
        out_feat = 0
        for ns, widths in zip(cf["nsamples"][stage], cf["mlps"][stage]):
            macs += _mlp_macs(p * int(ns), [3 + cin] + list(widths))
            out_feat += widths[-1]
        n = p
    macs *= 2  # two clouds encoded per pair

    mg = params["merge"]["params"]
    k = int(mg["k"])
    merge_mlp = list(mg["mlp"])
    p = n
    macs += p * p * 3
    macs += _mlp_macs(p * k, [3 + out_feat * 2] + merge_mlp)

    out = params["output"]["params"]
    macs += _mlp_macs(p, [3 + merge_mlp[-1]] + list(out["mlp"]))
    macs += _mlp_macs(1, list(out["linear"]))
    macs += list(out["linear"])[-1] * 8
    return 2.0 * macs
