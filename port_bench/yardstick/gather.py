"""Least device time of a micro-step's gather backwards, counted from the
configuration's widths and the batch, never from the program's operands.

The one gather that carries a gradient in a training step is the motion
embedding's: the source clouds' layer-1 rows A (B, P, H1), float32,
gathered at the k nearest source centres of each of the P template
centres (H1 the embedding MLP's first width, P the last stage's centres).
Its backward sums each source row's cotangents: the float32 cotangent
(B, P k, H1) and the int64 index (B, P k) read once, the float32 sum
(B, P, H1) written once, and one addition a cotangent element
(``roofline.least_seconds``: the larger of operations over the float32
peak and bytes over HBM bandwidth).
"""
from __future__ import annotations

from .flops import PEAK_FP32_FLOPS
from .roofline import least_seconds


def gather_bwd_least(model_cfg, pairs: int) -> float:
    """The gather backwards of one micro-step of ``pairs`` pairs."""
    p = int(model_cfg["params"]["cloud_features"]["params"]["npoint"][-1])
    me = model_cfg["params"]["merge"]["params"]
    k, h1 = int(me["k"]), int(me["mlp"][0])
    rows = pairs * p * k
    nbytes = rows * h1 * 4 + rows * 8 + pairs * p * h1 * 4
    return least_seconds(rows * h1, PEAK_FP32_FLOPS, nbytes)
