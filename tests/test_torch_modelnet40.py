"""The port at the ModelNet40 recipe's widths (``configs.MODELNET40_MODEL_CFG``:
xyz only, radii 0.1 / 0.2, MLPs [16, 16, 32] x 2, k 30, embedding radius
0.2, the published head) against the benchmark's plain float32 reference
(``port_bench/reference/deepclr.py``), on the CPU at a small size: 3
self-pairs of 512 CAD points moved by the recipe's motion
(``synthetic.cad_train_batch``), 64 centres, weights from the
benchmark's seed (``port_bench/weights.py``).  Poses, the recipe's loss
and every leaf's gradient, at float32 and at bf16; the embedding's radius
cuts most of its pairs here, and a pair beyond it passes nothing back."""
import copy
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from deepclr_tpu_torch import configs
from deepclr_tpu_torch.geometry import se3
from deepclr_tpu_torch.losses import make_loss_fn
from deepclr_tpu_torch.models import build_model
from deepclr_tpu_torch.models.deepclr import MotionEmbedding
from deepclr_tpu_torch.synthetic import cad_train_batch
from port_bench.reference import deepclr as ref
from port_bench.reference import ops as ref_ops
from port_bench.weights import make_weights

REPO = Path(__file__).resolve().parents[1]

LOSS = configs.MODELNET40_TRAIN_CFG["metrics"]["loss"]
PAIRS, POINTS, CENTRES, SEED = 3, 512, 64, 2

# (pose, loss, grad) tolerances.  float32: the port and the reference sum
# in other orders (the fused ball twin, the split first embedding layer),
# ~1e-7 a rounding; seeds 1-6 read pose <= 3.1e-8, loss <= 1e-7 and a
# leaf's difference <= 9.2e-7 of its norm, so 100x room.  bf16: the port's
# tail layers round to 8 bits (2^-8 = 0.0039 a rounding): the pose within
# half a bf16 ulp of its largest component (seeds 1-6: <= 4.3e-4; the
# float8 control >= 3.3e-3), the loss within 0.5% (<= 1.5e-3).  A bf16
# gradient routes the max over a ball or the neighbours to another row
# wherever two round alike, which turns a leaf's gradient but hardly
# changes its norm: its norm within 15% of the larger of its reference
# norm and the median leaf's (seeds 1-6: <= 6.2%), as the benchmark's
# ``grad`` measures it.
TOLERANCE = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (2e-3, 5e-3, 0.15)}


def _cfg(dtype):
    cfg = copy.deepcopy(configs.MODELNET40_MODEL_CFG)
    cfg["params"]["compute_dtype"] = dtype
    cfg["params"]["cloud_features"]["params"]["npoint"] = [CENTRES]
    return cfg


def _batch():
    return {k: torch.from_numpy(v) for k, v in cad_train_batch(PAIRS, POINTS, SEED).items()}


def _leaf_gaps(got, want, by_norm):
    """Each leaf's gap over the larger of its reference norm and the median
    leaf's: of the difference, or (``by_norm``) of the norms."""
    norms = {n: float(want[n].norm()) for n in want}
    med = statistics.median(norms.values())
    if by_norm:
        return {n: abs(float(got[n].norm()) - norms[n]) / max(norms[n], med) for n in want}
    return {n: float((got[n] - want[n]).norm()) / max(norms[n], med) for n in want}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    """(dtype, program's and reference's (pose, loss, gradients), control's)."""
    cfg = _cfg(request.param)
    weights = make_weights(cfg, SEED, "cpu")
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(weights)
    b = _batch()
    y, _ = model(b["template"], b["source"], b["template_mask"], b["source_mask"])
    loss = make_loss_fn(LOSS, "pose3d_dual_quat")(y, b["y"])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, [p for _, p in model.named_parameters()])))

    def reference(lowp):
        live = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
        yr = ref.forward(live, cfg, b["template"], b["source"], b["template_mask"], b["source_mask"], lowp=lowp)
        lr = ref.loss(yr, b["y"], LOSS)
        return yr.detach(), float(lr.detach()), dict(zip(live, torch.autograd.grad(lr, list(live.values()))))

    return request.param, (y.detach(), float(loss.detach()), grads), reference(False), reference(True)


def _gaps(dtype, got, want):
    y, loss, grads = got
    yr, lr, gr = want
    pose = float((y - yr).abs().max() / yr.abs().max())
    return pose, abs(loss - lr) / abs(lr), max(_leaf_gaps(grads, gr, by_norm=dtype == "bfloat16").values())


def test_poses_match_the_reference(run):
    dtype, got, want, _ = run
    assert got[0].shape == (PAIRS, 8)
    assert _gaps(dtype, got, want)[0] <= TOLERANCE[dtype][0]


def test_loss_matches_the_reference(run):
    dtype, got, want, _ = run
    assert _gaps(dtype, got, want)[1] <= TOLERANCE[dtype][1]


def test_every_leafs_gradient_matches_the_reference(run):
    dtype, got, want, _ = run
    assert set(got[2]) == set(want[2]) and all(torch.isfinite(g).all() for g in got[2].values())
    assert _gaps(dtype, got, want)[2] <= TOLERANCE[dtype][2]


def test_the_float8_control_fails_a_bf16_tolerance(run):
    """The reference at float8 e4m3 in the program's place is outside at
    least one bf16 tolerance: they tell a lower precision apart."""
    dtype, _, want, control = run
    assert any(g > t for g, t in zip(_gaps("bfloat16", control, want), TOLERANCE["bfloat16"]))


def test_the_radius_cuts_most_of_the_embeddings_pairs():
    """Of each template centre's 30 nearest source centres, more than half
    lie at or beyond the radius 0.2 at this size."""
    cfg = _cfg("float32")
    weights = make_weights(cfg, SEED, "cpu")
    b = _batch()
    with torch.no_grad():
        feats = ref.encode(weights, cfg, torch.cat([b["template"], b["source"]]))
    d2 = ref_ops.pairwise_sqdist(feats[:PAIRS, :, :3], feats[PAIRS:, :, :3])
    nearest = torch.sort(d2, dim=-1).values[..., :cfg["params"]["merge"]["params"]["k"]]
    assert float((nearest >= 0.2 ** 2).float().mean()) > 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbours_beyond_the_radius_pass_nothing(dtype):
    """Every source centre 10 m from every template centre: the embedding's
    feature is zero, and so are the gradients of its MLP, of the source
    and of the template's features through it."""
    me = configs.MODELNET40_MODEL_CFG["params"]["merge"]["params"]
    emb = MotionEmbedding(64, me["mlp"], k=me["k"], radius=me["radius"],
                          compute_dtype=getattr(torch, dtype))
    gen = torch.Generator().manual_seed(5)
    feats0 = torch.randn(2, 40, 67, generator=gen)
    feats1 = torch.randn(2, 40, 67, generator=gen)
    feats1[..., :3] = feats0[..., :3] + 10.0
    feats0.requires_grad_(True)
    feats1.requires_grad_(True)
    out = emb(feats0, feats1)
    assert torch.equal(out[..., 3:], torch.zeros_like(out[..., 3:]))
    (out * torch.randn(out.shape, generator=gen)).sum().backward()
    assert all(torch.count_nonzero(p.grad) == 0 for p in emb.parameters())
    assert torch.count_nonzero(feats1.grad) == 0 and torch.count_nonzero(feats0.grad[..., 3:]) == 0


def test_the_recipe_is_a_faithful_copy():
    with open(REPO / "configs" / "training" / "modelnet40.yaml") as f:
        recipe = yaml.safe_load(f)
    assert configs.MODELNET40_MODEL_CFG == recipe["model"]
    for section in ("metrics", "optimizer", "scheduler", "logging"):
        assert configs.MODELNET40_TRAIN_CFG[section] == recipe[section], section
    assert configs.MODELNET40_TRAIN_CFG["data_loader"] == {"batch_size": recipe["data_loader"]["batch_size"]}


def test_the_cad_batch_is_the_recipes_self_pair():
    """The template is the label's motion of the source, to the point noise."""
    b = cad_train_batch(PAIRS, POINTS, SEED)
    m = se3.dualquat_to_matrix(torch.from_numpy(b["y"]).double()).numpy()
    moved = np.einsum("bij,bnj->bni", m[:, :3, :3], b["source"]) + m[:, None, :3, 3]
    assert (moved - b["template"]).std() == pytest.approx(0.02 * np.sqrt(2), rel=0.1)
    assert np.all(np.abs(m[:, :3, 3]) <= 0.1 + 1e-6)
