"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips without
one; the file imports neither jax nor deepclr_tpu, so it runs on a machine
that has only PyTorch.  Run on the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda -p no:cacheprovider
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.configs import KITTI_MODEL_CFG  # noqa: E402
from deepclr_tpu_torch.models import ModelInferenceHelper, build_model  # noqa: E402
from deepclr_tpu_torch.ops import fps, fused_sa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _cloud(b, n, seed, grid=False):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(b, n, 3)) * np.array([30.0, 30.0, 2.0])
    if grid:  # equal distances: the tie rule decides
        xyz = np.round(xyz / 4)
    return torch.from_numpy(xyz.astype(np.float32))


def _mask(b, n):
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[0, n // 2:] = False
    mask[-1] = False
    return mask


# n covers every per-thread template of csrc/fps.cu (4, 8 and 16 points) at
# C = 1 and ragged index ranges at every C; None is cluster_size's choice
@pytest.mark.parametrize("n", [100, 1000, 6000, 16384])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
def test_fps_kernel_bit_exact(dev, n, grid, cluster):
    xyz, mask = _cloud(3, n, seed=n, grid=grid), _mask(3, n)
    npoint = min(n, 256)
    got = ops.furthest_point_sample(xyz.to(dev), npoint, mask.to(dev), cluster=cluster)
    ref = fps._fps_plain(xyz, npoint, mask)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


# the path's shapes: the sequential step (1 cloud), the train encode (10)
# and the serving encode (32), 16384 -> 1024, at the rule's cluster size
@pytest.mark.parametrize("b", [1, 10, 32])
def test_fps_kernel_bit_exact_at_path_shapes(dev, b):
    xyz = _cloud(b, 16384, seed=b).to(dev)
    mask = torch.ones(b, 16384, dtype=torch.bool, device=dev)
    if b > 1:
        mask[0, 12000:] = False
    counts = dict(ops.launch_counts())
    got = ops.furthest_point_sample(xyz, 1024, mask)
    assert ops.launch_counts()["fps"] == counts["fps"] + 1
    assert torch.equal(got, fps._fps_plain(xyz, 1024, mask))


def test_fps_cluster_rule_fits_the_card(dev):
    """The rule's choice at the path's shapes is a cluster size the card
    holds B of at once."""
    for b in (1, 10, 32):
        c = fps.device_cluster_size(dev, b, 16384)
        assert c in fps.CLUSTER_SIZES and fps._max_active_clusters(dev, 16384, c) >= b


def test_fps_kernel_rejects_oversized_clouds(dev):
    with pytest.raises(ValueError, match="exceeds"):
        ops.furthest_point_sample(torch.zeros(1, fps.FPS_MAX_POINTS + 1, 3, device=dev), 8)
    with pytest.raises(ValueError, match="exceeds"):
        ops.furthest_point_sample(torch.zeros(1, fps.MAX_POINTS_PER_CTA + 1, 3, device=dev), 8, cluster=1)


@pytest.mark.parametrize("n,p", [(16384, 1024), (1000, 300)])
def test_min_d2_kernel_exact(dev, n, p):
    xyz, mask = _cloud(2, n, seed=1), _mask(2, n)
    centers = _cloud(2, p, seed=2)
    pts4 = fused_sa._pack_points(xyz, mask)
    got = fused_sa.block_min_d2(pts4.to(dev), centers.to(dev))
    ref = fused_sa.block_min_d2(pts4, centers)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


# the path's shapes (16384 -> 1024); ragged chunks and tiles; grid clouds
# whose integer d^2 tie with r2max = 1
@pytest.mark.parametrize("n,p,grid", [(16384, 1024, False), (1000, 300, True), (1000, 40, False)])
def test_min_d2_cull_kernel_equals_twin(dev, n, p, grid):
    """One launch writes min-d^2 and the culling bitmap; both equal the
    plain path's, and the bitmap equals cull_bitmap of the kernel's min-d^2."""
    xyz = ops.spatial_sort(_cloud(2, n, seed=3, grid=grid))[0]
    centers = xyz[:, ::n // p][:, :p].contiguous()
    pts4 = fused_sa._pack_points(xyz, _mask(2, n))
    counts = dict(ops.launch_counts())
    got_d2, got = fused_sa.block_min_d2_and_cull(pts4.to(dev), centers.to(dev), 1.0)
    assert ops.launch_counts()["min_d2"] == counts["min_d2"] + 1
    ref_d2, ref = fused_sa.block_min_d2_and_cull(pts4, centers, 1.0)
    assert torch.equal(got_d2.cpu(), ref_d2) and torch.equal(got.cpu(), ref)
    assert torch.equal(got, fused_sa.cull_bitmap(got_d2, 1.0))
    assert 0 < ref.float().mean() < 1 and not ref[1].any()


def _bundle(widths, seed):
    rng = np.random.default_rng(seed)
    dims = [4, *widths]
    sw = [[torch.from_numpy((rng.normal(size=(dims[i], dims[i + 1])) * 0.3).astype(np.float32))
           for i in range(3)] for _ in range(2)]
    sb = [[torch.from_numpy((rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32))
           for i in range(3)] for _ in range(2)]
    return ops.multi_scale_bundle(sw, sb, (0.5, 1.0))


# (n, p) with ragged point chunks and centre tiles
@pytest.mark.parametrize("n,p", [(4096, 512), (1000, 40)])
# the twin rounds to the compute dtype where the kernel does: both agree to float32 summation order
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sa_kernel_matches_plain(dev, n, p, dtype):
    pts = _cloud(3, n, seed=3) / 10
    xyz = ops.spatial_sort(pts)[0]
    mask = _mask(3, n)
    centers = xyz[:, :: n // p][:, :p].contiguous()
    feats = torch.rand(3, n, 1, generator=torch.Generator().manual_seed(4))
    w, b, radius = _bundle((16, 16, 32), seed=5)
    ref = ops.ball_mlp_max(xyz, centers, w, b, radius, feats, mask, dtype)
    got = ops.ball_mlp_max(xyz.to(dev), centers.to(dev), [x.to(dev) for x in w], [x.to(dev) for x in b],
                           radius, feats.to(dev), mask.to(dev), dtype).cpu()
    assert (ref[0] != 0).float().mean() > 0.3
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5 * max(1.0, ref.abs().max().item()), rtol=0)
    assert not got[-1].any()


def test_fused_sa_kernel_rejects_uncompiled_widths(dev):
    xyz = torch.rand(1, 256, 3, device=dev)
    w, b, radius = _bundle((8, 8, 16), seed=6)
    with pytest.raises(ValueError, match="not compiled"):
        ops.ball_mlp_max(xyz, xyz[:, :16].contiguous(), [x.to(dev) for x in w], [x.to(dev) for x in b],
                         radius, compute_dtype=torch.float32)


def _dense_cloud(b, n, side, seed):
    """Points uniform in a cube of ``side`` m: 4096 in 4 m hold ~33 points
    a 0.5 m ball and ~270 a 1 m ball."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, side, size=(b, n, 3)).astype(np.float32))


def _sa_operands(n, p, dtype, seed, dev, tie_at_zero=False, dense=False):
    """Prepared fused-SA operands of 3 sorted clouds (one with a masked
    tail, one all masked) on ``dev``; with ``tie_at_zero`` the first 8
    output columns have a bias so negative that every value is 0; with
    ``dense`` the points fill a 4 m cube (tens of points a ball)."""
    pts = _dense_cloud(3, n, 4.0, seed) if dense else _cloud(3, n, seed=seed) / 10
    xyz = ops.spatial_sort(pts)[0]
    centers = xyz[:, :: n // p][:, :p].contiguous()
    feats = torch.rand(3, n, 1, generator=torch.Generator().manual_seed(seed + 1))
    w, b, radius = _bundle((16, 16, 32), seed=seed + 2)
    if tie_at_zero:
        b[-1] = b[-1].clone()
        b[-1][:8] = -100.0
    op = fused_sa.prepare(xyz.to(dev), centers.to(dev), [x.to(dev) for x in w], [x.to(dev) for x in b],
                          radius, feats.to(dev), _mask(3, n).to(dev), dtype)
    active = fused_sa.block_min_d2_and_cull(op.pts4, op.centers, op.r2max)[1] if op.pts4.is_cuda else None
    return op, active


def _assert_close_to_scale(got, ref, rel, what):
    scale = max(1e-3, ref.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=rel * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("n,p", [(4096, 512), (1000, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie_at_zero", [False, True])
def test_fused_sa_argmax_kernel_matches_plain(dev, n, p, dtype, tie_at_zero):
    """Values equal the forward kernel's bit for bit; indices equal the
    twin's everywhere (both take the lowest index among equal maxima, ties
    at 0 included); -1 exactly on empty balls."""
    op, active = _sa_operands(n, p, dtype, 7, dev, tie_at_zero)
    out, jstar = fused_sa.fused_sa_argmax(op, active)
    ref_out, ref_j = fused_sa._fused_sa_argmax_plain(op)
    assert torch.equal(out, fused_sa.fused_sa_core(op, active))
    _assert_close_to_scale(out, ref_out, 1e-5, "out")
    assert torch.equal(jstar, ref_j)
    assert (jstar[-1] == -1).all() and (jstar[0] >= 0).float().mean() > 0.3
    if tie_at_zero:
        assert (out[..., :8] == 0).all() and (jstar[:2, :, :8] >= 0).any()


# The kernel sums dW, db, dbc and da with atomics, in an order that changes
# from run to run; 1e-4 of each result's scale bounds that float32 spread.
# B4 is fed B2's output, so its recompute must select B2's winners; the
# path's shape (16384 -> 1024) and dense balls included.
@pytest.mark.parametrize("n,p,dense", [(4096, 512, False), (1000, 40, False), (4096, 512, True),
                                       (16384, 1024, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie_at_zero", [False, True])
def test_fused_sa_bwd_kernel_matches_plain(dev, n, p, dense, dtype, tie_at_zero):
    op, active = _sa_operands(n, p, dtype, 9, dev, tie_at_zero, dense)
    g = torch.randn(op.bc.shape[:2] + (64,), generator=torch.Generator().manual_seed(10)).to(dev)
    got = fused_sa.fused_sa_bwd(op, active, fused_sa.fused_sa_core(op, active), g)
    ref = fused_sa._fused_sa_bwd_plain(op, fused_sa._fused_sa_plain(op), g)
    for what, x, y in zip(["da", "dbc", "dw2", "dw3", "db2", "db3"], [got[0], got[1], *got[2], *got[3]],
                          [ref[0], ref[1], *ref[2], *ref[3]]):
        _assert_close_to_scale(x, y, 1e-4, what)
    assert got[2][1].abs().max() > 0 and not got[0][-1].any() and not got[1][-1].any()
    if tie_at_zero:  # relu' is 0 at a clamped value: the tied-at-0 columns give nothing
        assert not got[2][1][:, :8].any() and not got[3][1][:8].any()


def test_fused_sa_backward_kernels_reject_uncompiled_widths(dev):
    xyz = torch.rand(1, 256, 3, device=dev)
    w, b, radius = _bundle((8, 8, 16), seed=6)
    op = fused_sa.prepare(xyz, xyz[:, :16].contiguous(), [x.to(dev) for x in w], [x.to(dev) for x in b],
                          radius, compute_dtype=torch.float32)
    active = fused_sa.block_min_d2_and_cull(op.pts4, op.centers, op.r2max)[1]
    with pytest.raises(ValueError, match="not compiled"):
        fused_sa.fused_sa_argmax(op, active)
    with pytest.raises(ValueError, match="not compiled"):
        fused_sa.fused_sa_bwd(op, active, torch.zeros(1, 16, 16, device=dev), torch.zeros(1, 16, 16, device=dev))


@pytest.mark.parametrize("backward", ["kernel", "argmax"])
@pytest.mark.parametrize("dense", [False, True])
def test_function_gradients_on_card_match_cpu(dev, backward, dense):
    """ball_mlp_max's autograd Function: every input's gradient on the card
    (B5 / B2 + B4 kernels) against the CPU (plain twins); ``dense`` puts
    ~30 points in a 0.5 m ball."""
    pts = _dense_cloud(2, 2048, 3.2, seed=11) if dense else _cloud(2, 2048, seed=11) / 10
    xyz = ops.spatial_sort(pts)[0]
    feats = torch.rand(2, 2048, 1, generator=torch.Generator().manual_seed(12))
    mask = _mask(2, 2048)
    w, b, radius = _bundle((16, 16, 32), seed=13)
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = [t.detach().to(where).requires_grad_() for t in (*w, *b, xyz, feats)]
        x, f = leaves[-2], leaves[-1]
        centers = x[:, ::8]
        counts = dict(ops.launch_counts())
        out = ops.ball_mlp_max(x, centers, leaves[:3], leaves[3:6], radius, f, mask.to(where),
                               torch.float32, backward=backward)
        (out ** 2).sum().backward()
        grads[where] = [t.grad.cpu() for t in leaves]
        launched = {k: v - counts[k] for k, v in ops.launch_counts().items()}
        if where == "cuda":
            assert launched["fused_sa_argmax" if backward == "argmax" else "fused_sa"] == 1
            assert launched["fused_sa_bwd"] == (backward == "kernel")
        else:
            assert not any(launched.values())
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        _assert_close_to_scale(g_card, g_cpu, 1e-4, "grad")


def test_dropout_trains_on_the_card(dev):
    """The pose head's dropout on the card: each ``linear`` output 0 or
    exactly eval's / keep, the masks set by (seed, step), and a micro-step
    of make_train_step leaves finite gradients."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["dropout"] = 0.5
    cfg["params"]["compute_dtype"] = "float32"
    cfg["params"]["cloud_features"]["params"]["npoint"] = [64]
    cfg["params"]["output"]["params"]["linear"] = [1024, 512]  # one layer: its output is one dropout's
    model = build_model(cfg, device="cuda", seed=14)
    head = model.output
    x = torch.randn(4, 64, head.conv.dense(0).weight.shape[1], generator=torch.Generator().manual_seed(15)).to(dev)
    with torch.no_grad():
        ev = head.eval().features(x)
        head.train()
        head.seed_dropout(3)
        tr = head.features(x)
        head.seed_dropout(3)
        again = head.features(x)
        head.seed_dropout(4)
        other = head.features(x)
    assert tr.is_cuda and torch.equal(tr, again) and not torch.equal(tr, other)
    assert bool(((tr == 0) | (tr == ev * 2)).all())
    share = (tr[ev != 0] == 0).float().mean().item()
    assert abs(share - 0.5) < 5 * np.sqrt(0.25 / int((ev != 0).sum()))

    from deepclr_tpu_torch.configs import KITTI_TRAIN_CFG
    from deepclr_tpu_torch.engine import create_train_state, make_train_step
    from deepclr_tpu_torch.losses import make_loss_fn
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                           make_loss_fn(KITTI_TRAIN_CFG["metrics"]["loss"], "pose3d_dual_quat"), {},
                           accumulation_steps=2)
    rng = np.random.default_rng(16)
    t = np.concatenate([rng.normal(size=(2, 2048, 3)) * [3.0, 3.0, 0.5], rng.uniform(size=(2, 2048, 1))], -1)
    batch = {"template": t.astype(np.float32), "source": (t + rng.normal(size=t.shape) * 0.01).astype(np.float32),
             "y": np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32), (2, 1))}
    assert np.isfinite(float(step(create_train_state(model), batch, 1e-3)["loss"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and g.is_cuda and torch.isfinite(g).all() for g in grads.values())
    assert all(grads[n].abs().max() > 0 for n in grads if n.startswith("_merge_layers.1.linear"))


def test_model_on_card_matches_cpu(dev):
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["cloud_features"]["params"]["npoint"] = [256]
    card = build_model(cfg, device="cuda", seed=7)
    cpu = build_model(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(8)
    clouds = [np.concatenate([rng.normal(size=(5000, 3)) * [30, 30, 2], rng.uniform(size=(5000, 1))], 1)
              .astype(np.float32) for _ in range(4)]
    ops.reset_launch_counts()
    y_card = ModelInferenceHelper(card, num_points=4096).predict_batch(clouds[:2], clouds[2:])
    counts = ops.launch_counts()
    assert counts == {"fps": 1, "min_d2": 1, "fused_sa": 1, "fused_sa_argmax": 0, "fused_sa_bwd": 0}
    y_cpu = ModelInferenceHelper(cpu, num_points=4096).predict_batch(clouds[:2], clouds[2:])
    np.testing.assert_allclose(y_card, y_cpu, atol=2e-2, rtol=0)


def test_uint16_upload_dequantises_on_the_card(dev):
    """The int16-bits upload widens and dequantises on the card to the
    CPU's values."""
    from deepclr_tpu_torch.models.base import device_batch, host_batch, pad_cloud

    rng = np.random.default_rng(9)
    padded = [pad_cloud((rng.normal(size=(20000, 4)) * [60, 60, 3, 1]).astype(np.float32), 16384, rng)
              for _ in range(2)]
    host = host_batch(padded, "uint16")
    got, mask = device_batch(host, dev)
    ref, ref_mask = device_batch(host, torch.device("cpu"))
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got.cpu(), ref) and torch.equal(mask.cpu(), ref_mask)


@pytest.mark.parametrize("presorted", [False, True])
def test_batched_sequential_on_card_matches_cpu(dev, presorted):
    """Two lanes of subsampled 5000-point frames, uint16 uploads, on the
    card and on the CPU (the bf16 bound of test_model_on_card_matches_cpu)."""
    from deepclr_tpu_torch.models import BatchedSequentialHelper

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["cloud_features"]["params"]["npoint"] = [256]
    cfg["params"]["presorted"] = presorted
    helpers = [BatchedSequentialHelper(build_model(cfg, device=d, seed=7), batch=2, num_points=4096,
                                       upload_dtype="uint16") for d in ("cuda", "cpu")]
    rng = np.random.default_rng(10)
    for t in range(3):
        frames = [np.concatenate([rng.normal(size=(5000, 3)) * [30, 30, 2], rng.uniform(size=(5000, 1))], 1)
                  .astype(np.float32) for _ in range(2)]
        got, ref = (h.step(frames) for h in helpers)
        if t == 0:
            assert got == ref == [None, None]
        else:
            np.testing.assert_allclose(np.stack(got), np.stack(ref), atol=2e-2, rtol=0)


# The JAX contract (deepclr_tpu/models/base.py, tests/model/test_modules.py):
# B lock-step lanes equal B single helpers within 1e-5 at float32.  The
# flagship widths at compute_dtype float32, on 16384-point clouds (no host
# subsample, so every run pads nothing and draws nothing).  Every kernel and
# the encode work per cloud; the head's GEMMs (M = B x 1024 rows) pick their
# cuBLAS kernel by the row count, so their float32 sums run in another
# order, well inside 1e-5.  At bfloat16 each such layer then rounds to bf16,
# which turns that float32 difference into whole bf16 steps (4e-3 to 5e-3 on
# the labels in chip_smoke.py phase 7): only float32 holds 1e-5.
F32_BATCH_TOL = 1e-5


def test_float32_predictions_do_not_depend_on_the_batch(dev):
    from deepclr_tpu_torch.models import BatchedSequentialHelper
    from deepclr_tpu_torch.synthetic import kitti_like_sequence

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["compute_dtype"] = "float32"
    model = build_model(cfg, device="cuda", seed=0)
    frames = [kitti_like_sequence(4, 16384, seed=s)[0] for s in (20, 21)]
    batched = BatchedSequentialHelper(model, batch=2, num_points=16384, seed=0)
    singles = [ModelInferenceHelper(model, is_sequential=True, num_points=16384, seed=i) for i in range(2)]
    lanes = 0.0
    for t in range(4):
        got = batched.step([frames[0][t], frames[1][t]])
        for i, single in enumerate(singles):
            ref = single.predict(frames[i][t])
            assert (got[i] is None) == (ref is None) == (t == 0)
            if ref is not None:
                lanes = max(lanes, float(np.abs(got[i] - ref).max()))
    helper = ModelInferenceHelper(model, num_points=16384)
    sources, templates = frames[0], frames[1]
    four = helper.predict_batch(sources, templates)
    one = np.concatenate([helper.predict_batch(sources[i:i + 1], templates[i:i + 1]) for i in range(4)])
    pairs = float(np.abs(four - one).max())
    assert lanes <= F32_BATCH_TOL and pairs <= F32_BATCH_TOL, (lanes, pairs)


def _modelnet40_model_cfg():
    import os.path as osp

    import yaml

    with open(osp.join(osp.dirname(__file__), "..", "configs", "training", "modelnet40.yaml")) as f:
        return yaml.safe_load(f)["model"]


# The ModelNet40 recipe's shape: 10 CAD clouds x 2048 points (below
# SORT_MIN_POINTS, so unsorted) -> 512 centres, radii 0.1 / 0.2, no point
# features; the tolerances of the kernel cases above.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_modelnet40_shape(dev, dtype):
    from deepclr_tpu_torch.data.synthetic import cad_cloud

    cfg = _modelnet40_model_cfg()
    cfg["params"]["compute_dtype"] = "float32" if dtype == torch.float32 else "bfloat16"
    sa = build_model(cfg, device="cuda", seed=0).cloud_features._sa0
    assert sa.npoint == 512 and tuple(sa.radii) == (0.1, 0.2)
    rng = np.random.default_rng(70)
    xyz = torch.from_numpy(np.stack([cad_cloud(rng, 2048)[:, :3] for _ in range(10)])).to(dev)
    mask = torch.ones(10, 2048, dtype=torch.bool, device=dev)
    idx = fps.furthest_point_sample(xyz, 512, mask)
    assert torch.equal(idx, fps._fps_plain(xyz, 512, mask))
    weights, biases, radius = ops.multi_scale_bundle(
        [[m.dense(i).weight.detach().t() for i in range(m.depth)] for m in sa.mlps],
        [[m.dense(i).bias.detach() for i in range(m.depth)] for m in sa.mlps], sa.radii)
    op = fused_sa.prepare(xyz, ops.gather_points(xyz, idx).contiguous(), weights, biases, radius, None, mask, dtype)
    d2, active = fused_sa.block_min_d2_and_cull(op.pts4, op.centers, op.r2max)
    ref_d2, ref_active = fused_sa.block_min_d2_and_cull(op.pts4.cpu(), op.centers.cpu(), op.r2max)
    assert torch.equal(d2.cpu(), ref_d2) and torch.equal(active.cpu(), ref_active)
    out, ref = fused_sa.fused_sa_core(op, active), fused_sa._fused_sa_plain(op)
    assert (ref != 0).float().mean() > 0.3
    _assert_close_to_scale(out, ref, 1e-5, "out")
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(71)).to(dev)
    got, want = fused_sa.fused_sa_bwd(op, active, out, g), fused_sa._fused_sa_bwd_plain(op, ref, g)
    for what, x, y in zip(["da", "dbc", "dw2", "dw3", "db2", "db3"], [got[0], got[1], *got[2], *got[3]],
                          [want[0], want[1], *want[2], *want[3]]):
        _assert_close_to_scale(x, y, 1e-4, what)


def test_train_from_a_yaml_on_ray_cast_packs(dev, tmp_path, monkeypatch):
    """train(cfg) of the shipped kitti_synth recipe (extended, never
    written) for 2 micro-steps with a validation, on short sequences of
    ray-cast HDL-64 scans (every 2nd point kept, as the KITTI converter
    does); every training kernel launches and the tags are finite."""
    import json
    import os.path as osp

    import yaml

    from deepclr_tpu_torch.config import Mode, load_config
    from deepclr_tpu_torch.data import PackWriter
    from deepclr_tpu_torch.data.synthetic import drive
    from deepclr_tpu_torch.engine import train

    odometry = tmp_path / "kitti" / "odometry"
    odometry.mkdir(parents=True)
    # 00 and 01 give 6 training pairs (one batch of 5), 04 two validation pairs
    for k, (seq, frames) in enumerate((("00", 4), ("01", 4), ("04", 3))):
        with PackWriter(str(odometry / f"{seq}.pack")) as w:
            for i, (pose, scan) in enumerate(drive(np.random.default_rng(k), frames, 120_000)):
                w.put(f"{i:08d}", {"idx": i, "timestamp": i * 1e5, "pose": pose, "cloud": scan[::2]})
    monkeypatch.setenv("KITTI_PATH", str(tmp_path / "kitti"))
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "models"))
    path = tmp_path / "train.yaml"
    shipped = osp.join(osp.dirname(__file__), "..", "configs", "training", "kitti_synth.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"extends": osp.realpath(shipped), "optimizer": {"max_iterations": 2},
                        "logging": {"summary_period": 1, "log_period": 1, "checkpoint_period": 2,
                                    "validation_period": 2}}, f)
    cfg = load_config(str(path), Mode.NEW)
    assert cfg.device == "cuda" and cfg.data_loader.num_points == 16384
    ops.reset_launch_counts()
    state = train(cfg)
    counts = ops.launch_counts()
    assert state.step == 2
    assert all(counts[k] > 0 for k in ("fps", "min_d2", "fused_sa", "fused_sa_bwd")), counts
    tags = {}
    with open(osp.join(cfg.output_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    for tag in ("train/loss", "params/lr", "val/loss_fn", "val/step_t_err"):
        assert tags.get(tag) and np.isfinite(tags[tag]).all(), (tag, tags.get(tag))
    assert osp.islink(osp.join(cfg.output_dir, "weights.pt"))


# --- the ICP baselines (deepclr_tpu_torch.icp): plain torch on the card ---------------------------

def _wave(n, seed):
    """The 'wave' surface cloud of tests/icp/test_gicp_parity.py."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6, 6, size=(n, 2))
    z = 0.4 * np.sin(0.8 * xy[:, 0]) + 0.3 * np.cos(1.1 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 8, 30])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_neighbors_on_card_equal_cpu(dev, k, masked):
    """Grid points (integer distances, ties everywhere), a block of 333 that
    does not divide the 5000 queries: indices and distances equal the CPU's."""
    from deepclr_tpu_torch.icp import nearest_neighbors

    rng = np.random.default_rng(k)
    query = torch.from_numpy(np.round(rng.normal(size=(5000, 3)) * 4).astype(np.float32))
    points = torch.from_numpy(np.round(rng.normal(size=(20000, 3)) * 4).astype(np.float32))
    mask = torch.from_numpy(rng.random(20000) < 0.7) if masked else None
    want = nearest_neighbors(query, points, k, points_mask=mask, block=333)
    got = nearest_neighbors(query.to(dev), points.to(dev), k, points_mask=None if mask is None else mask.to(dev),
                            block=333)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_neighbourhood_statistics_at_scan_size(dev):
    """A 60000-point cloud (a ray-cast scan's size, more matrices than one
    cuSOLVER batched call takes): finite normals of unit length, and
    covariances with the flattened eigenvalues (1e-3, 1, 1)."""
    from deepclr_tpu_torch.icp import estimate_covariances, estimate_normals

    pts = torch.from_numpy(_wave(60000, 11)).to(dev)
    normals = estimate_normals(pts)
    assert normals.shape == (60000, 3) and bool(torch.isfinite(normals).all())
    torch.testing.assert_close(normals.norm(dim=1), torch.ones(60000, device=dev), atol=1e-5, rtol=0)
    lam = torch.linalg.eigvalsh(estimate_covariances(pts)[:4096])
    torch.testing.assert_close(lam, torch.tensor([1e-3, 1.0, 1.0], device=dev).expand(4096, 3), atol=1e-4, rtol=0)


@pytest.mark.parametrize("algorithm", ["icp_po2po", "icp_po2pl", "gicp"])
def test_icp_on_card_matches_cpu(dev, algorithm):
    """4096-point wave surface moved by 2 degrees and 0.17 m: the card's
    transform within 1e-4 of the CPU's (float32 sums in other orders), the
    iterations within one."""
    from deepclr_tpu_torch.icp import ICPRegistration

    cloud = _wave(4096, 10)
    yaw = np.deg2rad(2.0)
    gt = np.eye(4)
    gt[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    gt[:3, 3] = (0.15, -0.05, 0.02)
    source = (cloud @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        reg = ICPRegistration(algorithm, max_distance=2.0, device=device)
        out[device] = reg.register(reg.prepare(cloud), reg.prepare(source), return_info=True)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=0)
    assert abs(out["cuda"][1]["iterations"] - out["cpu"][1]["iterations"]) <= 1
    np.testing.assert_allclose(out["cuda"][0] @ gt, np.eye(4), atol=2e-2)


def _ambiguous_balls(xyz, centres, radius, mask, margin=1e-3):
    """(B, P) bool: balls with a valid point within ``margin`` m² of r², by
    exact float64 distances, where the expanded float32 form may put it on
    either side on another device."""
    d2 = ((centres.double()[:, :, None] - xyz.double()[:, None]) ** 2).sum(-1)
    return ((d2 - radius * radius).abs() < margin) & mask[:, None, :]


@pytest.mark.parametrize("radius, nsample", [(0.5, 512), (1.0, 1024)])
def test_ball_query_on_card_equals_cpu(dev, radius, nsample):
    """KITTI-scale clouds (a masked tail, an all-masked cloud) and FPS
    centres: the card's indices equal the CPU's on every ball without a
    point within 1e-3 m² of the sphere; and on a dense cube (10 x 4096
    points in 4 m, ~190 a 1 m ball) at nsample 64, where truncation bites."""
    xyz, mask = _cloud(4, 16384, seed=60), _mask(4, 16384)
    centres = ops.gather_points(xyz, fps._fps_plain(xyz, 1024, mask))
    dense = torch.from_numpy(np.random.default_rng(61).uniform(0.0, 4.0, size=(10, 4096, 3)).astype(np.float32))
    for pts, m, c, ns in ((xyz, mask, centres, nsample), (dense, torch.ones(10, 4096, dtype=torch.bool),
                                                        dense[:, :256], 64)):
        got = ops.ball_query(pts.to(dev), c.to(dev), radius, ns, m.to(dev)).cpu()
        ref = ops.ball_query(pts, c, radius, ns, m)
        differ = (got != ref).any(-1)
        ambiguous = _ambiguous_balls(pts.to(dev), c.to(dev), radius, m.to(dev)).any(-1).cpu()
        assert not (differ & ~ambiguous).any(), int((differ & ~ambiguous).sum())


def test_exact_model_on_card_matches_cpu(dev):
    """The flagship with fused: False at 2 pairs x 4096 points, bf16: within
    2e-2 of the CPU; FPS launches, the fused kernels do not."""
    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["fused"] = False
    card = build_model(cfg, device="cuda", seed=7)
    cpu = build_model(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(9)
    clouds = [np.concatenate([rng.normal(size=(5000, 3)) * [30, 30, 2], rng.uniform(size=(5000, 1))], 1)
              .astype(np.float32) for _ in range(4)]
    ops.reset_launch_counts()
    y_card = ModelInferenceHelper(card, num_points=4096).predict_batch(clouds[:2], clouds[2:])
    assert ops.launch_counts() == {"fps": 1, "min_d2": 0, "fused_sa": 0, "fused_sa_argmax": 0, "fused_sa_bwd": 0}
    y_cpu = ModelInferenceHelper(cpu, num_points=4096).predict_batch(clouds[:2], clouds[2:])
    np.testing.assert_allclose(y_card, y_cpu, atol=2e-2, rtol=0)


def test_batch_norm_motion_embedding_running_stats_on_card_match_cpu(dev):
    """A training forward of a batch-norm MotionEmbedding (float32): output
    and running statistics on the card within 1e-5 of the CPU's."""
    from deepclr_tpu_torch.models import MotionEmbedding, init_params

    rng = np.random.default_rng(12)
    f0, f1 = (torch.from_numpy(np.concatenate([rng.normal(size=(2, 256, 3)) * 5, rng.normal(size=(2, 256, 64))],
                                              -1).astype(np.float32)) for _ in range(2))
    out, stats = {}, {}
    for device in ("cpu", "cuda"):
        me = init_params(MotionEmbedding(64, [128, 128, 256], k=20, batch_norm=True), 3).to(device).train()
        out[device] = me(f0.to(device), f1.to(device)).detach().cpu()
        stats[device] = {k: v.cpu() for k, v in me.state_dict().items() if "running" in k}
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-5 * max(1.0, out["cpu"].abs().max().item()), rtol=0)
    for k, v in stats["cpu"].items():
        torch.testing.assert_close(stats["cuda"][k], v, atol=1e-5 * max(1.0, v.abs().max().item()), rtol=0)


def test_one_rank_nccl_data_parallel_step_equals_the_plain_step(dev):
    """A one-rank NCCL group: make_train_step on the DistributedDataParallel
    wrapper (one update of the flagship recipe, float32, 2 pairs x 4096)
    launches what the plain step launches and gives its parameters and
    metrics within 1e-6 of their scale (B4 sums with atomics, in a varying
    order, so two runs may differ in the last bits)."""
    import socket

    from deepclr_tpu_torch import parallel, solver
    from deepclr_tpu_torch.configs import KITTI_TRAIN_CFG
    from deepclr_tpu_torch.engine import create_train_state, make_train_step
    from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns
    from deepclr_tpu_torch.synthetic import train_batch

    cfg = copy.deepcopy(KITTI_MODEL_CFG)
    cfg["params"]["compute_dtype"] = "float32"
    batch = train_batch(2, 4096, seed=3)
    metrics = KITTI_TRAIN_CFG["metrics"]

    def one_update(wrap):
        model = build_model(cfg, device=dev, seed=0)
        step = make_train_step(parallel.wrap_data_parallel(model) if wrap else model,
                               solver.make_optimizer(KITTI_TRAIN_CFG, model.parameters()),
                               make_loss_fn(metrics["loss"], cfg["label_type"]),
                               make_metric_fns(metrics["loss"], metrics["other"], cfg["label_type"]))
        ops.reset_launch_counts()
        ema = step(create_train_state(model), batch, 1e-3)
        torch.cuda.synchronize()
        return model, {k: v.item() for k, v in ema.items()}, ops.launch_counts()

    plain, plain_ema, plain_counts = one_update(False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                                         timeout=parallel.distributed.TIMEOUT)
    try:
        dp, dp_ema, dp_counts = one_update(True)
    finally:
        parallel.shutdown()
    assert dp_counts == plain_counts and all(dp_counts[k] >= 1 for k in ("fps", "min_d2", "fused_sa", "fused_sa_bwd"))
    for (name, p), q in zip(plain.named_parameters(), dp.parameters()):
        assert (p - q).abs().max().item() <= 1e-6 * max(1.0, p.abs().max().item()), name
    assert dp_ema.keys() == plain_ema.keys()
    for k, v in plain_ema.items():
        assert abs(dp_ema[k] - v) <= 1e-6 * max(1.0, abs(v)), k


def test_peak_flops_per_chip_names_the_card(dev):
    from deepclr_tpu_torch.utils import flops

    assert flops.peak_flops_per_chip() == flops.peak_flops_per_chip(torch.cuda.get_device_name(0)) > 0
    with pytest.raises(ValueError):
        flops.peak_flops_per_chip("an unknown card")
