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
