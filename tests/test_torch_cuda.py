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


# n covers every per-thread template of csrc/fps.cu: 1, 2, 4, 8 and 16 points
@pytest.mark.parametrize("n", [100, 1000, 2000, 3000, 6000, 16384])
@pytest.mark.parametrize("grid", [False, True])
def test_fps_kernel_bit_exact(dev, n, grid):
    xyz, mask = _cloud(3, n, seed=n, grid=grid), _mask(3, n)
    npoint = min(n, 256)
    got = ops.furthest_point_sample(xyz.to(dev), npoint, mask.to(dev))
    ref = fps._fps_plain(xyz, npoint, mask)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


def test_fps_kernel_rejects_oversized_clouds(dev):
    with pytest.raises(ValueError, match="exceeds"):
        ops.furthest_point_sample(torch.zeros(1, fps.FPS_MAX_POINTS + 1, 3, device=dev), 8)


@pytest.mark.parametrize("n,p", [(16384, 1024), (1000, 300)])
def test_min_d2_kernel_exact(dev, n, p):
    xyz, mask = _cloud(2, n, seed=1), _mask(2, n)
    centers = _cloud(2, p, seed=2)
    pts4 = fused_sa._pack_points(xyz, mask)
    got = fused_sa.block_min_d2(pts4.to(dev), centers.to(dev))
    ref = fused_sa.block_min_d2(pts4, centers)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


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


def _sa_operands(n, p, dtype, seed, dev, tie_at_zero=False):
    """Prepared fused-SA operands of 3 sorted clouds (one with a masked
    tail, one all masked) on ``dev``; with ``tie_at_zero`` the first 8
    output columns have a bias so negative that every value is 0."""
    pts = _cloud(3, n, seed=seed) / 10
    xyz = ops.spatial_sort(pts)[0]
    centers = xyz[:, :: n // p][:, :p].contiguous()
    feats = torch.rand(3, n, 1, generator=torch.Generator().manual_seed(seed + 1))
    w, b, radius = _bundle((16, 16, 32), seed=seed + 2)
    if tie_at_zero:
        b[-1] = b[-1].clone()
        b[-1][:8] = -100.0
    op = fused_sa.prepare(xyz.to(dev), centers.to(dev), [x.to(dev) for x in w], [x.to(dev) for x in b],
                          radius, feats.to(dev), _mask(3, n).to(dev), dtype)
    active = fused_sa.cull_bitmap(fused_sa.block_min_d2(op.pts4, op.centers), op.r2max) if op.pts4.is_cuda \
        else None
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
@pytest.mark.parametrize("n,p", [(4096, 512), (1000, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie_at_zero", [False, True])
def test_fused_sa_bwd_kernel_matches_plain(dev, n, p, dtype, tie_at_zero):
    op, active = _sa_operands(n, p, dtype, 9, dev, tie_at_zero)
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
    active = fused_sa.cull_bitmap(fused_sa.block_min_d2(op.pts4, op.centers), op.r2max)
    with pytest.raises(ValueError, match="not compiled"):
        fused_sa.fused_sa_argmax(op, active)
    with pytest.raises(ValueError, match="not compiled"):
        fused_sa.fused_sa_bwd(op, active, torch.zeros(1, 16, 16, device=dev), torch.zeros(1, 16, 16, device=dev))


@pytest.mark.parametrize("backward", ["kernel", "argmax"])
def test_function_gradients_on_card_match_cpu(dev, backward):
    """ball_mlp_max's autograd Function: every input's gradient on the card
    (B5 / B2 + B4 kernels) against the CPU (plain twins)."""
    xyz = ops.spatial_sort(_cloud(2, 2048, seed=11) / 10)[0]
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
