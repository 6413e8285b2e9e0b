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
    assert min(ops.launch_counts().values()) == 1
    y_cpu = ModelInferenceHelper(cpu, num_points=4096).predict_batch(clouds[:2], clouds[2:])
    np.testing.assert_allclose(y_card, y_cpu, atol=2e-2, rtol=0)
