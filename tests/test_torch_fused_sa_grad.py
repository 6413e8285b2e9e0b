"""The port's fused set-abstraction backward (deepclr_tpu_torch.ops.fused_sa)
against the JAX package on the CPU: the plain twins of the equality-select
backward kernel and of the argmax forward against the Pallas kernels in
interpret mode, and the autograd Function's gradients against ``jax.grad``
of ``deepclr_tpu.ops.fused_sa.ball_mlp_max``.  The same numpy inputs go
through both."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepclr_tpu.ops.fused_sa import ball_mlp_max as jax_ball_mlp_max  # noqa: E402
from deepclr_tpu.ops.fused_sa import multi_scale_bundle as jax_bundle  # noqa: E402
from deepclr_tpu.ops.pallas.fused_sa_kernel import (  # noqa: E402
    ball_mlp_max_bwd_pallas,
    ball_mlp_max_pallas,
    ball_mlp_max_pallas_argmax,
)
from deepclr_tpu_torch import ops  # noqa: E402
from deepclr_tpu_torch.ops import fused_sa  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(b, n, seed, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * scale).astype(np.float32)


def _mask(b, n, empty_cloud):
    mask = np.ones((b, n), bool)
    mask[0, n * 3 // 4:] = False   # a masked tail
    if empty_cloud:
        mask[-1] = False           # an all-masked cloud
    return mask


def _bundle(seed, in_dim=4, mlp=(16, 16, 32), scales=2, radii=(0.5, 1.0)):
    """Random per-scale MLPs bundled by the JAX package: numpy weights and
    biases (non-zero) and the per-column radii."""
    rng = np.random.default_rng(seed)
    sw, sb = [], []
    for _ in range(scales):
        dims = [in_dim, *mlp]
        sw.append([jnp.asarray(rng.normal(size=(dims[i], dims[i + 1])) * 0.3, jnp.float32)
                   for i in range(len(mlp))])
        sb.append([jnp.asarray(rng.normal(size=(dims[i + 1],)) * 0.1, jnp.float32)
                   for i in range(len(mlp))])
    w, b, radius = jax_bundle(sw, sb, radii[:scales])
    return [np.asarray(x) for x in w], [np.asarray(x) for x in b], radius


def _case(seed, empty_cloud, b=2, n=512, p=64):
    xyz = _cloud(b, n, seed)
    feats = np.random.default_rng(seed + 1).normal(size=(b, n, 1)).astype(np.float32)
    centers = xyz[:, ::n // p][:, :p].copy()
    g = np.random.default_rng(seed + 2).normal(size=(b, p, 64)).astype(np.float32)
    return xyz, feats, centers, _mask(b, n, empty_cloud), g


def _port_operands(xyz, centers, w, bias, radius, feats, mask, dtype):
    return fused_sa.prepare(_t(xyz), _t(centers), [_t(x) for x in w], [_t(x) for x in bias], radius,
                            _t(feats), _t(mask), dtype)


# Both sides round to the compute dtype at the same points and accumulate in
# float32, so they select the same winners and differ only in summation
# order: 1e-5 of each result's scale in float32 and in bfloat16 (measured
# <= 3.2e-7 at these sizes).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("empty_cloud", [False, True])
def test_bwd_plain_matches_pallas_bwd_kernel(dtype, empty_cloud):
    xyz, feats, centers, mask, g = _case(1, empty_cloud)
    w, bias, radius = _bundle(2)
    jdt = getattr(jnp, dtype)
    jw, jb = tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, bias))
    out_j = ball_mlp_max_pallas(xyz, centers, jw, jb, radius, features=feats, mask=mask,
                                compute_dtype=jdt, interpret=True)
    ref = ball_mlp_max_bwd_pallas(xyz, centers, jw, jb, radius, g, out_j, features=feats, mask=mask,
                                  compute_dtype=jdt, interpret=True)
    op = _port_operands(xyz, centers, w, bias, radius, feats, mask, getattr(torch, dtype))
    out = fused_sa.fused_sa_core(op)
    got = fused_sa.fused_sa_bwd(op, None, out, _t(g))
    ref_flat = [ref[0], ref[1], *ref[2], *ref[3]]
    got_flat = [got[0], got[1], *got[2], *got[3]]
    for name, x, y in zip(["da", "dbc", "dw2", "dw3", "db2", "db3"], got_flat, ref_flat):
        y = np.asarray(y)
        assert x.shape == y.shape, name
        scale = max(1e-3, np.abs(y).max())
        np.testing.assert_allclose(x.detach().numpy(), y, atol=1e-5 * scale, rtol=0, err_msg=name)
    assert np.abs(np.asarray(ref[2][1])).max() > 0  # winners were selected
    if empty_cloud:
        assert not got[0][-1].any() and not got[1][-1].any()


def _dense_top2(op):
    """Per (cloud, centre, column): the largest and second-largest value over
    the ball's points, computed densely (small inputs only)."""
    b, n, _ = op.pts4.shape
    p = op.centers.shape[1]
    bi, pi, ji = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(b), torch.arange(p), torch.arange(n), indexing="ij"))
    d2 = ((op.pts4[bi, ji, :3] - op.centers[bi, pi]) ** 2).sum(-1)
    h = fused_sa._pair_mlp(op, fused_sa._rounded_tail(op), bi, pi, ji)[-1]
    inside = (d2[:, None] < op.r2) & (op.pts4[bi, ji, 3:] == 0)
    h = torch.where(inside, h, -1.0).view(b, p, n, -1)
    top = torch.topk(h, 2, dim=2).values
    return top[:, :, 0], top[:, :, 1]


@pytest.mark.parametrize("empty_cloud", [False, True])
def test_argmax_plain_matches_pallas_argmax_kernel(empty_cloud):
    xyz, feats, centers, mask, _ = _case(3, empty_cloud)
    w, bias, radius = _bundle(4)
    out_j, jstar_j = ball_mlp_max_pallas_argmax(
        xyz, centers, tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, bias)), radius,
        features=feats, mask=mask, compute_dtype=jnp.float32, interpret=True)
    op = _port_operands(xyz, centers, w, bias, radius, feats, mask, torch.float32)
    out, jstar = fused_sa.fused_sa_argmax(op)
    assert jstar.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out.numpy(), fused_sa.fused_sa_core(op).numpy())
    # the TPU kernel breaks ties group-major, the port takes the lowest index:
    # compare indices where the winner is unique and positive
    top1, top2 = _dense_top2(op)
    unique = (top1 > 1e-3) & (top1 - top2 > 1e-3)
    assert unique.float().mean() > 0.2
    np.testing.assert_array_equal(jstar.numpy()[unique.numpy()], np.asarray(jstar_j)[unique.numpy()])
    empty = (top1 < 0).numpy()
    assert (jstar.numpy()[empty] == -1).all() and (np.asarray(jstar_j)[empty] == -1).all()
    if empty_cloud:
        assert (jstar[-1] == -1).all()
    # a ball whose maximum is tied at 0 names its lowest in-radius point
    assert ((top1 == 0) & (jstar >= 0)).any() or not (top1 == 0).any()


# The JAX package's own gradient tolerances (tests/ops/test_fused_sa.py:158-160).
ATOL, RTOL = 2e-3, 1e-3
B, N, P = 2, 256, 32


def _grad_data(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, 1)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 200:] = False
    return xyz, feats, mask


@functools.lru_cache(maxsize=None)
def _jax_grads(jax_backward, case):
    """jax.grad of sum(out^2) w.r.t. (weights, biases, features, xyz, centers)."""
    xyz, feats, mask = _grad_data(11)
    centers = xyz[:, :P].copy()
    if case == "features":
        w, bias, radius = _bundle(12, radii=(0.8, 1.5))
    else:
        w, bias, radius = _bundle(22, in_dim=3, scales=1, radii=(1.2,))
        feats = None

    def fn(ws, bs, f, x, c):
        out = jax_ball_mlp_max(x, c, tuple(ws), tuple(bs), radius, features=f, mask=mask,
                               compute_dtype=jnp.float32, backward=jax_backward)
        return jnp.sum(out ** 2)

    args = ([jnp.asarray(x) for x in w], [jnp.asarray(x) for x in bias],
            None if feats is None else jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(centers))
    grads = jax.grad(fn, argnums=(0, 1, 2, 3, 4))(*args)
    return (w, bias, feats, xyz, centers, mask, radius), grads


def _port_grads(inputs, backward):
    w, bias, feats, xyz, centers, mask, radius = inputs
    leaves = ([_t(x).requires_grad_() for x in w], [_t(x).requires_grad_() for x in bias],
              None if feats is None else _t(feats).requires_grad_(), _t(xyz).requires_grad_(),
              _t(centers).requires_grad_())
    out = ops.ball_mlp_max(leaves[3], leaves[4], leaves[0], leaves[1], radius, features=leaves[2],
                           mask=_t(mask), compute_dtype=torch.float32, backward=backward)
    (out ** 2).sum().backward()
    return leaves


@pytest.mark.parametrize("case", ["features", "no_features"])
@pytest.mark.parametrize("port_backward", ["kernel", "argmax"])
@pytest.mark.parametrize("jax_backward", ["kernel", "scan"])
def test_function_gradients_match_jax_grad(jax_backward, port_backward, case):
    inputs, grads = _jax_grads(jax_backward, case)
    leaves = _port_grads(inputs, port_backward)
    pairs = [*zip(leaves[0], grads[0]), *zip(leaves[1], grads[1]), (leaves[3], grads[3]),
             (leaves[4], grads[4])]
    if leaves[2] is not None:
        pairs.append((leaves[2], grads[2]))
    total = 0.0
    for leaf, ref in pairs:
        assert leaf.grad is not None
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        total += float(leaf.grad.abs().sum())
    assert total > 0


def test_two_chained_levels_match_jax_grad():
    """Level 2's input gradients (its features are level 1's output) flow
    back through level 1 to the input features."""
    xyz, feats, mask = _grad_data(41)
    c1, c2 = xyz[:, :P].copy(), xyz[:, :P // 2].copy()
    w1, b1, _ = _bundle(42, scales=1, radii=(1.0,))
    w2, b2, _ = _bundle(43, in_dim=3 + 32, mlp=(16, 16, 16), scales=1, radii=(1.5,))

    def jfn(ws1, bs1, ws2, bs2, f):
        f1 = jax_ball_mlp_max(xyz, c1, tuple(ws1), tuple(bs1), 1.0, features=f, mask=mask,
                              compute_dtype=jnp.float32, backward="scan")
        out = jax_ball_mlp_max(c1, c2, tuple(ws2), tuple(bs2), 1.5, features=f1,
                               compute_dtype=jnp.float32, backward="scan")
        return jnp.sum(out ** 2)

    ref = jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(
        *[[jnp.asarray(x) for x in ws] for ws in (w1, b1, w2, b2)], jnp.asarray(feats))
    leaves = [[_t(x).requires_grad_() for x in ws] for ws in (w1, b1, w2, b2)]
    f = _t(feats).requires_grad_()
    f1 = ops.ball_mlp_max(_t(xyz), _t(c1), leaves[0], leaves[1], 1.0, features=f, mask=_t(mask),
                          compute_dtype=torch.float32)
    out = ops.ball_mlp_max(_t(c1), _t(c2), leaves[2], leaves[3], 1.5, features=f1,
                           compute_dtype=torch.float32)
    (out ** 2).sum().backward()
    for got, want in zip([*leaves[0], *leaves[1], *leaves[2], *leaves[3], f],
                         [*ref[0], *ref[1], *ref[2], *ref[3], ref[4]]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert float(f.grad.abs().sum()) > 0  # dfeatures flowed back through both levels


def test_tail_weight_gradient_is_not_rounded():
    """Under bfloat16 compute the tail weights are rounded inside the op, so
    their gradient comes back in float32: not a bf16 value."""
    xyz, feats, mask = _grad_data(51)
    w, bias, radius = _bundle(52)
    ws = [_t(x).requires_grad_() for x in w]
    out = ops.ball_mlp_max(_t(xyz), _t(xyz[:, :P].copy()), ws, [_t(x) for x in bias], radius,
                           features=_t(feats), mask=_t(mask), compute_dtype=torch.bfloat16)
    (out ** 2).sum().backward()
    for x in ws[1:]:
        assert not torch.equal(x.grad, x.grad.to(torch.bfloat16).float())


def test_backward_mode_is_checked():
    xyz = torch.zeros(1, 8, 3)
    w, bias, radius = _bundle(0)
    with pytest.raises(ValueError, match="backward"):
        ops.ball_mlp_max(xyz, xyz, [_t(x) for x in w], [_t(x) for x in bias], radius, backward="scan")
