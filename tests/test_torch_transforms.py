"""The port's host transforms and batching (deepclr_tpu_torch.data.transforms
and .batching) against the JAX package's on the CPU.  Both are numpy drawing
from one seeded ``np.random.Generator`` in the same order, so every result is
held bit for bit: the same arrays, dtypes and draws."""
import copy

import numpy as np
import pytest

pytest.importorskip("torch")

from deepclr_tpu.config import Mode as JaxMode  # noqa: E402
from deepclr_tpu.config import create_default_config as jax_default_config  # noqa: E402
from deepclr_tpu.config import finish_config as jax_finish_config  # noqa: E402
from deepclr_tpu.data import batching as jb  # noqa: E402
from deepclr_tpu.data import transforms as jt  # noqa: E402
from deepclr_tpu.geometry import LabelType as JaxLabelType  # noqa: E402
from deepclr_tpu_torch.config import Mode, create_default_config, finish_config  # noqa: E402
from deepclr_tpu_torch.data import batching as pb  # noqa: E402
from deepclr_tpu_torch.data import transforms as pt  # noqa: E402
from deepclr_tpu_torch.geometry import LabelType  # noqa: E402
from deepclr_tpu_torch.geometry.hostmath import _euler_to_matrix_np  # noqa: E402


def _assert_same(got, ref, where="sample"):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for k in ref:
            _assert_same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


def _motion(rng):
    m = np.eye(4)
    m[:3, :3] = _euler_to_matrix_np(*rng.normal(size=3) * 0.05)
    m[:3, 3] = rng.normal(size=3)
    return m.astype(np.float32)


def _sample(seed, n0=200, n1=170, d=4):
    rng = np.random.default_rng(seed)
    return {"dataset": "seq", "idx": [3, 4], "timestamps": [3e5, 4e5],
            "clouds": [(rng.normal(size=(n0, d)) * [20.0, 20.0, 2.0, 1.0][:d]).astype(np.float32),
                       (rng.normal(size=(n1, d)) * [20.0, 20.0, 2.0, 1.0][:d]).astype(np.float32)],
            "transform": _motion(rng), "augmentations": [None, None]}


def _model_record(seed, n=300):
    rng = np.random.default_rng(seed)
    return {"idx": 7, "cloud": rng.normal(size=(n, 6)).astype(np.float32)}


def test_euler_matrix_is_the_jax_transforms_copy_bit_for_bit():
    rng = np.random.default_rng(0)
    for roll, pitch, yaw in rng.normal(size=(50, 3)) * 2.0:
        np.testing.assert_array_equal(_euler_to_matrix_np(roll, pitch, yaw), jt._euler_to_matrix_np(roll, pitch, yaw))


@pytest.mark.parametrize("kind,scale", [("normal", 0.3), ("uniform", [0.1, 0.2, 0.3]),
                                        ("uniform_minmax", [-0.2, 0.5])])
def test_noise_types_draw_as_jax(kind, scale):
    got = pt.NoiseType(kind).get(scale, (40, 3), rng=np.random.default_rng(1))
    ref = jt.NoiseType(kind).get(scale, (40, 3), rng=np.random.default_rng(1))
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(TypeError):
        pt.NoiseType.UNIFORM_MINMAX.get(0.1)


def _aug_sample(seed):
    s = _sample(seed)
    s["augmentations"] = [_motion(np.random.default_rng(seed + 1)), None]
    return s


# (name, port transform, JAX transform, sample maker); stochastic transforms
# are built with one Generator seeded 5 in each package
TRANSFORMS = {
    "apply_augmentations": (lambda m, g: m.ApplyAugmentations(), _aug_sample),
    "fps": (lambda m, g: m.FarthestPointSampling(50), _sample),
    "fps_model_record": (lambda m, g: m.FarthestPointSampling(64), _model_record),
    "fps_inf": (lambda m, g: m.FarthestPointSampling(np.inf), _sample),
    "point_noise": (lambda m, g: m.PointNoise(0.05, rng=g), _sample),
    "point_noise_target_only_uniform": (
        lambda m, g: m.PointNoise(0.1, noise_type=m.NoiseType.UNIFORM, target_only=True, rng=g), _sample),
    "point_noise_off": (lambda m, g: m.PointNoise(0.0, rng=g), _sample),
    "range_selection": (lambda m, g: m.RangeSelection(5.0, 25.0), _sample),
    "range_selection_all": (lambda m, g: m.RangeSelection(0.0, np.inf), _sample),
    "random_erasing": (lambda m, g: m.RandomErasing(0.7, 100, rng=g), _sample),
    "random_erasing_cap_only": (lambda m, g: m.RandomErasing(1.0, 150, rng=g), _sample),
    "random_transform_normal": (lambda m, g: m.RandomTransform([0.2, 0.02, 0.02], [0.1, 0.1, 1.0], rng=g),
                                _sample),
    "random_transform_uniform_on_aug": (
        lambda m, g: m.RandomTransform(0.1, 5.0, translation_noise_type="uniform",
                                       rotation_noise_deg_type=["uniform", "normal", "uniform"], rng=g),
        lambda seed: _aug_sample(seed) | {"augmentations": [None, _motion(np.random.default_rng(9))]}),
    "random_transform_inactive": (lambda m, g: m.RandomTransform(0.0, 0.0, rng=g), _sample),
    "remove_transform": (lambda m, g: m.RemoveTransform(), _sample),
    "remove_transform_off": (lambda m, g: m.RemoveTransform(False), _sample),
    "systematic_erasing_random_start": (lambda m, g: m.SystematicErasing(3, start=-1, rng=g), _sample),
    "systematic_erasing_fixed": (lambda m, g: m.SystematicErasing(2, start=1), _sample),
    "systematic_erasing_model_record": (lambda m, g: m.SystematicErasing(4, start=-1, rng=g), _model_record),
    "truncate": (lambda m, g: m.TruncateDimension(3), _sample),
    "truncate_model_record": (lambda m, g: m.TruncateDimension(3), _model_record),
    "compose": (lambda m, g: m.Compose([m.TruncateDimension(3), m.RandomErasing(0.8, 120, rng=g),
                                        m.RemoveTransform(), m.RandomTransform(0.3, 2.0, rng=g),
                                        m.PointNoise(0.01, rng=g)]), _sample),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_equals_jax(name):
    make, sample = TRANSFORMS[name]
    port, jax_t = make(pt, np.random.default_rng(5)), make(jt, np.random.default_rng(5))
    for seed in (11, 12):  # two samples: the Generator's state carries over
        got, ref = port(copy.deepcopy(sample(seed))), jax_t(copy.deepcopy(sample(seed)))
        _assert_same(got, ref)


def test_remove_transform_after_an_augmentation_raises():
    s = _sample(3)
    s["augmentations"][-1] = np.eye(4)
    with pytest.raises(RuntimeError, match="RemoveTransform"):
        pt.RemoveTransform()(s)


def test_transform_point_cloud_equals_jax():
    s = _sample(4)
    np.testing.assert_array_equal(pt.transform_point_cloud(s["clouds"][0][:, :3], s["transform"]),
                                  jt.transform_point_cloud(s["clouds"][0][:, :3], s["transform"]))


TRANSFORM_CFGS = {
    "published_kitti_synth": {"point_noise": {"scale": 0.01},
                              "translation_noise": {"scale": [0.2, 0.02, 0.02]},
                              "rotation_noise_deg": {"scale": [0.1, 0.1, 1.0]}},
    "modelnet40_on_validation": {"on_validation": True, "point_noise": {"type": "normal", "scale": 0.02},
                                 "translation_noise": {"type": "uniform", "scale": 0.1},
                                 "rotation_noise_deg": {"type": "uniform", "scale": 5.0}},
    "every_member": {"nth_point": 2, "nth_point_random": True, "min_range": 2.0, "max_range": 30.0,
                     "keep_probability": 0.9, "max_points": 60, "fps": 40, "remove_transform": True,
                     "point_noise": {"scale": 0.02, "target_only": True},
                     "translation_noise": {"type": "uniform", "scale": [0.3, 0.1, 0.05]},
                     "rotation_noise_deg": {"type": ["normal", "uniform", "normal"], "scale": 2.0}},
}


def _cfgs(transforms, base_dir):
    d = {"base_dir": str(base_dir), "transforms": transforms,
         "model": {"input_dim": 3, "point_dim": 3, "label_type": "pose3d_dual_quat", "model_type": "deepclr"}}
    port, ref = create_default_config(Mode.TEST), jax_default_config(JaxMode.TEST)
    for cfg, finish in ((port, finish_config), (ref, jax_finish_config)):
        cfg.read_dict(copy.deepcopy(d))
        finish(cfg)
    return port, ref


@pytest.mark.parametrize("name", list(TRANSFORM_CFGS))
@pytest.mark.parametrize("is_training", [True, False])
def test_build_transform_equals_jax(name, is_training, tmp_path):
    port_cfg, jax_cfg = _cfgs(TRANSFORM_CFGS[name], tmp_path)
    port = pt.build_transform(port_cfg, is_training, rng=np.random.default_rng(8))
    ref = jt.build_transform(jax_cfg, is_training, rng=np.random.default_rng(8))
    assert [type(t).__name__ for t in port.transforms] == [type(t).__name__ for t in ref.transforms]
    for seed in (20, 21, 22):
        _assert_same(port(_sample(seed)), ref(_sample(seed)))


@pytest.mark.parametrize("n", [50, 64, 90])
@pytest.mark.parametrize("morton", [False, True])
def test_pad_points_equals_jax(n, morton):
    cloud = _sample(n, n0=n)["clouds"][0]
    got = pb.pad_points(cloud, 64, np.random.default_rng(2), morton=morton)
    ref = jb.pad_points(cloud, 64, np.random.default_rng(2), morton=morton)
    _assert_same(list(got), list(ref))


@pytest.mark.parametrize("morton", [False, True])
def test_batch_samples_equals_jax(morton):
    samples = [_sample(30 + i, n0=50 + 10 * i, n1=70) for i in range(3)]
    samples[1]["augmentations"] = [_motion(np.random.default_rng(1)), _motion(np.random.default_rng(2))]
    got = pb.batch_samples(copy.deepcopy(samples), LabelType.POSE3D_DUAL_QUAT, 64, np.random.default_rng(4),
                           morton=morton)
    ref = jb.batch_samples(copy.deepcopy(samples), JaxLabelType.POSE3D_DUAL_QUAT, 64, np.random.default_rng(4),
                           morton=morton)
    _assert_same(got, ref)
    assert got["template"].shape == (3, 64, 4) and got["y"].shape == (3, 8)


@pytest.mark.parametrize("remainder", [True, False])
def test_batch_builder_equals_jax(remainder):
    samples = [_sample(40 + i, n0=60 + i, n1=80 - i) for i in range(7)]
    got = list(pb.BatchBuilder(3, LabelType.POSE3D_QUAT, 64, remainder=remainder, seed=6)(iter(samples)))
    ref = list(jb.BatchBuilder(3, JaxLabelType.POSE3D_QUAT, 64, remainder=remainder, seed=6)(iter(samples)))
    assert len(got) == len(ref) == (3 if remainder else 2)
    _assert_same(got, ref)
