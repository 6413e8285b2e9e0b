"""Host-side augmentation and preprocessing transforms (numpy).

Each transform takes and returns the unified sample dict
{dataset, idx[2], timestamps[2], clouds[2], transform (4, 4),
augmentations[2]} (model records carry one ``cloud`` instead).  Geometric
augmentations are *deferred*: ``RandomTransform`` and ``RemoveTransform``
store 4x4 matrices in ``sample["augmentations"]`` and fold them into the
label; the model applies them to the points on the device
(``DeepCLR.forward``'s ``aug_template`` / ``aug_source``), never on the host.

Every random draw comes from the ``np.random.Generator`` a transform is
given, in the JAX package's order, so a seed gives the same samples in both
packages.
"""
from __future__ import annotations

import copy
import enum
from typing import Dict, List, Optional, Union

import numpy as np

from ..geometry.hostmath import _euler_to_matrix_np

__all__ = [
    "NoiseType",
    "transform_point_cloud",
    "ApplyAugmentations",
    "FarthestPointSampling",
    "PointNoise",
    "RangeSelection",
    "RandomErasing",
    "RandomTransform",
    "RemoveTransform",
    "SystematicErasing",
    "TruncateDimension",
    "Compose",
    "build_transform",
]

_Sample = Dict


class NoiseType(enum.Enum):
    """Random distributions for noise."""

    NORMAL = "normal"
    UNIFORM = "uniform"
    UNIFORM_MINMAX = "uniform_minmax"

    def get(self, scale, size=None, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        if self == NoiseType.NORMAL:
            return rng.normal(scale=scale, size=size)
        if self == NoiseType.UNIFORM:
            scale = np.asarray(scale)
            return rng.uniform(low=-scale, high=scale, size=size)
        if self == NoiseType.UNIFORM_MINMAX:
            if isinstance(scale, (list, np.ndarray)):
                return rng.uniform(low=scale[0], high=scale[1], size=size)
            raise TypeError("Invalid scale type for minmax noise.")
        raise NotImplementedError(self)  # pragma: no cover


def transform_point_cloud(cloud: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a (4, 4) transform to an (n, 3) cloud (host-side)."""
    return cloud @ transform[:3, :3].T + transform[:3, 3]


class Compose:
    """Sequential transform composition."""

    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, sample: _Sample) -> _Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


class ApplyAugmentations:
    """Bake the deferred 4x4 augmentations into the points (a host fallback:
    the model normally applies them on the device)."""

    def __init__(self, dim: int = 3):
        assert dim == 3, "Only three-dimensional transforms supported"
        self.dim = dim

    def __call__(self, sample: _Sample) -> _Sample:
        for i, (cloud, aug) in enumerate(zip(sample["clouds"], sample["augmentations"])):
            if aug is not None:
                cloud = copy.copy(cloud)
                cloud[:, : self.dim] = transform_point_cloud(cloud[:, : self.dim], aug)
                sample["clouds"][i] = cloud
                sample["augmentations"][i] = None
        return sample


class FarthestPointSampling:
    """Host-side FPS decimation (vectorised numpy; O(n * k)), starting at
    point 0."""

    def __init__(self, n: Union[int, float], dim: int = 3):
        self.n = n
        assert dim == 3, "Only three-dimensional transforms supported"
        self.dim = dim

    def __call__(self, sample: _Sample) -> _Sample:
        if "cloud" in sample:
            sample["cloud"] = self._fps(sample["cloud"])
        else:
            sample["clouds"] = [self._fps(c) for c in sample["clouds"]]
        return sample

    def _fps(self, cloud: np.ndarray) -> np.ndarray:
        if np.isinf(self.n) or cloud.shape[0] <= self.n:
            return cloud
        n = int(self.n)
        xyz = cloud[:, : self.dim]
        perm = np.zeros(n, dtype=int)
        dist = np.linalg.norm(xyz - xyz[0], axis=1)
        for i in range(1, n):
            idx = int(np.argmax(dist))
            perm[i] = idx
            dist = np.minimum(dist, np.linalg.norm(xyz - xyz[idx], axis=1))
        return cloud[perm, :]


class PointNoise:
    """Additive coordinate noise on the clouds (optionally the source only)."""

    def __init__(self, scale: float, noise_type: Optional[NoiseType] = None,
                 target_only: bool = False, dim: int = 3,
                 rng: Optional[np.random.Generator] = None):
        self.scale = scale
        self.noise_type = noise_type or NoiseType.NORMAL
        self.target_only = target_only
        self.dim = dim
        self.rng = rng or np.random.default_rng()

    def _noisy(self, cloud: np.ndarray) -> np.ndarray:
        cloud = copy.copy(cloud)
        cloud[:, : self.dim] = cloud[:, : self.dim] + self.noise_type.get(
            self.scale, (cloud.shape[0], self.dim), rng=self.rng)
        return cloud

    def __call__(self, sample: _Sample) -> _Sample:
        if self.scale <= 0.0:
            return sample
        if self.target_only:
            sample["clouds"][-1] = self._noisy(sample["clouds"][-1])
        else:
            sample["clouds"] = [self._noisy(c) for c in sample["clouds"]]
        return sample


class RangeSelection:
    """Keep the points whose max(|x|, |y|) lies in [min_range, max_range]."""

    def __init__(self, min_range: float, max_range: float, dim: int = 3):
        self.min_range = min_range
        self.max_range = max_range
        assert dim == 3, "Only three-dimensional transforms supported"
        self.dim = dim

    def __call__(self, sample: _Sample) -> _Sample:
        sample["clouds"] = [self._select(c) for c in sample["clouds"]]
        return sample

    def _select(self, cloud: np.ndarray) -> np.ndarray:
        if self.min_range == 0.0 and np.isinf(self.max_range):
            return cloud
        cloud_max = np.max(np.abs(cloud[:, : self.dim - 1]), axis=1)
        inliers = (cloud_max >= self.min_range) & (cloud_max <= self.max_range)
        return cloud[inliers, :]


class RandomErasing:
    """Random point dropout, then a hard cap on the point count."""

    def __init__(self, keep_probability: float, max_points: Union[int, float],
                 rng: Optional[np.random.Generator] = None):
        self.keep_probability = keep_probability
        self.max_points = max_points
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: _Sample) -> _Sample:
        sample["clouds"] = [self._erase(c) for c in sample["clouds"]]
        return sample

    def _erase(self, cloud: np.ndarray) -> np.ndarray:
        if self.keep_probability < 1.0:
            keep = self.rng.random(cloud.shape[0]) < self.keep_probability
            cloud = cloud[keep, :]
        if cloud.shape[0] > self.max_points:
            keep_idx = self.rng.choice(cloud.shape[0], size=int(self.max_points), replace=False)
            cloud = cloud[keep_idx, :]
        return cloud


def _noise_type(x) -> NoiseType:
    if isinstance(x, NoiseType):
        return x
    return NoiseType(str(x).lower())


def _per_dim(value, dim: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * dim


class RandomTransform:
    """Random SE(3) perturbation of the source cloud, stored as a deferred
    augmentation matrix and folded into the ground-truth label."""

    def __init__(self, translation_noise_scale, rotation_noise_deg_scale,
                 translation_noise_type=None, rotation_noise_deg_type=None,
                 dim: int = 3, rng: Optional[np.random.Generator] = None):
        assert dim == 3, "Only three-dimensional transforms supported"
        self.dim = dim
        self.rng = rng or np.random.default_rng()
        self.translation_noise_scale = _per_dim(translation_noise_scale, dim)
        self.rotation_noise_deg_scale = _per_dim(rotation_noise_deg_scale, dim)
        tnt = translation_noise_type or NoiseType.NORMAL
        rnt = rotation_noise_deg_type or NoiseType.NORMAL
        self.translation_noise_type = [_noise_type(x) for x in _per_dim(tnt, dim)]
        self.rotation_noise_deg_type = [_noise_type(x) for x in _per_dim(rnt, dim)]
        self.active = (
            np.sum([np.sum(np.abs(x)) for x in self.translation_noise_scale]) > 0.0
            or np.sum([np.sum(np.abs(x)) for x in self.rotation_noise_deg_scale]) > 0.0
        )

    def __call__(self, sample: _Sample) -> _Sample:
        if not self.active:
            return sample
        random_transform = self._random_transform()
        random_transform_cloud = np.linalg.inv(random_transform)
        if sample["augmentations"][-1] is None:
            sample["augmentations"][-1] = random_transform_cloud
        else:
            sample["augmentations"][-1] = random_transform_cloud @ sample["augmentations"][-1]
        sample["transform"] = sample["transform"] @ random_transform
        return sample

    def _random_transform(self) -> np.ndarray:
        t = np.array([nt.get(ns, rng=self.rng)
                      for nt, ns in zip(self.translation_noise_type, self.translation_noise_scale)])
        rot_deg = np.array([nt.get(ns, rng=self.rng)
                            for nt, ns in zip(self.rotation_noise_deg_type, self.rotation_noise_deg_scale)])
        rot = np.deg2rad(rot_deg)
        m = np.eye(4)
        m[:3, :3] = _euler_to_matrix_np(rot[0], rot[1], rot[2])
        m[:3, 3] = t
        return m


class RemoveTransform:
    """Move the ground-truth motion into the source's augmentation matrix,
    so the label becomes the identity."""

    def __init__(self, active: bool = True, dim: int = 3):
        assert dim == 3, "Only three-dimensional transforms supported"
        self.active = active

    def __call__(self, sample: _Sample) -> _Sample:
        if not self.active:
            return sample
        if sample["augmentations"][-1] is not None:
            raise RuntimeError("RemoveTransform must be called before any other transform augmentation")
        sample["augmentations"][-1] = sample["transform"]
        sample["transform"] = np.eye(4)
        return sample


class SystematicErasing:
    """Keep every nth point, from a fixed start or (start = -1) a random one."""

    def __init__(self, nth: int, start: int = 0,
                 rng: Optional[np.random.Generator] = None):
        self.nth = int(nth)
        self.start = int(start)
        assert self.nth >= 1
        assert -1 <= self.start < self.nth
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: _Sample) -> _Sample:
        if "cloud" in sample:
            sample["cloud"] = self._erase(sample["cloud"])
        else:
            sample["clouds"] = [self._erase(c) for c in sample["clouds"]]
        return sample

    def _erase(self, cloud: np.ndarray) -> np.ndarray:
        if self.nth == 1:
            return cloud
        start = int(self.rng.uniform(0, self.nth)) if self.start == -1 else self.start
        return cloud[start:: self.nth, :]


class TruncateDimension:
    """Truncate the point feature dimension to the model's input_dim."""

    def __init__(self, input_dim: int):
        self.input_dim = input_dim

    def __call__(self, sample: _Sample) -> _Sample:
        if "cloud" in sample:
            sample["cloud"] = sample["cloud"][:, : self.input_dim]
        else:
            sample["clouds"] = [c[:, : self.input_dim] for c in sample["clouds"]]
        return sample


def build_transform(cfg, is_training: bool = True,
                    rng: Optional[np.random.Generator] = None) -> Compose:
    """The training composition (also for validation with
    ``transforms.on_validation``) or the evaluation one, from a ``Config``
    (``model`` and ``transforms`` sections); every random member draws from
    ``rng``."""
    input_dim = cfg.model.input_dim
    point_dim = cfg.model.point_dim
    t = cfg.transforms
    rng = rng or np.random.default_rng()

    if is_training or t.on_validation:
        nth_start = -1 if t.nth_point_random else 0
        return Compose([
            TruncateDimension(input_dim),
            SystematicErasing(t.nth_point, start=nth_start, rng=rng),
            RangeSelection(t.min_range, t.max_range, dim=point_dim),
            RandomErasing(t.keep_probability, t.max_points, rng=rng),
            FarthestPointSampling(t.fps, dim=point_dim),
            RemoveTransform(t.remove_transform, dim=point_dim),
            RandomTransform(
                t.translation_noise.scale, t.rotation_noise_deg.scale,
                translation_noise_type=t.translation_noise.type,
                rotation_noise_deg_type=t.rotation_noise_deg.type,
                dim=point_dim, rng=rng,
            ),
            PointNoise(
                t.point_noise.scale, noise_type=_noise_type(t.point_noise.type),
                target_only=t.point_noise.target_only, dim=point_dim, rng=rng,
            ),
        ])
    return Compose([
        TruncateDimension(input_dim),
        SystematicErasing(t.nth_point, start=0),
        RangeSelection(t.min_range, t.max_range, dim=point_dim),
        RandomErasing(t.keep_probability, t.max_points, rng=rng),
        FarthestPointSampling(t.fps, dim=point_dim),
    ])
