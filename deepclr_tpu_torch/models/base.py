"""Inference helper: sequential and pairwise prediction with fixed shapes.

In sequential mode every LiDAR frame is encoded exactly once; the previous
frame's features are cached so each step runs one fused encode+register.
Clouds are padded or randomly subsampled to a fixed ``num_points`` buffer
with a validity mask, using the same numpy RNG stream as the JAX helper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .deepclr import DeepCLR

__all__ = ["ModelInferenceHelper", "pad_cloud"]


def pad_cloud(points: np.ndarray, num_points: int,
              rng: Optional[np.random.Generator] = None):
    """Pad (with zeros + mask) or uniformly subsample a cloud to exactly
    num_points.  Returns (points (num_points, D) float32, mask (num_points,)
    bool)."""
    n, d = points.shape
    if n > num_points:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, size=num_points, replace=False)
        points, n = points[sel], num_points
    if n == num_points:
        return points.astype(np.float32), np.ones(num_points, bool)
    out = np.zeros((num_points, d), np.float32)
    out[:n] = points
    mask = np.zeros(num_points, bool)
    mask[:n] = True
    return out, mask


class ModelInferenceHelper:
    """Stateful wrapper over ``DeepCLR.encode`` / ``register`` /
    ``encode_register``; runs on the device of the model's parameters."""

    def __init__(self, model: DeepCLR, is_sequential: bool = False, num_points: int = 16384,
                 seed: int = 0):
        self._model = model.eval()
        self._device = next(model.parameters()).device
        self._input_dim = model.input_dim
        self._is_sequential = is_sequential
        self._num_points = num_points
        self._state: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(seed)

    def has_state(self) -> bool:
        return self._state is not None

    def reset_state(self) -> None:
        """Drop cached features, e.g. when a new sequence starts."""
        self._state = None

    def _pad(self, cloud, name: str):
        cloud = np.asarray(cloud)
        if cloud.shape[1] > self._input_dim:
            cloud = cloud[:, : self._input_dim]
        elif cloud.shape[1] < self._input_dim:
            raise RuntimeError(f"Wrong point dimension in {name}.")
        return pad_cloud(cloud, self._num_points, self._rng)

    def _stack(self, clouds, name: str):
        padded = [self._pad(c, name) for c in clouds]
        pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(self._device)
        mask = torch.from_numpy(np.stack([m for _, m in padded])).to(self._device)
        return pts, mask

    @torch.inference_mode()
    def encode_cloud(self, cloud: np.ndarray) -> torch.Tensor:
        """Encode one raw cloud (N, D) -> (1, P, 3+C) features on the device."""
        pts, mask = self._stack([cloud], "cloud")
        return self._model.encode(pts, mask)

    @torch.inference_mode()
    def predict_batch(self, sources, templates) -> np.ndarray:
        """Pairwise prediction for B independent pairs: sequences of B raw
        (N_i, D) clouds -> (B, label_dim).  The 2B clouds go through one
        stacked encode."""
        if self._is_sequential:
            raise RuntimeError("predict_batch is pairwise-only.")
        if len(sources) != len(templates):
            raise RuntimeError("sources and templates must have equal length.")
        t_pts, t_mask = self._stack(templates, "template")
        s_pts, s_mask = self._stack(sources, "source")
        return self._model(t_pts, s_pts, t_mask, s_mask).cpu().numpy()

    @torch.inference_mode()
    def predict(self, source: np.ndarray,
                template: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Transform aligning source to template.

        Sequential mode: pass only ``source`` per frame; returns None on the
        first frame.  Pairwise mode: pass both clouds.
        """
        if self._is_sequential:
            if template is not None:
                raise RuntimeError("Only the source cloud is required for sequential prediction.")
            if self._state is None:
                self._state = self.encode_cloud(source)
                return None
            pts, mask = self._stack([source], "source")
            y, self._state = self._model.encode_register(self._state, pts, mask)
            return y[0].cpu().numpy()
        if template is None:
            raise RuntimeError("Source and template clouds are required for non-sequential prediction.")
        f0 = self.encode_cloud(template)
        f1 = self.encode_cloud(source)
        return self._model.register(f0, f1)[0].cpu().numpy()
