"""Inference helpers: sequential and pairwise prediction with fixed shapes.

In sequential mode every LiDAR frame is encoded exactly once; the previous
frame's features are cached so each step runs one fused encode+register.
Clouds are padded or randomly subsampled to a fixed ``num_points`` buffer
with a validity mask, using the same numpy RNG streams as the JAX helpers,
and Morton-sorted on the host when the model is built ``presorted``.

Each call is a ``helper.predict`` span (``utils.profiling.span``; its id
the helper's call count) with the children ``helper.pad`` (fit and pad or
subsample the clouds), ``helper.upload`` (stack and copy to the device),
``helper.model`` (dispatch of the model's call) and ``helper.fetch`` (the
pose back on the host: the wait for the device).

``upload_dtype="uint16"`` quantises each padded cloud per axis on the host
(``_quantize_u16``) and uploads the 16-bit codes, half the float32 bytes;
the card dequantises (``q * scale + offset``).  The codes travel as int16
bits (the same 16 bits; torch's uint16 has few CUDA ops) and are widened
with ``& 0xFFFF`` on the device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.morton import morton_argsort_np
from ..utils.profiling import span
from .deepclr import DeepCLR

__all__ = ["BatchedSequentialHelper", "ModelInferenceHelper", "UPLOAD_DTYPES", "pad_cloud"]

UPLOAD_DTYPES = ("float32", "uint16")


def pad_cloud(points: np.ndarray, num_points: int,
              rng: Optional[np.random.Generator] = None,
              morton: bool = False):
    """Pad (with zeros + mask) or uniformly subsample a cloud to exactly
    num_points; ``morton=True`` Morton-sorts the valid points.  Returns
    (points (num_points, D) float32, mask (num_points,) bool)."""
    n, d = points.shape
    if n > num_points:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, size=num_points, replace=False)
        points, n = points[sel], num_points
    if morton and n > 1:
        points = points[morton_argsort_np(points)]
    if n == num_points:
        return points.astype(np.float32), np.ones(num_points, bool)
    out = np.zeros((num_points, d), np.float32)
    out[:n] = points
    mask = np.zeros(num_points, bool)
    mask[:n] = True
    return out, mask


def _quantize_u16(pts: np.ndarray):
    """Per-cloud uint16 fixed-point quantization of a padded (P, D) cloud:
    (codes (P, D) uint16, offset (D,) float32, scale (D,) float32).  16 bits
    a coordinate give ~3 mm resolution over a +/-100 m LiDAR range."""
    lo = pts.min(axis=0)
    scale = np.maximum(
        (pts.max(axis=0) - lo) / 65535.0, 1e-12
    ).astype(np.float32)
    q = np.round((pts - lo) / scale).astype(np.uint16)
    return q, lo.astype(np.float32), scale


def _check_upload_dtype(upload_dtype: str) -> str:
    if upload_dtype not in UPLOAD_DTYPES:
        raise ValueError(f"unsupported upload_dtype: {upload_dtype} (expected one of {UPLOAD_DTYPES})")
    return upload_dtype


def host_batch(padded: Sequence[Tuple[np.ndarray, np.ndarray]], upload_dtype: str) -> Tuple[np.ndarray, ...]:
    """Stack padded clouds into the host arrays that are uploaded:
    (points float32, mask) or, for uint16, (codes as int16 bits, offset,
    scale, mask)."""
    mask = np.stack([m for _, m in padded])
    if upload_dtype == "float32":
        return np.stack([p for p, _ in padded]), mask
    qs = [_quantize_u16(p) for p, _ in padded]
    return (np.stack([q for q, _, _ in qs]).view(np.int16), np.stack([lo for _, lo, _ in qs]),
            np.stack([s for _, _, s in qs]), mask)


def device_batch(host: Tuple[np.ndarray, ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upload ``host_batch``'s arrays -> (points (B, P, D) float32, mask
    (B, P) bool) on ``device``; uint16 codes are dequantised there."""
    tensors = [torch.from_numpy(a).to(device) for a in host]
    if len(tensors) == 2:
        return tensors[0], tensors[1]
    bits, offset, scale, mask = tensors
    codes = (bits.to(torch.int32) & 0xFFFF).to(torch.float32)
    return codes * scale[:, None, :] + offset[:, None, :], mask


def _fit_dim(cloud, input_dim: int, name: str) -> np.ndarray:
    cloud = np.asarray(cloud)
    if cloud.shape[1] > input_dim:
        return cloud[:, :input_dim]
    if cloud.shape[1] < input_dim:
        raise RuntimeError(f"Wrong point dimension in {name}.")
    return cloud


class ModelInferenceHelper:
    """Stateful wrapper over ``DeepCLR.encode`` / ``register`` /
    ``encode_register``; runs on the device of the model's parameters."""

    def __init__(self, model: DeepCLR, is_sequential: bool = False, num_points: int = 16384,
                 seed: int = 0, upload_dtype: str = "float32"):
        self._model = model.eval()
        self._device = next(model.parameters()).device
        self._input_dim = model.input_dim
        self._is_sequential = is_sequential
        self._num_points = num_points
        self._upload_dtype = _check_upload_dtype(upload_dtype)
        self._state: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(seed)
        self._morton = model.cloud_features.presorted
        self._calls = 0   # the id of each call's spans

    def has_state(self) -> bool:
        return self._state is not None

    def reset_state(self) -> None:
        """Drop cached features, e.g. when a new sequence starts."""
        self._state = None

    def _stack(self, clouds, name: str):
        with span("helper.pad"):
            # pad_cloud through the module global: a wrapper set there sees every call
            padded = [pad_cloud(_fit_dim(c, self._input_dim, name), self._num_points, self._rng,
                                morton=self._morton) for c in clouds]
        with span("helper.upload"):
            return device_batch(host_batch(padded, self._upload_dtype), self._device)

    @torch.inference_mode()
    def encode_cloud(self, cloud: np.ndarray) -> torch.Tensor:
        """Encode one raw cloud (N, D) -> (1, P, 3+C) features on the device."""
        pts, mask = self._stack([cloud], "cloud")
        with span("helper.model"):
            return self._model.encode(pts, mask)

    @torch.inference_mode()
    def predict_batch(self, sources, templates) -> np.ndarray:
        """Pairwise prediction for B independent pairs: sequences of B raw
        (N_i, D) clouds -> (B, label_dim).  The templates are padded first,
        as the JAX helper draws them, and the 2B clouds go through one
        stacked encode."""
        if self._is_sequential:
            raise RuntimeError("predict_batch is pairwise-only; use BatchedSequentialHelper "
                               "for batched sequential prediction.")
        if len(sources) != len(templates):
            raise RuntimeError("sources and templates must have equal length.")
        self._calls += 1
        with span("helper.predict", self._calls):
            t_pts, t_mask = self._stack(templates, "template")
            s_pts, s_mask = self._stack(sources, "source")
            with span("helper.model"):
                y = self._model(t_pts, s_pts, t_mask, s_mask)[0]
            with span("helper.fetch"):
                return y.cpu().numpy()

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
        elif template is None:
            raise RuntimeError("Source and template clouds are required for non-sequential prediction.")
        self._calls += 1
        with span("helper.predict", self._calls):
            if not self._is_sequential:
                f0 = self.encode_cloud(template)
                f1 = self.encode_cloud(source)
                with span("helper.model"):
                    y = self._model.register(f0, f1)
            elif self._state is None:
                self._state = self.encode_cloud(source)
                return None
            else:
                pts, mask = self._stack([source], "source")
                with span("helper.model"):
                    y, self._state = self._model.encode_register(self._state, pts, mask)
            with span("helper.fetch"):
                return y[0].cpu().numpy()


class BatchedSequentialHelper:
    """Sequential odometry over B independent streams in lock-step.

    Each :meth:`step` takes one frame a stream, encodes the B clouds in one
    batch and registers them against each stream's cached previous-frame
    features (one ``encode_register``), so the per-call host cost is shared
    B ways.  Lane i subsamples from ``default_rng(seed + i)``, so its
    predictions are those of a :class:`ModelInferenceHelper` built with
    ``seed + i`` and driven frame by frame.  :meth:`reset_stream` starts a
    new sequence on one lane: its next step seeds the state and yields None.
    """

    def __init__(self, model: DeepCLR, batch: int, num_points: int = 16384, seed: int = 0,
                 upload_dtype: str = "float32"):
        self._model = model.eval()
        self._device = next(model.parameters()).device
        self._input_dim = model.input_dim
        self._batch = batch
        self._num_points = num_points
        self._upload_dtype = _check_upload_dtype(upload_dtype)
        self._state: Optional[torch.Tensor] = None  # (B, P, 3+C) previous-frame features
        self._fresh = np.ones(batch, bool)  # lanes without a template yet
        self._rngs = [np.random.default_rng(seed + i) for i in range(batch)]
        self._morton = model.cloud_features.presorted
        self._calls = 0   # the id of each step's spans

    def reset_stream(self, i: int) -> None:
        """Start a new sequence on lane ``i`` (its next step only seeds state)."""
        self._fresh[i] = True

    def reset_all(self) -> None:
        self._fresh[:] = True
        # the next step only encodes: a retained state would cost one
        # register whose outputs are all discarded
        self._state = None

    def pad(self, clouds) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Pad or subsample one frame a lane, lane i from its own RNG."""
        if len(clouds) != self._batch:
            raise RuntimeError(f"Expected {self._batch} clouds, got {len(clouds)}.")
        with span("helper.pad"):
            return [pad_cloud(_fit_dim(c, self._input_dim, f"stream {i}"), self._num_points, self._rngs[i],
                              morton=self._morton) for i, c in enumerate(clouds)]

    @torch.inference_mode()
    def step(self, clouds) -> list:
        """Advance every stream by one frame.

        ``clouds``: B raw (N_i, D) arrays, one frame a stream (lanes may
        differ in point count).  Returns B entries: a (label_dim,)
        prediction, or None for a lane whose stream just (re)started.  A
        finished stream can keep receiving its last frame; ignore its
        outputs.
        """
        self._calls += 1
        with span("helper.predict", self._calls):
            padded = self.pad(clouds)
            with span("helper.upload"):
                pts, mask = device_batch(host_batch(padded, self._upload_dtype), self._device)
            if self._state is None:
                # seeding step: encode only (no template to register against)
                with span("helper.model"):
                    self._state = self._model.encode(pts, mask)
                self._fresh[:] = False
                return [None] * self._batch
            with span("helper.model"):
                y, feats = self._model.encode_register(self._state, pts, mask)
            with span("helper.fetch"):
                y = y.cpu().numpy()
        out = [None if self._fresh[i] else y[i] for i in range(self._batch)]
        self._state = feats
        self._fresh[:] = False
        return out
