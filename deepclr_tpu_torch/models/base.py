"""Inference helpers: sequential and pairwise prediction with fixed shapes.

In sequential mode every LiDAR frame is encoded exactly once; the previous
frame's features are cached so each step runs one fused encode+register.
Clouds are padded or randomly subsampled to a fixed ``num_points`` buffer
with a validity mask, using the same numpy RNG streams as the JAX helpers,
and Morton-sorted on the host when the model is built ``presorted``.

Each call is a ``helper.predict`` span (``utils.profiling.span``; its id
the helper's call count) with the children ``helper.pad`` (fit and pad or
subsample the clouds), ``helper.upload`` (stack where needed and copy to
the device), ``helper.model`` (dispatch of the model's call) and
``helper.fetch`` (the pose back on the host: the wait for the device).

On a CUDA device a sequential helper replays its step as one CUDA graph
(``_SequentialGraph``): the host then launches one graph a frame instead
of every kernel and torch op of ``encode_register``.  Each registering
frame reaches the graph's inputs from its pinned staging by one
asynchronous copy an input: ``pad_cloud`` writes float32 frames straight
into it, and uint16 codes are quantised into it.  ``graph_counts`` says
how often it did each; a capture is a ``helper.capture`` span inside
``helper.model``.

``upload_dtype="uint16"`` quantises each padded cloud per axis on the host
(``_quantize_u16``) and uploads the 16-bit codes, half the float32 bytes;
the card dequantises (``q * scale + offset``).  The codes travel as int16
bits (the same 16 bits; torch's uint16 has few CUDA ops) and are widened
with ``& 0xFFFF`` on the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.morton import morton_argsort_np
from ..utils.profiling import span
from .deepclr import DeepCLR

__all__ = ["BatchedSequentialHelper", "ModelInferenceHelper", "UPLOAD_DTYPES", "pad_cloud"]

UPLOAD_DTYPES = ("float32", "uint16")


def pad_cloud(points: np.ndarray, num_points: int,
              rng: Optional[np.random.Generator] = None,
              morton: bool = False,
              out: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Pad (with zeros + mask) or uniformly subsample a cloud to exactly
    num_points; ``morton=True`` Morton-sorts the valid points.  Returns
    (points (num_points, D) float32, mask (num_points,) bool): new arrays,
    or the ``out`` pair of such arrays, filled in place.  Every row of
    both is written, so a reused pair keeps nothing of an earlier cloud."""
    n, d = points.shape
    idx = None
    if n > num_points:
        rng = rng or np.random.default_rng(0)
        idx, n = rng.choice(n, size=num_points, replace=False), num_points
    if morton and n > 1:
        order = morton_argsort_np(points if idx is None else points[idx])
        idx = order if idx is None else idx[order]
    pts, mask = out if out is not None else (np.empty((num_points, d), np.float32), np.empty(num_points, bool))
    if idx is None:
        pts[:n] = points
    else:   # the indices are in range: "clip" skips the buffered write of "raise"
        np.take(points, idx, axis=0, out=pts[:n], mode="clip")
    pts[n:] = 0
    mask[:n] = True
    mask[n:] = False
    return pts, mask


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


def host_layout(batch: int, num_points: int, dim: int, upload_dtype: str) -> List[Tuple[tuple, np.dtype]]:
    """The (shape, dtype) of each host array that is uploaded for ``batch``
    clouds of ``num_points`` points of ``dim`` coordinates: (points
    float32, mask) or, for uint16, (codes as int16 bits, offset, scale,
    mask)."""
    mask = ((batch, num_points), np.dtype(bool))
    if upload_dtype == "float32":
        return [((batch, num_points, dim), np.dtype(np.float32)), mask]
    return [((batch, num_points, dim), np.dtype(np.int16)), ((batch, dim), np.dtype(np.float32)),
            ((batch, dim), np.dtype(np.float32)), mask]


def host_batch(padded: Sequence[Tuple[np.ndarray, np.ndarray]], upload_dtype: str,
               out: Optional[Sequence[np.ndarray]] = None) -> Tuple[np.ndarray, ...]:
    """Stack padded clouds into the host arrays that are uploaded, laid out
    as ``host_layout`` says: new arrays, or ``out``'s, filled in place."""
    if out is None:
        num_points, dim = padded[0][0].shape
        out = [np.empty(shape, dtype) for shape, dtype in host_layout(len(padded), num_points, dim, upload_dtype)]
    for i, (pts, mask) in enumerate(padded):
        out[-1][i] = mask
        if upload_dtype == "float32":
            out[0][i] = pts
        else:
            q, out[1][i], out[2][i] = _quantize_u16(pts)
            out[0][i] = q.view(np.int16)
    return tuple(out)


def device_batch(host: Tuple[np.ndarray, ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upload ``host_batch``'s arrays -> (points (B, P, D) float32, mask
    (B, P) bool) on ``device``; uint16 codes are dequantised there."""
    return _dequantise([torch.from_numpy(a).to(device) for a in host])


def _dequantise(tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``host_batch``'s arrays on the device -> (points float32, mask)."""
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


class _SequentialGraph:
    """A sequential step on the card as one CUDA graph, on static buffers:
    the inputs (laid out as ``host_layout`` says), the previous frame's
    features (``state``) and the pose.  The inputs come in each frame from
    host twins of them (``staging``, numpy views, page-locked on the card)
    by one asynchronous copy each.  The graph holds the uint16
    dequantisation, ``encode_register(state, points, mask)`` and the copy
    of the new features into ``state``, which stream order puts after the
    register has read the old ones.

    The first ``run`` is the eager warm-up that capture needs, on a side
    stream; the second captures the step and replays it; every later one
    replays.  A replay issues the launches of an eager step, in its order
    and on its inputs, but goes through no ``CudaKernel.launch``: replays
    add no launch counts.  The graph reads the model's parameters where
    they lie, so a ``load_state_dict`` (which copies in place) changes
    the weights it runs."""

    def __init__(self, layout: Sequence[Tuple[tuple, np.dtype]], state: torch.Tensor):
        self._pinned = [torch.from_numpy(np.empty(shape, dtype)) for shape, dtype in layout]
        self._uploaded = None   # on the card, the event of the last copy out of the staging
        if state.is_cuda:
            self._pinned = [p.pin_memory() for p in self._pinned]
            self._uploaded = torch.cuda.Event()
        self._staging = [p.numpy() for p in self._pinned]
        self.inputs = [torch.empty_like(p, device=state.device) for p in self._pinned]
        self.state = torch.empty_like(state)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pose: Optional[torch.Tensor] = None
        self.warm = False

    def staging(self) -> List[np.ndarray]:
        """The host twins of the inputs as numpy arrays, once the last
        upload from them has finished (the fetch of its pose has waited
        for it already), so they are free to write."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        return self._staging

    def load(self, state: torch.Tensor) -> None:
        """Copy the staging in, asynchronously on the current stream (which
        puts the copy before the step), and the features to register
        against when they are not already the state buffer's (the first
        frame, a frame after ``reset_state``)."""
        for buf, host in zip(self.inputs, self._pinned):
            buf.copy_(host, non_blocking=True)
        if self._uploaded is not None:
            self._uploaded.record(torch.cuda.current_stream(state.device))
        if state is not self.state:
            self.state.copy_(state)

    def _step(self, model: DeepCLR) -> torch.Tensor:
        y, feats = model.encode_register(self.state, *_dequantise(self.inputs))
        self.state.copy_(feats)
        return y

    def run(self, model: DeepCLR, counts: Dict[str, int]) -> torch.Tensor:
        """The step on the loaded inputs -> the pose (1, label_dim) on the
        device; ``counts`` gains the eager run, capture or replay."""
        with torch.cuda.device(self.state.device):
            if not self.warm:
                current = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    y = self._step(model)
                current.wait_stream(side)
                self.warm = True
                counts["eager"] += 1
                return y
            if self.graph is None:
                with span("helper.capture"):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.pose = self._step(model)
                counts["captures"] += 1
            self.graph.replay()
        counts["replays"] += 1
        return self.pose


class ModelInferenceHelper:
    """Stateful wrapper over ``DeepCLR.encode`` / ``register`` /
    ``encode_register``; runs on the device of the model's parameters.

    Sequential on a CUDA device, the registering frames run as a CUDA
    graph (``_SequentialGraph``), one a helper: the first registering
    frame runs eagerly, the second captures, every later one replays.
    ``pad_cloud`` fills the graph's pinned staging with a float32 frame,
    which then needs no stack and no pageable copy; a uint16 frame is
    padded into new arrays and its codes, which need the padded cloud's
    range, are quantised into the staging.  Encode-only frames (the first,
    and the first after ``reset_state``) run eagerly; the next registering
    frame copies their features into the graph's state buffer.  On the CPU
    every frame runs eagerly."""

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
        self._graph: Optional[_SequentialGraph] = None
        self._graph_counts = {"captures": 0, "replays": 0, "eager": 0}

    def has_state(self) -> bool:
        return self._state is not None

    def reset_state(self) -> None:
        """Drop cached features, e.g. when a new sequence starts."""
        self._state = None

    def graph_counts(self) -> Dict[str, int]:
        """Sequential frames that registered, by how: ``replays`` of a CUDA
        graph, ``eager`` runs (every one on the CPU; the warm-up before a
        capture on the card), and the ``captures``; counted whether or not
        spans are on.  Replays over registering frames is the share the
        graph ran."""
        return dict(self._graph_counts)

    def _pad(self, clouds, name: str, outs=None):
        """Each cloud fitted and padded into new arrays, or into its pair
        of ``outs``."""
        with span("helper.pad"):
            # pad_cloud through the module global: a wrapper set there sees every call
            return [pad_cloud(_fit_dim(c, self._input_dim, name), self._num_points, self._rng,
                              morton=self._morton, out=out) for c, out in zip(clouds, outs or [None] * len(clouds))]

    def _stack(self, clouds, name: str):
        padded = self._pad(clouds, name)
        with span("helper.upload"):
            return device_batch(host_batch(padded, self._upload_dtype), self._device)

    def _register(self, source: np.ndarray) -> torch.Tensor:
        """One registering sequential frame -> its pose (1, label_dim) on
        the device; the new features become the state."""
        if self._device.type != "cuda":
            pts, mask = self._stack([source], "source")
            with span("helper.model"):
                y, self._state = self._model.encode_register(self._state, pts, mask)
            self._graph_counts["eager"] += 1
            return y
        graph = self._graph
        if graph is None:
            layout = host_layout(1, self._num_points, self._input_dim, self._upload_dtype)
            graph = self._graph = _SequentialGraph(layout, self._state)
        staging = graph.staging()
        float32 = self._upload_dtype == "float32"   # padded straight into the staging
        padded = self._pad([source], "source", [(staging[0][0], staging[1][0])] if float32 else None)
        with span("helper.upload"):
            if not float32:   # the codes need the padded cloud's range
                host_batch(padded, self._upload_dtype, out=staging)
            graph.load(self._state)
        with span("helper.model"):
            y = graph.run(self._model, self._graph_counts)
        self._state = graph.state
        return y

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
                y = self._register(source)
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
