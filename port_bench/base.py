"""What every way of driving the program shares (``entries/<name>.py``
subclass these): the program built from the configuration with weights from
the seed, the benchmark's spans, and the inference helper's pad wrapper.

An entry builds the program in ``setup`` (weights from the seed, inputs
from the traffic file), warms up every shape its window uses, runs the
window (``run``) or a profiled stretch (``stretch``), takes what the check
needs from the program after the window (``finish``), frees the program
(``release``) and hands what the window produced to ``check``.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic
from .weights import make_weights


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host seconds and counts the benchmark records around calls into
    the program (traced runs only)."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] += seconds
        self.counts[name] += 1


class Entry:
    def __init__(self, cell):
        self.cell = cell
        self.device = cell.device
        self.model_cfg = cell.config["model"]
        self.num_points = int(cell.config["num_points"])
        self.spans: Optional[Spans] = None
        self.split: Dict[str, float] = {}   # seconds of the set-up's parts
        self.marks: List[tuple] = []        # (seconds into the window, units done) about every second

    def inputs(self, batches: bool = False):
        """The cell's inputs from its traffic file and the seed (training
        ``batches`` or raw clouds), timed as set-up's data."""
        t0 = time.perf_counter()
        out = traffic.make(self.cell.traffic, self.cell.seed, self.cell.clouds, batches)
        self.split["data_s"] = time.perf_counter() - t0
        return out

    def _model(self):
        from deepclr_tpu_torch.models import build_model

        t0 = time.perf_counter()
        self.weights = make_weights(self.model_cfg, self.cell.seed, self.device)
        model = build_model(self.model_cfg, device=self.device, seed=self.cell.seed % 2 ** 31)
        model.load_state_dict(self.weights, strict=True)
        self.split["model_s"] = time.perf_counter() - t0
        return model

    def finish(self) -> None:
        """After the window and before ``release``: what the check takes from the program."""

    def release(self) -> None:
        for name in ("model", "helper", "step", "state", "optimizer"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class HelperEntry(Entry):
    """The inference helper's entries.  Every pad of a raw cloud draws from
    the helper's own generator, seeded by the benchmark; ``draws`` lists the
    cloud each pad took, in order, so the reference can replay them."""

    def _instrument(self, spans: Optional[Spans]):
        """Time and annotate ``models.base.pad_cloud`` into ``spans``."""
        from deepclr_tpu_torch.models import base

        if spans is None:
            return None
        original = base.pad_cloud

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function("pad_cloud"):
                out = original(*args, **kwargs)
            spans.add("pad_cloud", time.perf_counter() - t0)
            return out

        base.pad_cloud = timed
        return original

    def _restore(self, original) -> None:
        from deepclr_tpu_torch.models import base

        if original is not None:
            base.pad_cloud = original

    def setup_helper(self, **kwargs) -> None:
        from deepclr_tpu_torch.models import ModelInferenceHelper

        self.frames = self.inputs()
        self.model = self._model()
        self.helper = ModelInferenceHelper(self.model, num_points=self.num_points,
                                           seed=traffic.helper_seed(self.cell.seed), **kwargs)
        self.draws: List[int] = []
        self.outputs: List[tuple] = []   # (draw positions, pose) of each answer in the window

    @staticmethod
    def failures(outputs) -> int:
        return sum(1 for _, p in outputs if p is None or not np.all(np.isfinite(p)))
