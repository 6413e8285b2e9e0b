"""The trainer's own step (``engine.make_train_step``) on the recipe's
optimizer and loss, in a closed loop, batches handed over as host numpy as
the loader hands them.  One micro-step is one unit; the optimizer updates
every ``accumulation_steps`` of them, and a window ends on an update.

What the check compares: the first three micro-steps, taken in set-up on
three different batches from the seed's weights (``first_*``); and, after
the window, the next update and the next Lookahead sync that the window's
own call takes from the state the window left (``window_updates``), each
with a snapshot of the parameters and of the optimizer's state before it."""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import check
from port_bench.base import Entry, synchronize
from port_bench.check import norms
from port_bench.reference import deepclr as ref


class TrainEntry(Entry):
    def setup(self) -> None:
        from deepclr_tpu_torch import solver
        from deepclr_tpu_torch.engine import create_train_state, make_train_step
        from deepclr_tpu_torch.losses import make_loss_fn, make_metric_fns

        tr = self.cell.config["train"]
        self.batches = self.inputs(batches=True)
        self.lr = float(self.cell.traffic["lr"])
        self.k = int(tr["optimizer"].get("accumulation_steps", 1))
        self.model = self._model()
        self.optimizer = solver.make_optimizer(tr, self.model.parameters())
        label = self.model_cfg["label_type"]
        base_loss = make_loss_fn(tr["metrics"]["loss"], label)
        self._seen: Optional[List[tuple]] = []

        def loss_fn(y_pred, y):
            value = base_loss(y_pred, y)
            if self._seen is not None:   # micro-steps the check follows: (loss, poses)
                self._seen.append((value.detach().clone(), y_pred.detach().clone()))
            return value

        self.step = make_train_step(
            self.model, self.optimizer, loss_fn, make_metric_fns(tr["metrics"]["loss"], tr["metrics"]["other"], label),
            accumulation_steps=self.k,
            ema_alpha=float(tr["metrics"].get("running_average_alpha", 0.5)))
        self.state = create_train_state(self.model)
        self.next = 0
        t0 = time.perf_counter()
        self.params = dict(self.model.named_parameters())
        # the first three micro-steps, on three different batches: the ones
        # the reference follows from the seed's weights
        for i in range(3):
            self._one()
            if i == 1:   # the first update: its gradient from the optimizer's first moment
                self.first_grad = {n: self._moment(p) / (1.0 - ref.RANGER_B1) for n, p in self.params.items()}
        self.first_grad = norms(self.first_grad)
        self.first_change = norms({n: p.detach() - self.weights[n] for n, p in self.params.items()})
        self.first_losses, self.first_poses = self._taken()
        while self.next < int(self.cell.traffic["warmup_steps"]):
            self._one()
        synchronize(self.device)
        self.split["warmup_s"] = time.perf_counter() - t0

    def _taken(self):
        """The losses and poses of the micro-steps seen since capture began; capture ends."""
        seen, self._seen = self._seen, None
        return [float(v) for v, _ in seen], [y.double().cpu().numpy() for _, y in seen]

    def _moment(self, p) -> torch.Tensor:
        mu = self.optimizer.state.get(p, {}).get("mu")
        return torch.zeros_like(p, dtype=torch.float64) if mu is None else mu.double()

    def _one(self) -> None:
        self.metrics = self.step(self.state, self.batches[self.next % len(self.batches)], self.lr)
        self.next += 1

    def _instrument(self):
        if self.spans is None:
            return []
        started = {}

        def pre(*_):
            started["t"] = time.perf_counter()

        def post(*_):
            self.spans.add("optimizer.step", time.perf_counter() - started["t"])

        return [self.optimizer.register_step_pre_hook(pre), self.optimizer.register_step_post_hook(post)]

    def run(self, seconds: float) -> Dict[str, float]:
        hooks = self._instrument()
        try:
            steps = 0
            synchronize(self.device)
            t0 = time.perf_counter()
            mark = t0 + 1.0
            while True:
                self._one()
                steps += 1
                now = time.perf_counter()
                if now >= mark:
                    self.marks.append((now - t0, steps))
                    mark += 1.0
                if steps % self.k == 0 and now - t0 >= seconds:
                    break
            synchronize(self.device)
            elapsed = time.perf_counter() - t0
        finally:
            for h in hooks:
                h.remove()
        pairs = steps * self.batches[0]["template"].shape[0]
        self.attempted = steps
        self.failed = 0 if all(math.isfinite(float(v)) for v in self.metrics.values()) else steps
        return {"seconds": elapsed, "units": steps, "micro_steps": steps, "updates": steps // self.k, "pairs": pairs,
                "train_pairs_per_s": pairs / elapsed}

    def stretch(self, units: int) -> int:
        for _ in range(units):
            self._one()
        return units

    def stretch_inputs(self, units: int) -> List[Dict[str, np.ndarray]]:
        """The batches of the last ``units`` micro-steps."""
        return [self.batches[i % len(self.batches)] for i in range(self.next - units, self.next)]

    def _window_update(self) -> Dict:
        """One update by the window's own call from the state it finds: the
        snapshot before it (parameters and optimizer state), its batches,
        and what it did (each leaf's change and the gradient the optimizer
        got, from its first moment; the losses and poses of its micro-steps)."""
        opt = self.optimizer
        snap = {n: {"param": p.detach().clone(),
                    **{k: (v.clone() if torch.is_tensor(v) else v) for k, v in opt.state.get(p, {}).items()}}
                for n, p in self.params.items()}
        rows = [(self.next + i) % len(self.batches) for i in range(self.k)]
        self._seen = []
        for _ in range(self.k):
            self._one()
        losses, poses = self._taken()
        b1 = ref.RANGER_B1
        grad = {n: (self._moment(p) - b1 * snap[n]["mu"].double()) / (1.0 - b1) if "mu" in snap[n]
                else self._moment(p) / (1.0 - b1) for n, p in self.params.items()}
        return {"snapshot": snap, "rows": rows, "losses": losses, "poses": poses, "grad": grad,
                "change": {n: p.detach() - snap[n]["param"] for n, p in self.params.items()}}

    def _lookahead_count(self) -> int:
        state = self.optimizer.state.get(next(iter(self.params.values())), {})
        return int(state.get("la_count", 0))

    def finish(self) -> None:
        """The next update after the window, and the next one that syncs
        Lookahead (every ``ref.RANGER_SYNC`` updates) if that was not it."""
        self.window_updates = [self._window_update()]
        if self._lookahead_count() % ref.RANGER_SYNC:
            while (self._lookahead_count() + 1) % ref.RANGER_SYNC:
                for _ in range(self.k):
                    self._one()
            self.window_updates.append(self._window_update())
        synchronize(self.device)

    def check(self, extras=()) -> Dict[str, Dict[str, float]]:
        dev = self.device
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()} for b in self.batches]
        return check.train_numbers(self, batches, extras)


ENTRY = TrainEntry
