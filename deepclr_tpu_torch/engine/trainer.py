"""Training engine: the train step and the host-side loop.

The reference's observable behaviour: gradient accumulation, running-average
metrics, periodic log / checkpoint events, a raise on a non-finite loss, and
interrupt / exception checkpoints.  Configs are plain dicts with the
sections of a training YAML (``configs.KITTI_TRAIN_CFG``); batches are dicts
of arrays or tensors with the keys of ``BATCH_KEYS``.

Validation (the Evaluator and its KITTI plots), TensorBoard summaries and
data-parallel training are not part of this package yet: ``run_trainer``
raises when given a validation loader.
"""
from __future__ import annotations

import logging
import math
import signal
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..models.deepclr import OutputSimple
from .checkpoint import Checkpointer, load_checkpoint

__all__ = ["BATCH_KEYS", "TrainState", "create_train_state", "make_train_step", "run_trainer",
           "install_sigint_handler"]

BATCH_KEYS = ("template", "source", "template_mask", "source_mask", "aug_template", "aug_source", "y")

logger = logging.getLogger(__name__)

# Interrupt-checkpoint contract: once the loop has exited (completed,
# interrupted or crashed) the resumable state is being persisted, and a late
# SIGINT must not flip the exit status.  The event is set the moment the run
# enters its shutdown path; the SIGINT handler downgrades the signal to a log
# line from then on.
_shutdown = threading.Event()

# A train step updates the parameters and optimizer state in place, one
# tensor after another.  A KeyboardInterrupt in the middle would leave them
# half-updated and the interrupt checkpoint inconsistent.  While
# _defer_depth > 0 the SIGINT handler records the signal instead of raising;
# _defer_interrupt re-raises it at the context exit, between two steps.
_defer_depth = 0
_interrupt_pending = False


@contextmanager
def _defer_interrupt():
    global _defer_depth, _interrupt_pending
    _defer_depth += 1
    try:
        yield
    finally:
        _defer_depth -= 1
        if _interrupt_pending and _defer_depth == 0:
            _interrupt_pending = False
            raise KeyboardInterrupt


def _sigint_handler(signum, frame):
    """Module-level singleton, so installing it twice keeps it installed."""
    global _interrupt_pending
    if _shutdown.is_set():
        print("SIGINT ignored: training state already persisted / shutdown in progress", flush=True)
        return
    if _defer_depth > 0:
        _interrupt_pending = True
        return
    raise KeyboardInterrupt


def install_sigint_handler():
    """Install the shutdown-aware SIGINT handler (raise KeyboardInterrupt
    until shutdown starts, ignore after).  Returns the previous handler, or
    None off the main thread, where signal handlers cannot be set."""
    try:
        return signal.signal(signal.SIGINT, _sigint_handler)
    except ValueError:
        return None


@dataclass
class TrainState:
    """What the train step carries besides the model and the optimizer."""

    step: int = 0                                        # micro-steps taken
    metrics_ema: Dict[str, torch.Tensor] = field(default_factory=dict)
    param_ema: Optional[Dict[str, torch.Tensor]] = None  # Polyak average, when kept

    def state_dict(self, model: nn.Module, optimizer) -> Dict[str, Any]:
        return {"step": self.step, "metrics_ema": dict(self.metrics_ema), "param_ema": self.param_ema,
                "model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "grad_acc": {n: p.grad for n, p in model.named_parameters() if p.grad is not None}}

    def load_state_dict(self, state: Dict[str, Any], model: nn.Module, optimizer) -> None:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        for n, p in model.named_parameters():
            g = state["grad_acc"].get(n)
            p.grad = None if g is None else g.to(p.device).clone()
        dev = next(model.parameters()).device
        self.step = int(state["step"])
        self.metrics_ema = {k: v.to(dev) for k, v in state["metrics_ema"].items()}
        self.param_ema = (None if state["param_ema"] is None
                          else {k: v.to(dev) for k, v in state["param_ema"].items()})


def create_train_state(model: nn.Module, weight_ema: bool = False) -> TrainState:
    """A fresh state; with ``weight_ema`` the average starts at the current
    parameters (which needs no bias correction)."""
    ema = {n: p.detach().clone() for n, p in model.named_parameters()} if weight_ema else None
    return TrainState(param_ema=ema)


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in BATCH_KEYS if k in batch}


def make_train_step(model: nn.Module, optimizer, loss_fn: Callable, metric_fns: Dict[str, Callable],
                    accumulation_steps: int = 1, ema_alpha: float = 0.5, use_model_loss: bool = False,
                    weight_ema_decay: float = 0.0) -> Callable:
    """The train step: (state, batch, lr) -> metric EMAs.

    Each micro-step writes ``lr`` into the optimizer, runs the model on the
    batch, and adds the gradient of loss / k to the parameters' ``.grad``
    (k = ``accumulation_steps``).  Every k-th micro-step the optimizer
    updates the parameters and the gradients are cleared, so the optimizer's
    own counters (RAdam's, Lookahead's) advance only on real updates, as does
    the Polyak average ``state.param_ema`` (decay ``weight_ema_decay``).
    The metric EMAs (``loss`` = loss / k, ``loss_fn`` = loss, and each
    metric) take the first micro-step's values as they are, then
    ema * alpha + (1 - alpha) * value.  With ``use_model_loss`` the loss is
    the model's own loss module's.  The step puts the model in training
    mode, so a pose head with dropout (keep probability < 1) drops out,
    with masks seeded from the model's seed and ``state.step``: a resumed
    run draws the masks an uninterrupted one would.
    """
    k = int(accumulation_steps)
    device = next(model.parameters()).device
    heads = [m for m in model.modules() if isinstance(m, OutputSimple)]

    def train_step(state: TrainState, batch: Dict[str, Any], lr: float) -> Dict[str, torch.Tensor]:
        if state.param_ema is not None and not weight_ema_decay > 0.0:
            raise ValueError("state carries param_ema but weight_ema_decay is 0")
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        b = _to_device(batch, device)
        model.train()
        for head in heads:
            head.seed_dropout(state.step)
        y_pred, model_loss = model(b["template"], b["source"], b.get("template_mask"),
                                   b.get("source_mask"), b.get("aug_template"), b.get("aug_source"),
                                   y=b["y"])
        loss = model_loss if use_model_loss else loss_fn(y_pred, b["y"])
        (loss / k).backward()
        state.step += 1
        if state.step % k == 0:
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if state.param_ema is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        e = state.param_ema[n]
                        e.copy_(e * weight_ema_decay + (1.0 - weight_ema_decay) * p)
        with torch.no_grad():
            values = {"loss": loss.detach() / k, "loss_fn": loss.detach()}
            y_pred = y_pred.detach()
            for name, fn in metric_fns.items():
                values[name] = fn(y_pred, b["y"])
            for name, v in values.items():
                old = state.metrics_ema.get(name)
                state.metrics_ema[name] = v if old is None or state.step == 1 else \
                    old * ema_alpha + (1 - ema_alpha) * v
        return state.metrics_ema

    return train_step


def run_trainer(cfg: Dict[str, Any], model: nn.Module, train_loader, val_loader, optimizer,
                schedule: Callable[[int], float], loss_fn: Callable, metric_fns: Dict[str, Callable],
                output_dir: Optional[str] = None, checkpoint: Optional[str] = None) -> TrainState:
    """The training loop over ``train_loader`` (a sized iterable of batch
    dicts); returns the final state.

    ``cfg`` sections read: optimizer (max_iterations / max_epochs,
    accumulation_steps, weight_ema_decay), metrics (running_average_alpha),
    scheduler (on_iteration / on_validation, else per epoch), logging
    (log_period, checkpoint_period, checkpoint_n_saved).  With
    ``output_dir`` it writes periodic checkpoints there and a final,
    interrupt or exception checkpoint when the loop ends; ``checkpoint``
    resumes from a full checkpoint.  A non-finite loss at a log period
    raises ValueError (after an exception checkpoint).
    """
    if val_loader is not None:
        raise NotImplementedError("validation (the Evaluator) is not ported; pass val_loader=None")
    opt_cfg, log_cfg = cfg["optimizer"], cfg.get("logging") or {}
    sched_cfg = cfg.get("scheduler") or {}
    log_period = int(log_cfg.get("log_period", 1000))
    checkpoint_period = int(log_cfg.get("checkpoint_period", 1000))
    batch_size = int((cfg.get("data_loader") or {}).get("batch_size", 1))
    weight_ema_decay = float(opt_cfg.get("weight_ema_decay") or 0.0)

    loader_len = len(train_loader)
    max_iterations = opt_cfg.get("max_iterations")
    max_epochs = opt_cfg.get("max_epochs")
    if max_iterations is not None:
        epochs = int(math.ceil(max_iterations / loader_len))
        if max_epochs is not None:
            epochs = min(int(max_epochs), epochs)
    else:
        epochs = int(max_epochs)
        max_iterations = epochs * loader_len

    train_step = make_train_step(
        model, optimizer, loss_fn, metric_fns,
        accumulation_steps=int(opt_cfg.get("accumulation_steps", 1)),
        ema_alpha=float((cfg.get("metrics") or {}).get("running_average_alpha", 0.5)),
        use_model_loss=getattr(model, "loss_module", None) is not None,
        weight_ema_decay=weight_ema_decay)
    state = create_train_state(model, weight_ema=weight_ema_decay > 0.0)

    start_epoch = iteration = 0
    if checkpoint is not None:
        restored = load_checkpoint(checkpoint, map_location=next(model.parameters()).device)
        state.load_state_dict(restored["state"], model, optimizer)
        start_epoch, iteration = int(restored["epoch"]), int(restored["iteration"])
        logger.info(f"Restored checkpoint at epoch {start_epoch}, iteration {iteration}")

    checkpointer = None
    if output_dir:
        checkpointer = Checkpointer(output_dir, n_saved=int(log_cfg.get("checkpoint_n_saved", 10)))

    def scheduler_count() -> int:
        if sched_cfg.get("on_iteration"):
            return iteration
        if sched_cfg.get("on_validation"):
            return 0  # no validation runs in this package
        return epoch

    def save_ckpt(special: Optional[str] = None) -> None:
        if checkpointer is None:
            return
        payload = state.state_dict(model, optimizer)
        if special is not None:
            checkpointer.save_special_checkpoint(special, epoch, iteration, payload, payload["model"],
                                                 state.param_ema)
        else:
            checkpointer.save_checkpoint(epoch, iteration, payload, payload["model"], state.param_ema)

    logger.info(f"Start training for {epochs} epochs ({max_iterations} iterations)")
    epoch = start_epoch
    _shutdown.clear()
    global _interrupt_pending
    _interrupt_pending = False
    prev_sigint = install_sigint_handler()
    try:
        done = False
        for epoch in range(start_epoch, epochs):
            t_epoch = time.monotonic()
            n_batches = 0
            metrics = None
            for batch in train_loader:
                lr = schedule(scheduler_count())
                with _defer_interrupt():
                    metrics = train_step(state, batch, lr)
                iteration += 1
                n_batches += 1
                if iteration % log_period == 0:
                    loss_val = float(metrics["loss"])
                    if not math.isfinite(loss_val):
                        raise ValueError(f"Invalid loss: {loss_val}")
                    logger.info(f"Epoch[{epoch + 1}] Iteration[{(iteration - 1) % loader_len + 1}/"
                                f"{loader_len}] Loss: {loss_val:.6f}")
                if iteration % checkpoint_period == 0:
                    save_ckpt()
                if iteration >= max_iterations:
                    done = True
                    break
            if n_batches and metrics is not None:
                tpb = (time.monotonic() - t_epoch) / n_batches
                logger.info(f"Epoch {epoch + 1} done. Avg Loss: {float(metrics['loss']):.6f} "
                            f"Time per batch: {tpb:.3f}[s] Speed: {batch_size / tpb:.1f}[samples/s]")
            if done:
                break

        _shutdown.set()  # loop done: a late SIGINT must not kill the flush
        logger.info("Training completed")
        save_ckpt("final")
    except KeyboardInterrupt:
        _shutdown.set()
        logger.info("KeyboardInterrupt. Stopping training.")
        save_ckpt("interrupt")
    except Exception as e:
        _shutdown.set()
        logger.info(f"{type(e).__name__} raised: {e}")
        save_ckpt("exception")
        raise
    finally:
        # restore only a foreign previous handler: restoring the default one
        # would reopen the late-SIGINT window for a caller that installed ours
        if prev_sigint is not None and prev_sigint is not _sigint_handler:
            signal.signal(signal.SIGINT, prev_sigint)
    return state
