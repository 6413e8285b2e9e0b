"""Training engine: the train step and the host-side loop.

The reference's observable behaviour: gradient accumulation, running-average
metrics, periodic log / summary / checkpoint / validation events, a raise on
a non-finite loss, and interrupt / exception checkpoints.  ``train`` takes
the ``Config`` of ``config.load_config``; ``run_trainer`` takes plain dicts
with the sections of a training YAML (``Config.to_dict()``, or
``configs.KITTI_TRAIN_CFG``) and sized iterables of batch dicts with the
keys of ``BATCH_KEYS`` (``data.DataLoader``, or lists).

Data parallel (a process group joined by ``parallel.maybe_initialize``):
each process trains on its own loader shard (``train``), the model runs
under DistributedDataParallel (``run_trainer``), and the global batch is
``batch_size`` × the process count, as in the JAX package.  Gradients,
batch-norm statistics, the logged metrics and the validation means are the
global batch's; only rank 0 writes files.  Dropout masks are drawn at the
global batch's shape in JAX's process-major layout (rank r applies rows
[r·B, (r+1)·B)); as the loader deals sample i to rank i mod W, they equal
the masks of one process fed the ranks' batches side by side, not those
of a plain one-process run of the global batch.
"""
from __future__ import annotations

import logging
import math
import os
import os.path as osp
import shutil
import signal
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..data import make_data_loader
from ..evaluation import Evaluator
from ..losses import make_loss_fn, make_metric_fns
from ..models import build_model
from ..models.deepclr import OutputSimple
from ..parallel import (allgather_host, allgather_host_f64, allgather_host_strings, any_over_processes, initialized,
                        is_primary, local_device, mean_over_processes, process_count, process_index,
                        set_process_group, wrap_data_parallel)
from ..solver import make_optimizer, make_schedule
from ..utils.logging import create_logger, create_summary_writer
from ..utils.profiling import span, span_stats
from .checkpoint import Checkpointer, load_checkpoint

__all__ = ["BATCH_KEYS", "TrainState", "create_train_state", "make_eval_step", "make_train_step", "run_trainer",
           "install_sigint_handler", "store_models_code", "train"]

BATCH_KEYS = ("template", "source", "template_mask", "source_mask", "aug_template", "aug_source", "y")

logger = logging.getLogger(__name__)

# Interrupt-checkpoint contract: once the loop has exited (completed,
# interrupted or crashed) the resumable state is being persisted, and a late
# SIGINT must not flip the exit status.  The event is set the moment the run
# enters its shutdown path; the SIGINT handler downgrades the signal to a log
# line from then on.
_shutdown = threading.Event()

# A train step updates the parameters and optimizer state in place, one
# tensor after another, and the loop then counts it (iteration, the
# periodic checkpoint).  A KeyboardInterrupt anywhere in between would leave
# the state half-updated, or a step ahead of the iteration the interrupt
# checkpoint records.  While _defer_depth > 0 the SIGINT handler records the
# signal instead of raising; _defer_interrupt re-raises it when the
# iteration's block ends, between two whole iterations.
#
# Under a process group of more than one rank an interrupt must stop every
# rank at the same iteration: the ranks then agree on it (run_trainer ends
# each iteration with a MAX all-reduce of the pending flag) and the handler
# only records the signal, wherever it lands in the loop.
_defer_depth = 0
_interrupt_pending = False
_group_agrees = False


@contextmanager
def _defer_interrupt():
    global _defer_depth, _interrupt_pending
    _defer_depth += 1
    try:
        yield
    finally:
        _defer_depth -= 1
    # reached only when the block ends normally (or by break): an exception
    # from the block propagates as it is
    if _interrupt_pending and _defer_depth == 0 and not _group_agrees:
        _interrupt_pending = False
        raise KeyboardInterrupt


def _sigint_handler(signum, frame):
    """Module-level singleton, so installing it twice keeps it installed."""
    global _interrupt_pending
    if _shutdown.is_set():
        print("SIGINT ignored: training state already persisted / shutdown in progress", flush=True)
        return
    if _defer_depth > 0 or _group_agrees:
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

    ``model`` is the model or its DistributedDataParallel wrapper.  Each
    micro-step writes ``lr`` into the optimizer, runs the model on the
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
    run draws the masks an uninterrupted one would.  Under
    DistributedDataParallel the first k − 1 micro-steps of an update keep
    their gradients local (``no_sync``) and the k-th averages the
    accumulated gradients over the processes; the metric values of every
    micro-step are averaged over the processes before the EMAs.

    Each micro-step is a ``train.step`` span (``utils.profiling.span``; its
    id ``state.step`` before the step) with the children ``train.upload``
    (the batch to the device: a pageable copy blocks here), ``train.forward``
    (the model and the loss), ``train.backward``, ``train.update`` (every
    k-th micro-step: the optimizer's step, ``zero_grad`` and the Polyak
    average) and ``train.metrics`` (the metric functions, the all-reduce and
    the EMAs).
    """
    k = int(accumulation_steps)
    ddp = model if isinstance(model, DistributedDataParallel) else None
    net = model.module if ddp is not None else model
    device = next(net.parameters()).device
    heads = [m for m in net.modules() if isinstance(m, OutputSimple)]

    def train_step(state: TrainState, batch: Dict[str, Any], lr: float) -> Dict[str, torch.Tensor]:
        if state.param_ema is not None and not weight_ema_decay > 0.0:
            raise ValueError("state carries param_ema but weight_ema_decay is 0")
        with span("train.step", state.step):
            for group in optimizer.param_groups:
                group["lr"] = float(lr)
            with span("train.upload"):
                b = _to_device(batch, device)
            net.train()
            for head in heads:
                head.seed_dropout(state.step)
            local = ddp is not None and (state.step + 1) % k != 0
            with ddp.no_sync() if local else nullcontext():
                with span("train.forward"):
                    y_pred, model_loss = model(b["template"], b["source"], b.get("template_mask"),
                                               b.get("source_mask"), b.get("aug_template"), b.get("aug_source"),
                                               y=b["y"])
                    loss = model_loss if use_model_loss else loss_fn(y_pred, b["y"])
                with span("train.backward"):
                    (loss / k).backward()
            state.step += 1
            if state.step % k == 0:
                with span("train.update"):
                    optimizer.step()
                    optimizer.zero_grad(set_to_none=True)
                    if state.param_ema is not None:
                        with torch.no_grad():
                            for n, p in net.named_parameters():
                                e = state.param_ema[n]
                                e.copy_(e * weight_ema_decay + (1.0 - weight_ema_decay) * p)
            with span("train.metrics"), torch.no_grad():
                values = {"loss": loss.detach() / k, "loss_fn": loss.detach()}
                y_pred = y_pred.detach()
                for name, fn in metric_fns.items():
                    values[name] = fn(y_pred, b["y"])
                if initialized():  # one all-reduce: the global batch's values
                    values = dict(zip(values, mean_over_processes(
                        torch.stack([v.float().reshape(()) for v in values.values()])).unbind()))
                for name, v in values.items():
                    old = state.metrics_ema.get(name)
                    state.metrics_ema[name] = v if old is None or state.step == 1 else \
                        old * ema_alpha + (1 - ema_alpha) * v
        return state.metrics_ema

    return train_step


def make_eval_step(model: nn.Module, metric_fns: Dict[str, Callable]) -> Callable:
    """The validation step: batch -> (y_pred, metrics).  The model runs in
    evaluation mode under ``torch.no_grad()`` (no dropout, no graph) and is
    put back in training mode afterwards."""
    device = next(model.parameters()).device

    def eval_step(batch: Dict[str, Any]):
        b = _to_device(batch, device)
        model.eval()
        try:
            with torch.no_grad():
                y_pred, _ = model(b["template"], b["source"], b.get("template_mask"), b.get("source_mask"),
                                  b.get("aug_template"), b.get("aug_source"))
                metrics = {name: fn(y_pred, b["y"]) for name, fn in metric_fns.items()}
        finally:
            model.train()
        return y_pred, metrics

    return eval_step


def store_models_code(path: str) -> None:
    """Copy the port's model source files next to the checkpoints."""
    src = osp.join(osp.dirname(osp.dirname(osp.realpath(__file__))), "models")
    os.makedirs(path, exist_ok=True)
    for f in os.listdir(src):
        if f.endswith(".py"):
            shutil.copy(osp.join(src, f), osp.join(path, f))


def train(cfg) -> "TrainState":
    """Training from a configuration (the ``Config`` that
    ``config.load_config`` returns): the model from ``cfg.seed`` on
    ``cfg.device``, the optimizer, schedule, loss and metrics of its
    sections, the training and validation loaders, then ``run_trainer``.
    With an output directory (modes NEW and CONTINUE) it first writes the
    experiment artifacts there: ``config.yaml``, ``model_config.yaml`` and
    the model code under ``models/``; with its checkpoints the directory is
    a model directory for ``python -m deepclr_tpu_torch.inference``.
    Under a process group each process builds the model on its own device
    and loads its shard of both splits (sample i goes to rank i mod the
    process count), and only rank 0 writes the artifacts and the log file.
    Returns the final train state."""
    device = cfg.device
    if initialized() and torch.device(device).type == "cuda":
        device = local_device()
    model = build_model(cfg.model, device=device, seed=cfg.seed)
    plain = cfg.to_dict()
    optimizer = make_optimizer(plain, model.parameters())
    schedule = make_schedule(plain)
    loss_fn = make_loss_fn(plain["metrics"]["loss"], cfg.model.label_type)
    metric_fns = make_metric_fns(plain["metrics"]["loss"], plain["metrics"]["other"], cfg.model.label_type)
    shard = dict(shard_index=process_index(), num_shards=process_count())
    train_loader = make_data_loader(cfg, is_train=True, **shard)
    val_loader = make_data_loader(cfg, is_train=False, **shard)
    if cfg.output_dir and is_primary():
        os.makedirs(cfg.output_dir, exist_ok=True)
        cfg.write_file(osp.join(cfg.output_dir, "config.yaml"))
        cfg.model.write_file(osp.join(cfg.output_dir, "model_config.yaml"))
        store_models_code(osp.join(cfg.output_dir, "models"))
    create_logger(logger.name, save_dir=cfg.output_dir, distributed_rank=process_index())
    return run_trainer(plain, model, train_loader, val_loader, optimizer, schedule, loss_fn, metric_fns,
                       output_dir=cfg.output_dir, checkpoint=cfg.checkpoint)


def _interrupt_agreed(device: torch.device) -> bool:
    """Every rank's pending interrupt, MAX-reduced over the group: True on
    every rank when any rank was interrupted.  A signal that lands after the
    flag was read stays pending for the next iteration."""
    global _interrupt_pending
    pending = _interrupt_pending
    if not any_over_processes(pending, device):
        return False
    _interrupt_pending = False
    return True


def _average_gradients(model: nn.Module) -> None:
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if grads:
        flat = mean_over_processes(torch.cat([g.reshape(-1) for g in grads]))
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def _loader_wait():
    """(count, seconds) of the ``loader.wait`` spans so far (none while spans are off)."""
    stats = span_stats().get("loader.wait")
    return (0, 0.0) if stats is None else (stats["count"], stats["seconds"])


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def run_trainer(cfg: Dict[str, Any], model: nn.Module, train_loader, val_loader, optimizer,
                schedule: Callable[[int], float], loss_fn: Callable, metric_fns: Dict[str, Callable],
                output_dir: Optional[str] = None, checkpoint: Optional[str] = None) -> TrainState:
    """The training loop over ``train_loader`` (a sized iterable of batch
    dicts); returns the final state.

    ``cfg`` sections read: optimizer (max_iterations / max_epochs,
    accumulation_steps, weight_ema_decay), metrics (running_average_alpha),
    scheduler (on_iteration / on_validation, else per epoch), logging
    (log_period, summary_period, checkpoint_period, checkpoint_n_saved,
    validation_period), data (sequential).  With ``val_loader`` it validates
    every ``validation_period`` iterations and once after the final
    checkpoint.  With ``output_dir`` it writes periodic checkpoints there, a
    final, interrupt or exception checkpoint when the loop ends, and the
    summaries (``scalars.jsonl``): ``train/<metric>``, ``params/lr`` and the
    loss module's parameters every ``summary_period`` iterations;
    ``val/<metric>`` (batch means), ``val/step_t_err`` / ``val/step_r_err``
    and, with ``data.sequential``, ``val/kitti_t_err`` / ``val/kitti_r_err``
    and the Evaluator's figures (when matplotlib imports) at every
    validation.  ``checkpoint`` resumes from a full checkpoint.  A
    non-finite loss at a log period raises ValueError (after an exception
    checkpoint).

    Under a process group (of any size) the loop is the data-parallel one:
    each process passes its own loader shards, of equal lengths and full
    batches; the model trains under DistributedDataParallel, its batch
    norms and dropout set to the group (``set_process_group``) until the
    loop ends, and its
    checkpoints hold the model's own state dict (no ``module.`` prefix),
    so they serve and resume with or without a group.  Validation averages
    the metric means over the processes and gathers the predictions,
    labels, names and stamps to rank 0 for the Evaluator, in the dataset's
    order.  Only rank 0 (``is_primary``) writes checkpoints and summaries.
    With more than one rank, every iteration ends with a one-element MAX
    all-reduce of "an interrupt is pending", so SIGINT to any rank stops
    every rank after the same iteration; they average their gradients and
    rank 0 writes the interrupt checkpoint, which holds the global batch's
    partial gradient, as the JAX package's global accumulator does.
    """
    opt_cfg, log_cfg = cfg["optimizer"], cfg.get("logging") or {}
    sched_cfg = cfg.get("scheduler") or {}
    log_period = int(log_cfg.get("log_period", 1000))
    summary_period = int(log_cfg.get("summary_period", 5))
    checkpoint_period = int(log_cfg.get("checkpoint_period", 1000))
    validation_period = int(log_cfg.get("validation_period", 5000))
    sequential = bool((cfg.get("data") or {}).get("sequential", False))
    batch_size = int((cfg.get("data_loader") or {}).get("batch_size", 1))
    weight_ema_decay = float(opt_cfg.get("weight_ema_decay") or 0.0)
    label_type = model.label_type

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

    accumulation_steps = int(opt_cfg.get("accumulation_steps", 1))
    eval_step = make_eval_step(model, {**metric_fns, "loss_fn": loss_fn})
    state = create_train_state(model, weight_ema=weight_ema_decay > 0.0)

    start_epoch = iteration = 0
    if checkpoint is not None:
        restored = load_checkpoint(checkpoint, map_location=next(model.parameters()).device)
        state.load_state_dict(restored["state"], model, optimizer)
        start_epoch, iteration = int(restored["epoch"]), int(restored["iteration"])
        logger.info(f"Restored checkpoint at epoch {start_epoch}, iteration {iteration}")

    world = process_count()
    net = wrap_data_parallel(model) if initialized() else model
    train_step = make_train_step(
        net, optimizer, loss_fn, metric_fns,
        accumulation_steps=accumulation_steps,
        ema_alpha=float((cfg.get("metrics") or {}).get("running_average_alpha", 0.5)),
        use_model_loss=getattr(model, "loss_module", None) is not None,
        weight_ema_decay=weight_ema_decay)

    checkpointer = writer = None
    if output_dir and is_primary():
        checkpointer = Checkpointer(output_dir, n_saved=int(log_cfg.get("checkpoint_n_saved", 10)))
        writer = create_summary_writer(output_dir)

    validation_count = 0
    figures_skipped = False

    def scheduler_count() -> int:
        if sched_cfg.get("on_iteration"):
            return iteration
        if sched_cfg.get("on_validation"):
            return validation_count
        return epoch

    def run_validation() -> None:
        nonlocal validation_count, figures_skipped
        if val_loader is None:
            return
        export = Evaluator()
        sums: Dict[str, float] = {}
        count = 0
        for vbatch in val_loader:
            y_pred, metrics = eval_step(vbatch)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
            y_gt = np.asarray(vbatch["y"], dtype=np.float32)
            n = y_gt.shape[0]
            names = list(vbatch.get("d", ["val"] * n))
            stamps = np.asarray([np.ravel(s)[-1] for s in vbatch.get("t", np.zeros(n))], dtype=np.float64)
            y_host = y_pred.float().cpu().numpy()
            if world > 1:
                # rank r's row j is sample (j·W + r) of the global batch (the
                # loader deals sample i to rank i mod W): back to that order
                order = np.arange(world * n).reshape(world, n).T.ravel()
                y_host, y_gt = allgather_host(y_host)[order], allgather_host(y_gt)[order]
                stamps = allgather_host_f64(stamps)[order]
                gathered = allgather_host_strings(names)
                names = [gathered[i] for i in order]
                if not is_primary():
                    continue
            m_pred = label_type.to_matrix(torch.from_numpy(y_host)).numpy()
            m_gt = label_type.to_matrix(torch.from_numpy(y_gt)).numpy()
            for i in range(len(names)):
                export.add_transforms(str(names[i]), float(stamps[i]), m_pred[i], m_gt[i])
        if count == 0:
            return
        means = {k: v / count for k, v in sums.items()}
        if world > 1:
            means = dict(zip(means, mean_over_processes(
                torch.tensor(list(means.values()), dtype=torch.float64)).tolist()))
        logger.info(f"Validation Results - Epoch[{epoch}] Iteration[{iteration}] "
                    f"Avg Loss: {means.get('loss_fn', float('nan')):.6f}")
        validation_count += 1
        if writer is None:
            return
        for k, v in means.items():
            writer.add_scalar(f"val/{k}", v, iteration)
        total_step = export.get_total_step_errors()
        writer.add_scalar("val/step_t_err", total_step.mean.translation.kitti, iteration)
        writer.add_scalar("val/step_r_err", total_step.mean.rotation.kitti, iteration)
        if sequential:
            if _have_matplotlib():
                for name, fig in export.plot_sequences().items():
                    writer.add_figure(f"val/{name}", fig, iteration)
                writer.add_figure("val/kitti_errors", export.plot_total_kitti_errors(), iteration)
                writer.add_figure("val/segment_errors", export.plot_segment_error_bars(), iteration)
            elif not figures_skipped:
                logger.info("matplotlib does not import: the validation figures are skipped")
                figures_skipped = True
            total_seg = export.get_total_segment_errors()
            writer.add_scalar("val/kitti_t_err", total_seg.mean.translation.kitti, iteration)
            writer.add_scalar("val/kitti_r_err", total_seg.mean.rotation.kitti, iteration)

    def save_ckpt(special: Optional[str] = None) -> None:
        if world > 1 and special in (None, "final", "interrupt") and state.step % accumulation_steps:
            # mid-update, each rank holds the gradient of its own shard:
            # store their mean, which every rank takes over (the update
            # that averages them over the ranks stays the same)
            _average_gradients(model)
        if checkpointer is None:
            return
        payload = state.state_dict(model, optimizer)
        if special is not None:
            checkpointer.save_special_checkpoint(special, epoch, iteration, payload, payload["model"],
                                                 state.param_ema)
        else:
            checkpointer.save_checkpoint(epoch, iteration, payload, payload["model"], state.param_ema)

    logger.info(f"Start training for {epochs} epochs ({max_iterations} iterations, {world} processes)")
    epoch = start_epoch
    _shutdown.clear()
    global _interrupt_pending, _group_agrees
    _interrupt_pending = False
    _group_agrees = world > 1
    device = local_device()
    prev_sigint = install_sigint_handler()
    try:
        done = False
        for epoch in range(start_epoch, epochs):
            t_epoch = time.monotonic()
            waited = _loader_wait()
            n_batches = 0
            metrics = None
            for batch in train_loader:
                # the step and all of its bookkeeping are one deferred unit, so a
                # SIGINT lands between two whole iterations: the interrupt
                # checkpoint's iteration then counts every step its state holds
                with _defer_interrupt():
                    lr = schedule(scheduler_count())
                    metrics = train_step(state, batch, lr)
                    iteration += 1
                    n_batches += 1
                    if iteration % log_period == 0:
                        loss_val = float(metrics["loss"])
                        if not math.isfinite(loss_val):
                            raise ValueError(f"Invalid loss: {loss_val}")
                        logger.info(f"Epoch[{epoch + 1}] Iteration[{(iteration - 1) % loader_len + 1}/"
                                    f"{loader_len}] Loss: {loss_val:.6f}")
                    if writer is not None and iteration % summary_period == 0:
                        for k, v in metrics.items():
                            writer.add_scalar(f"train/{k}", float(v), iteration)
                        writer.add_scalar("params/lr", lr, iteration)
                        if model.loss_module is not None:
                            for k, v in model.loss_module.named_parameters():
                                writer.add_scalar(f"params/{k.lstrip('_')}", v.detach().reshape(-1)[0].item(),
                                                  iteration)
                    if iteration % checkpoint_period == 0:
                        save_ckpt()
                    if iteration % validation_period == 0:
                        run_validation()
                    if _group_agrees and _interrupt_agreed(device):
                        raise KeyboardInterrupt
                    if iteration >= max_iterations:
                        done = True
                        break
            if n_batches and metrics is not None:
                tpb = (time.monotonic() - t_epoch) / n_batches
                waits, wait_s = (a - b for a, b in zip(_loader_wait(), waited))
                wait = f" Loader wait: {wait_s * 1e3 / waits:.3f}[ms/batch]" if waits else ""
                logger.info(f"Epoch {epoch + 1} done. Avg Loss: {float(metrics['loss']):.6f} "
                            f"Time per batch: {tpb:.3f}[s] Speed: {batch_size / tpb:.1f}[samples/s]{wait}")
            if done:
                break

        _shutdown.set()  # loop done: a late SIGINT must not kill the flush
        logger.info("Training completed")
        save_ckpt("final")
        run_validation()
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
        _group_agrees = False
        if net is not model:
            set_process_group(model, None)
        if writer is not None:
            writer.flush()
            writer.close()
        # restore only a foreign previous handler: restoring the default one
        # would reopen the late-SIGINT window for a caller that installed ours
        if prev_sigint is not None and prev_sigint is not _sigint_handler:
            signal.signal(signal.SIGINT, prev_sigint)
    return state
