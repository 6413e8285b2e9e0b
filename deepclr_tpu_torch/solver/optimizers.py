"""Optimizers: Ranger and a torch-style Adam, as ``torch.optim.Optimizer``s.

Both follow the JAX package's optax chains operation for operation, in
float32, so N steps on the same gradients give the same parameters:

* ``Ranger``: gradient centralization -> RAdam -> decoupled weight decay on
  tensors of rank >= 2 -> x(-lr) -> Lookahead (sync every 6 updates, slow
  step 0.5);
* ``Adam``: L2 weight decay on tensors of rank >= 2 folded into the
  gradient -> Adam -> x(-lr).

The RAdam step is optax's: eps added to sqrt of the bias-corrected second
moment, and the rectified update once rho >= threshold.  (torch.optim.RAdam
adds eps before the bias correction and switches on rho > 5.)  Weights here
are (out, in), so gradient centralization takes the mean over every axis but
the first.  A parameter without a gradient steps with a zero one, as every
leaf does in the JAX chain.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Ranger", "Adam"]


def _bias_term(decay: float, count: int) -> float:
    """1 - decay**count in float32, the power taken on the float32 decay."""
    return float(np.float32(1.0) - np.float32(float(np.float32(decay)) ** count))


def _moments(state, grad, b1: float, b2: float) -> None:
    """First and second moment updates, (1 - b) * g + b * m."""
    state["mu"] = (1.0 - b1) * grad + b1 * state["mu"]
    state["nu"] = (1.0 - b2) * (grad * grad) + b2 * state["nu"]


class Ranger(torch.optim.Optimizer):
    """GC -> RAdam -> decoupled weight decay (rank >= 2) -> lr -> Lookahead."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, b1: float = 0.95,
                 b2: float = 0.999, eps: float = 1e-5, sync_period: int = 6,
                 slow_step_size: float = 0.5, threshold: float = 5.0, use_gc: bool = True):
        defaults = dict(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                        sync_period=sync_period, slow_step_size=slow_step_size,
                        threshold=threshold, use_gc=use_gc)
        super().__init__(params, defaults)

    @staticmethod
    def _rectifier(b2: float, count: int, threshold: float):
        """optax's rectification factor r_t in float32, or None while rho_t
        is below the threshold (then the update is the momentum alone)."""
        f = np.float32
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f(float(f(b2)) ** count)
        ro = f(ro_inf) - f(f(f(2 * count) * b2t) / f(f(1.0) - b2t))
        if not ro >= threshold:
            return None
        r = np.sqrt(f(f(f(f(ro - f(4.0)) * f(ro - f(2.0))) * f(ro_inf))
                      / f(f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return float(f(r))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            step_size = -float(np.float32(group["lr"]))
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                                 slow=p.detach().clone(), la_count=0)
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if group["use_gc"] and g.dim() >= 2:
                    g = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                _moments(state, g, b1, b2)
                state["count"] += 1
                count = state["count"]
                mu_hat = state["mu"] / _bias_term(b1, count)
                nu_hat = state["nu"] / _bias_term(b2, count)
                r = self._rectifier(b2, count, group["threshold"])
                u = mu_hat if r is None else r * mu_hat / (torch.sqrt(nu_hat) + eps)
                if wd and p.dim() >= 2:
                    u = u + wd * p
                u = step_size * u
                # Lookahead: the live weights jump to the interpolated slow
                # weights every sync_period updates
                fast = p + u
                state["la_count"] += 1
                if state["la_count"] % group["sync_period"] == 0:
                    slow = state["slow"]
                    target = slow + group["slow_step_size"] * (fast - slow)
                    state["slow"] = target
                else:
                    target = fast
                p.add_(target - p)
        return loss


class Adam(torch.optim.Optimizer):
    """torch-style Adam: L2 weight decay (rank >= 2) folded into the gradient."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            step_size = -float(np.float32(group["lr"]))
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if wd and p.dim() >= 2:
                    g = g + wd * p
                _moments(state, g, b1, b2)
                state["count"] += 1
                mu_hat = state["mu"] / _bias_term(b1, state["count"])
                nu_hat = state["nu"] / _bias_term(b2, state["count"])
                p.add_(step_size * (mu_hat / (torch.sqrt(nu_hat) + eps)))
        return loss
