"""Checkpointing with the reference's artifact contract, in torch files.

  * full checkpoints ``ckpt_{it}.pt`` = {epoch, iteration, state}, where
    state holds the model, optimizer and train-state dicts;
  * weights-only ``weights_{it}.pt``: the model state dict, loadable with
    ``DeepCLR.load_state_dict`` (and ``weights_ema_{it}.pt`` when the
    trainer keeps a Polyak average);
  * ``ckpt.pt`` / ``weights.pt`` symlinks to the latest;
  * a ring of ``n_saved`` regular checkpoints;
  * special checkpoints (final / interrupt / exception) kept outside the ring.

Every file is written to a temporary name and moved into place, so a kill
mid-write leaves the previous checkpoint intact.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Checkpointer", "load_checkpoint"]


def _atomic_save(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _relink(link: str, target: str) -> None:
    if osp.islink(link) or osp.exists(link):
        os.remove(link)
    os.symlink(osp.basename(target), link)


class Checkpointer:
    """Writes full + weights-only checkpoints with latest-symlinks."""

    def __init__(self, output_dir: str, n_saved: int = 10):
        self._dir = output_dir
        self._n_saved = n_saved
        self._saved: List[str] = []
        os.makedirs(output_dir, exist_ok=True)

    def _write(self, tag: str, epoch: int, iteration: int, state: Dict[str, Any],
               weights: Dict[str, torch.Tensor], ema_weights: Optional[Dict[str, torch.Tensor]]) -> str:
        ckpt_path = osp.join(self._dir, f"ckpt_{tag}.pt")
        weights_path = osp.join(self._dir, f"weights_{tag}.pt")
        _atomic_save(ckpt_path, {"epoch": epoch, "iteration": iteration, "state": state})
        _atomic_save(weights_path, weights)
        _relink(osp.join(self._dir, "ckpt.pt"), ckpt_path)
        _relink(osp.join(self._dir, "weights.pt"), weights_path)
        if ema_weights is not None:
            ema_path = osp.join(self._dir, f"weights_ema_{tag}.pt")
            _atomic_save(ema_path, ema_weights)
            _relink(osp.join(self._dir, "weights_ema.pt"), ema_path)
        return ckpt_path

    def save_checkpoint(self, epoch: int, iteration: int, state, weights, ema_weights=None) -> str:
        """Regular checkpoint; prunes the ring beyond n_saved."""
        path = self._write(str(iteration), epoch, iteration, state, weights, ema_weights)
        self._saved.append(str(iteration))
        while len(self._saved) > self._n_saved:
            tag = self._saved.pop(0)
            for prefix in ("ckpt", "weights", "weights_ema"):
                old = osp.join(self._dir, f"{prefix}_{tag}.pt")
                if osp.exists(old):
                    os.remove(old)
        return path

    def save_special_checkpoint(self, name: str, epoch: int, iteration: int, state, weights,
                                ema_weights=None) -> str:
        """final / interrupt / exception checkpoints, never pruned."""
        return self._write(f"{name}_{iteration}", epoch, iteration, state, weights, ema_weights)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """{'epoch', 'iteration', 'state'} of a full checkpoint."""
    return torch.load(path, map_location=map_location, weights_only=True)
