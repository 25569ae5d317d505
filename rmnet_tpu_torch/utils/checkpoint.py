"""Checkpoints in the reference's own .pth format (counterpart of
rmnet_tpu/utils/checkpoint.py:37-78).

A checkpoint is ``torch.save`` of ``{"epoch_index", "best_metrics",
"rmnet", "tflownet"}``, the last two state dicts with the reference's key
names (reference core/train.py:212-231), so the reference, the JAX
package's ``load_weights_auto`` and this module all read it. The JAX
package's orbax checkpoint directories cannot be read without orbax and
JAX: ``load_weights_auto`` raises on one.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from rmnet_tpu_torch.models.weights import strip_module_prefix


def save_checkpoint(directory: str, name: str, rmnet_state: Mapping[str, torch.Tensor],
                    tflownet_state: Mapping[str, torch.Tensor], epoch_index: Optional[int] = None,
                    best_metrics: Optional[Mapping[str, float]] = None) -> str:
    """Write ``directory/name`` (``.pth`` appended when missing) atomically;
    returns its path. ``best_metrics`` is a ``Metrics.state_dict()``."""
    if not name.endswith((".pth", ".pt")):
        name += ".pth"
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    ckpt = {
        "epoch_index": epoch_index,
        "best_metrics": None if best_metrics is None else dict(best_metrics),
        "rmnet": {k: v.detach().cpu() for k, v in rmnet_state.items()},
        "tflownet": {k: v.detach().cpu() for k, v in tflownet_state.items()},
    }
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str, pattern: str = r"ckpt-epoch-(\d+)") -> Optional[str]:
    """Path of the highest-epoch checkpoint in a directory, or None."""
    best, best_epoch = None, -1
    if not os.path.isdir(directory):
        return None
    for entry in os.listdir(directory):
        m = re.match(pattern, entry)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(directory, entry)
    return best


def load_weights_auto(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                                          Dict[str, Any]]:
    """A reference-format .pth -> (RMNet state dict, TinyFlowNet state dict,
    {"epoch", "best_metrics"}), DataParallel ``module.`` prefixes stripped."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX package: the port "
            f"reads only reference-format .pth files ({{rmnet, tflownet, epoch_index, "
            f"best_metrics}}); export that checkpoint to a .pth first")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(ckpt["rmnet"]), strip_module_prefix(ckpt["tflownet"]), {
        "epoch": ckpt.get("epoch_index"),
        "best_metrics": ckpt.get("best_metrics"),
    }
