"""Checkpoints in the reference's own .pth format, with the full training
state, and the backbone initialisation (counterpart of
rmnet_tpu/utils/checkpoint.py).

A checkpoint is ``torch.save`` of ``{"epoch_index", "best_metrics",
"rmnet", "tflownet"}``, the last two state dicts with the reference's key
names (reference core/train.py:212-231), so the reference, the JAX
package's ``load_weights_auto`` and this module all read it. ``train_net``
adds ``"optimizer"``, the Adam ``state_dict()`` (per-parameter ``step`` and
moments), which the others ignore; with it a resumed run continues the
schedule where the reference restarts it (core/train.py:85-98). Everything
in the file is a tensor, a number, None, a list or a dict, so it loads with
``weights_only=True``. The JAX package's orbax checkpoint directories
cannot be read without orbax and JAX: ``load_weights_auto`` raises on one.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from rmnet_tpu_torch.models.weights import strip_module_prefix, torchvision_trunk_key_map


def _plain(obj):
    """Tensors to the CPU and tuples to lists, recursively: what
    ``torch.load(weights_only=True)`` reads back."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def save_checkpoint(directory: str, name: str, rmnet_state: Mapping[str, torch.Tensor],
                    tflownet_state: Mapping[str, torch.Tensor], epoch_index: Optional[int] = None,
                    best_metrics: Optional[Mapping[str, float]] = None,
                    optimizer: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``directory/name`` (``.pth`` appended when missing) atomically;
    returns its path. ``best_metrics`` is a ``Metrics.state_dict()``,
    ``optimizer`` an optimizer's ``state_dict()``."""
    if not name.endswith((".pth", ".pt")):
        name += ".pth"
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    ckpt = {
        "epoch_index": epoch_index,
        "best_metrics": None if best_metrics is None else dict(best_metrics),
        "rmnet": _plain(rmnet_state),
        "tflownet": _plain(tflownet_state),
    }
    if optimizer is not None:
        ckpt["optimizer"] = _plain(optimizer)
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
    {"epoch", "best_metrics", "optimizer"}), DataParallel ``module.``
    prefixes stripped; "optimizer" is None in a file without it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX package: the port "
            f"reads only reference-format .pth files ({{rmnet, tflownet, epoch_index, "
            f"best_metrics}}); export that checkpoint to a .pth first")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(ckpt["rmnet"]), strip_module_prefix(ckpt["tflownet"]), {
        "epoch": ckpt.get("epoch_index"),
        "best_metrics": ckpt.get("best_metrics"),
        "optimizer": ckpt.get("optimizer"),
    }


def _torchvision_resnet50() -> Dict[str, torch.Tensor]:
    try:
        import torchvision
    except ImportError as ex:
        raise RuntimeError(
            "TRAIN.BACKBONE_WEIGHTS = 'torchvision' needs the torchvision package, which "
            "is not installed; pass the path of a resnet50 state dict (.pth) instead") from ex
    # the local weight cache only: nothing is downloaded here
    return torchvision.models.resnet50(
        weights=torchvision.models.ResNet50_Weights.IMAGENET1K_V1).state_dict()


def load_backbone_weights(source: str, rmnet: torch.nn.Module) -> int:
    """Initialise both encoders' ResNet-50 trunks of ``rmnet`` (conv1, bn1,
    res2..4: weights and running statistics) from an ImageNet resnet50 in
    torchvision's format, in place; the heads and mask stems keep their
    init, as in the reference (models/rmnet.py:57,86; core/train.py:50-53).

    ``source`` is the path of a state dict (raw, or a dict holding it under
    ``state_dict`` or ``model``), or ``"torchvision"`` for torchvision's
    local weight cache. Returns the count of tensors imported; raises when
    none was."""
    if source == "torchvision":
        sd = _torchvision_resnet50()
    else:
        sd = torch.load(source, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            if isinstance(sd, Mapping) and isinstance(sd.get(key), Mapping):
                sd = sd[key]
    sd = strip_module_prefix(sd)
    own = rmnet.state_dict()
    n = 0
    with torch.no_grad():
        for key, tv_key in torchvision_trunk_key_map(own).items():
            if tv_key not in sd:
                continue
            if tuple(sd[tv_key].shape) != tuple(own[key].shape):
                raise ValueError(f"shape mismatch for {tv_key}: {tuple(sd[tv_key].shape)} "
                                 f"against {key} {tuple(own[key].shape)}")
            own[key].copy_(sd[tv_key])
            n += 1
    if n == 0:
        raise ValueError(f"no trunk weights imported from {source}")
    return n
