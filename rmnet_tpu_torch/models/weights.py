"""Weights for the port: random init, JAX-package parameters, reference .pth.

The port's modules keep the reference's state-dict names (res2/res3/res4
encoder layers, Sequential-wrapped TinyFlowNet convs ``convX.0.*``), so a
reference checkpoint (``{tflownet, rmnet}`` with ``module.`` prefixes) loads
with ``load_state_dict`` once the prefixes are stripped.

:func:`from_jax_variables` converts the JAX package's parameter trees
(numpy, ``{"params", "batch_stats"}``) into those state dicts; it inverts
rmnet_tpu/models/torch_import.py (``_flax_path_to_torch_key`` /
``_convert_weight``):

  * the flax ``trunk`` wrapper is flattened, ``layerN_i`` -> ``res{2,3,4}.i``;
  * ``downsample_conv`` -> ``downsample`` in ResBlock, ``downsample.0`` in a
    Bottleneck; ``downsample_bn`` -> ``downsample.1``;
  * conv kernels HWIO -> OIHW; transposed convs are stored pre-flipped, so
    ``w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]``;
  * BN ``running_mean/var`` come from ``batch_stats``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from rmnet_tpu_torch.models.rmnet import RMNet
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet

_CONV_TRANSPOSE_NAMES = {
    "deconv4", "deconv3", "deconv2",
    "upsampled_flow5_to_4", "upsampled_flow4_to_3", "upsampled_flow3_to_2",
}
# TinyFlowNet modules wrapped as Sequential(conv, LeakyReLU) in the reference
_TFN_SEQUENTIAL = {
    "conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1", "conv5", "conv5_1",
    "deconv4", "deconv3", "deconv2",
}
_TRUNK_RENAME = {"layer1": "res2", "layer2": "res3", "layer3": "res4"}


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel ``module.`` prefixes."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _torch_key(path: Tuple[str, ...], tinyflownet: bool) -> str:
    in_trunk = "trunk" in path
    parts = []
    for p in path:
        if p == "trunk":
            continue
        if p == "downsample_conv":
            parts.append("downsample.0" if in_trunk else "downsample")
        elif p == "downsample_bn":
            parts.append("downsample.1")
        elif "_" in p and p.split("_")[0] in _TRUNK_RENAME:
            layer, idx = p.rsplit("_", 1)
            parts.append(f"{_TRUNK_RENAME[layer]}.{idx}")
        else:
            parts.append(p)
    if tinyflownet and parts[0] in _TFN_SEQUENTIAL:
        parts.insert(1, "0")
    return ".".join(parts)


def _leaves(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _convert(variables, tinyflownet: bool) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            arr = np.asarray(arr)
            if path[-1] == "weight" and arr.ndim == 4:
                if path[-2] in _CONV_TRANSPOSE_NAMES:
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            key = _torch_key(path, tinyflownet)
            sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
            if path[-1] == "running_mean":
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def from_jax_variables(rm_vars, tfn_vars) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX-package variables (numpy trees) -> (RMNet, TinyFlowNet) state dicts."""
    return _convert(rm_vars, False), _convert(tfn_vars, True)


# the encoders' ResNet-50 trunk: the port's names -> torchvision's
_TORCHVISION_TRUNK = {"conv1": "conv1", "bn1": "bn1", "res2": "layer1", "res3": "layer2",
                      "res4": "layer3"}


def torchvision_trunk_key_map(rmnet_keys) -> Dict[str, str]:
    """{RMNet state-dict key: torchvision resnet50 key} for both encoders'
    trunks: torchvision's conv1, bn1, layer1..3 load into conv1, bn1,
    res2..4 (rmnet_tpu/models/torch_import.py:133-152). The mask stems
    (``conv1_m``, ``conv1_o``), the heads and BatchNorm's
    ``num_batches_tracked`` are not mapped."""
    out = {}
    for key in rmnet_keys:
        enc, _, rest = key.partition(".")
        head, _, tail = rest.partition(".")
        if (enc in ("encoder_memory", "encoder_query") and head in _TORCHVISION_TRUNK
                and not key.endswith("num_batches_tracked")):
            out[key] = f"{_TORCHVISION_TRUNK[head]}.{tail}"
    return out


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference .pth ({tflownet, rmnet, ...}) -> (RMNet, TinyFlowNet) state
    dicts with the ``module.`` prefixes stripped."""
    from rmnet_tpu_torch.utils.checkpoint import load_weights_auto

    return load_weights_auto(path)[:2]


def _init_conv(conv: nn.Module, g: torch.Generator, kaiming: bool) -> None:
    w = conv.weight
    kh, kw = w.shape[-2:]
    cin = w.shape[0] if isinstance(conv, nn.ConvTranspose2d) else w.shape[1]
    fan_in = cin * kh * kw
    with torch.no_grad():
        if kaiming:  # kaiming_normal_, fan_in, gain sqrt(2)
            w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)
        else:  # torch's default conv init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=g)
        if conv.bias is not None:
            conv.bias.zero_()


def build_models(cfg=None, seed: int = 0, device=None,
                 dtype=None) -> Tuple[RMNet, TinyFlowNet]:
    """Randomly initialised (RMNet, TinyFlowNet) in eval mode on ``device``
    (default cuda), drawn from ``torch.Generator().manual_seed(seed)``, with
    float32 parameters and ``dtype`` as the convs' compute dtype (None:
    float32), as rmnet_tpu/core/engine.py:739 builds them.

    The reference scheme (core/train.py:48-53): kaiming-normal heads and
    TinyFlowNet, torch-default ResNet trunks and mask stems, zero biases,
    identity BatchNorm.
    """
    del cfg  # the init scheme has no configuration
    device = torch.device("cuda" if device is None else device)
    g = torch.Generator().manual_seed(seed)
    rmnet, tfn = RMNet(dtype), TinyFlowNet(dtype)
    for net in (rmnet, tfn):
        for name, mod in net.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                trunk = name.startswith(("encoder_memory.", "encoder_query."))
                _init_conv(mod, g, kaiming=not trunk)
    return rmnet.to(device).eval(), tfn.to(device).eval()
