"""The test path's video transforms (counterpart of
rmnet_tpu/data/transforms.py:138-230): Compose, ReorganizeObjectID, ToOneHot,
Normalize and ToArrays, numpy on the host. The training transforms (Resize,
RandomAffine, RandomCrop, ColorJitter, RandomFlip, RandomPermuteRGB,
HistogramEqualization) come with ``train_net`` (ROADMAP queue 1 item 2).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from rmnet_tpu_torch.data.rng import nprand


class Compose:
    """Dict-driven transform pipeline (reference utils/data_transforms.py:23-38)."""

    REGISTRY = {}

    def __init__(self, transforms: Sequence[dict]):
        self.transformers = []
        for tr in transforms:
            cls = self.REGISTRY[tr["callback"]]
            self.transformers.append(cls(tr.get("parameters")))

    def __call__(self, frames, masks, optical_flows):
        for tr in self.transformers:
            frames, masks, optical_flows = tr(frames, masks, optical_flows)
        return frames, masks, optical_flows


def register(cls):
    Compose.REGISTRY[cls.__name__] = cls
    return cls


@register
class ToArrays:
    """Stack per-frame lists into contiguous NHWC arrays: frames (T, H, W, 3)
    float32, masks (T, K, H, W) uint8, flows (T, H, W, 2) float32."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, frames, masks, optical_flows):
        frames = np.ascontiguousarray(np.stack(frames), np.float32)
        masks = np.ascontiguousarray(np.stack(masks))
        optical_flows = np.ascontiguousarray(np.stack(optical_flows), np.float32)
        return frames, masks, optical_flows


# the reference pipeline's name
Compose.REGISTRY["ToTensor"] = ToArrays


@register
class ReorganizeObjectID:
    """Densify mask ids to 0..n (reference utils/data_transforms.py:53-68)."""

    def __init__(self, parameters):
        self.ignore_idx = parameters["ignore_idx"]

    def __call__(self, frames, masks, optical_flows):
        mask_indexes = np.unique(np.array(masks))
        mask_indexes = mask_indexes[mask_indexes != self.ignore_idx]
        for m_idx, m in enumerate(masks):
            _m = np.zeros(m.shape, np.uint8)
            for idx, mi in enumerate(mask_indexes):
                _m[m == mi] = idx
            masks[m_idx] = _m
        return frames, masks, optical_flows


@register
class ToOneHot:
    """Label map -> n_objects + 1 binary channels, optionally with the object
    ids shuffled (reference utils/data_transforms.py:71-83)."""

    def __init__(self, parameters):
        self.shuffle = parameters["shuffle"]
        self.n_objects = parameters["n_objects"]

    def __call__(self, frames, masks, optical_flows):
        perm = nprand().permutation(self.n_objects) + 1
        perm = np.insert(perm, 0, 0)
        out = []
        for m in masks:
            oh = np.stack([(m == k) for k in range(self.n_objects + 1)]).astype(np.uint8)
            out.append(oh[perm] if self.shuffle else oh)
        return frames, out, optical_flows


@register
class Normalize:
    def __init__(self, parameters):
        self.mean = np.asarray(parameters["mean"], np.float32)
        self.std = np.asarray(parameters["std"], np.float32)

    def __call__(self, frames, masks, optical_flows):
        for idx, (f, m) in enumerate(zip(frames, masks)):
            frames[idx] = ((np.asarray(f, np.float32) / 255.0 - self.mean) / self.std).astype(
                np.float32
            )
            masks[idx] = np.asarray(m, np.uint8)
        return frames, masks, optical_flows
