"""Segmentation visualisation (counterpart of rmnet_tpu/utils/seg_viz.py):
palette PNGs and contour overlays (reference utils/helpers.py:138-178)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.ndimage
from PIL import Image

# 16-colour VOC-style palette of the overlays and the palette PNGs
PALETTE = np.array([[i, i, i] for i in range(256)])
PALETTE[:16] = np.array(
    [
        [0, 0, 0],
        [128, 0, 0],
        [0, 128, 0],
        [128, 128, 0],
        [0, 0, 128],
        [128, 0, 128],
        [0, 128, 128],
        [128, 128, 128],
        [64, 0, 0],
        [191, 0, 0],
        [64, 128, 0],
        [191, 128, 0],
        [64, 0, 128],
        [191, 0, 128],
        [64, 128, 128],
        [191, 128, 128],
    ]
)


def img_denormalize(image_hwc: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) normalized float -> uint8 RGB."""
    return ((image_hwc * np.asarray(std) + np.asarray(mean)) * 255).astype(np.uint8)


def get_segmentation(
    frame_hwc: Optional[np.ndarray],
    mask: np.ndarray,
    normalization_params=None,
    ignore_idx: int = 255,
    alpha: float = 0.4,
) -> Image.Image:
    """Render a label map.

    With ``frame_hwc=None``, a palette PNG of the mask (the DAVIS and
    YouTube-VOS submission format); otherwise each object's colour blended
    onto the denormalized frame, with its dilated contour in black.
    """
    mask = np.asarray(mask)
    if frame_hwc is None:
        img = Image.fromarray(mask.astype(np.uint8), mode="P")
        img.putpalette(PALETTE.reshape(-1).tolist())
        return img

    frame = img_denormalize(
        np.asarray(frame_hwc)[..., :3],
        normalization_params["mean"],
        normalization_params["std"],
    ).copy()
    for o_id in np.unique(mask)[1:]:
        if o_id == ignore_idx:
            continue
        fg = frame * alpha + np.ones(frame.shape) * (1 - alpha) * np.array(PALETTE[o_id])
        binary = mask == o_id
        frame[binary] = fg[binary]
        contours = scipy.ndimage.binary_dilation(binary) ^ binary
        frame[contours, :] = 0
    return Image.fromarray(frame)
