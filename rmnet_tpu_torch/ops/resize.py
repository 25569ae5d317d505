"""Bilinear / nearest resize (counterpart of rmnet_tpu/ops/resize.py).

The JAX package reimplements torch ``F.interpolate`` semantics; here they are
``F.interpolate`` itself: bilinear with half-pixel centers
(align_corners=False, no antialiasing) and 'nearest' with
``src = floor(dst * in / out)``. Bilinear resizes compute in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def scale_hw(h: int, w: int, scale: float) -> Tuple[int, int]:
    """Output size of ``F.interpolate(scale_factor=scale)``: floor(in*scale)."""
    return int(h * scale), int(w * scale)


def _resize(x, out_hw, spatial_axes, **kw):
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    y = x.movedim((h_ax, w_ax), (-2, -1))
    lead = y.shape[:-2]
    y = y.reshape((1, -1) + y.shape[-2:])
    y = F.interpolate(y, size=tuple(out_hw), **kw)
    return y.reshape(lead + y.shape[-2:]).movedim((-2, -1), (h_ax, w_ax))


def resize_bilinear(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    spatial_axes: Tuple[int, int] = (-3, -2),
    align_corners: bool = False,
) -> torch.Tensor:
    """Bilinear resize; ``spatial_axes`` (-3, -2) fits channels-last."""
    y = _resize(x.float(), out_hw, spatial_axes, mode="bilinear",
                align_corners=align_corners)
    return y.to(x.dtype)


def resize_nearest(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    spatial_axes: Tuple[int, int] = (-3, -2),
) -> torch.Tensor:
    """Nearest resize matching torch ``F.interpolate(mode='nearest')``."""
    return _resize(x, out_hw, spatial_axes, mode="nearest")
