"""Symmetric pad-to-multiple (counterpart of rmnet_tpu/ops/pad.py).

Pads H and W up to the next multiple of ``d`` with zeros, floor(pad/2) on
the low side and the rest on the high side, and returns the pad tuple in
the reference's ``(lw, uw, lh, uh)`` order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def divide_pads(h: int, w: int, d: int) -> Tuple[int, int, int, int]:
    """The (lw, uw, lh, uh) zero-padding that makes (h, w) divisible by d."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh = (new_h - h) // 2
    uh = (new_h - h) - lh
    lw = (new_w - w) // 2
    uw = (new_w - w) - lw
    return (lw, uw, lh, uh)


def _pad_axes(x: torch.Tensor, h_ax: int, w_ax: int, pads) -> torch.Tensor:
    lw, uw, lh, uh = pads
    spec = [0] * (2 * (x.ndim - min(h_ax, w_ax)))
    for ax, lo, hi in ((h_ax, lh, uh), (w_ax, lw, uw)):
        k = 2 * (x.ndim - 1 - ax)
        spec[k], spec[k + 1] = lo, hi
    return F.pad(x, spec)


def pad_divide_by(
    tensors: Sequence[torch.Tensor],
    d: int,
    spatial_axes: Tuple[int, int] = (-3, -2),
):
    """Zero-pad each tensor's spatial axes up to a multiple of ``d``.

    ``spatial_axes`` defaults to (-3, -2) for channels-last tensors; pass
    (-2, -1) for (..., H, W). Returns (padded, (lw, uw, lh, uh)).
    """
    first = tensors[0]
    h_ax = spatial_axes[0] % first.ndim
    w_ax = spatial_axes[1] % first.ndim
    pads = divide_pads(first.shape[h_ax], first.shape[w_ax], d)
    out = []
    for t in tensors:
        shift = t.ndim - first.ndim
        out.append(_pad_axes(t, h_ax + shift, w_ax + shift, pads))
    return out, pads


def unpad(
    x: torch.Tensor,
    pads: Tuple[int, int, int, int],
    spatial_axes: Tuple[int, int] = (-3, -2),
) -> torch.Tensor:
    """Inverse of :func:`pad_divide_by` for one tensor."""
    lw, uw, lh, uh = pads
    h_ax = spatial_axes[0] % x.ndim
    w_ax = spatial_axes[1] % x.ndim
    idx = [slice(None)] * x.ndim
    if lh + uh > 0:
        idx[h_ax] = slice(lh, x.shape[h_ax] - uh)
    if lw + uw > 0:
        idx[w_ax] = slice(lw, x.shape[w_ax] - uw)
    return x[tuple(idx)]
