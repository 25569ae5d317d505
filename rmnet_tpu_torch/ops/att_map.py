"""Regional attention map on the /16 grid (counterpart of
rmnet_tpu/ops/att_map.py; reference extensions/reg_att_map_generator).

Semantics of the reference CUDA op, forward only:
  * pixels with ``mask >= prob_threshold`` (0.5) vote;
  * fewer than ``n_pts_threshold`` (10) votes -> whole-frame box;
  * otherwise the tight box is dilated by ``n_bbox_loose_pixels`` (64) and
    clamped to the frame;
  * object slot 0 (background) gets a zero box and a zero map;
  * boxes are (x_min, x_max, y_min, y_max) int32, shape (B, K, 4).
The map is rasterized straight onto the nearest-sample /stride grid.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 32767  # reference kernel's init value for the mins


def _bboxes(
    mask: torch.Tensor,
    prob_threshold: float,
    n_pts_threshold: int,
    n_bbox_loose_pixels: int,
) -> torch.Tensor:
    """(B, K, 4) int32 dilated boxes (x_min, x_max, y_min, y_max)."""
    B, K, H, W = mask.shape
    dev = mask.device
    hit = mask >= prob_threshold                      # (B, K, H, W)
    n_pts = hit.sum(dim=(2, 3))                       # (B, K)
    hit_x = hit.any(dim=2)                            # (B, K, W)
    hit_y = hit.any(dim=3)                            # (B, K, H)
    xs = torch.arange(W, device=dev, dtype=torch.int32)
    ys = torch.arange(H, device=dev, dtype=torch.int32)
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    x_min = torch.where(hit_x, xs, big).amin(dim=2)
    x_max = torch.where(hit_x, xs, neg).amax(dim=2)
    y_min = torch.where(hit_y, ys, big).amin(dim=2)
    y_max = torch.where(hit_y, ys, neg).amax(dim=2)

    loose = n_bbox_loose_pixels
    whole = n_pts < n_pts_threshold
    zero = torch.zeros_like(x_min)
    x_min = torch.where(whole, zero, (x_min - loose).clamp(min=0))
    x_max = torch.where(whole, zero + (W - 1), (x_max + loose).clamp(max=W - 1))
    y_min = torch.where(whole, zero, (y_min - loose).clamp(min=0))
    y_max = torch.where(whole, zero + (H - 1), (y_max + loose).clamp(max=H - 1))
    box = torch.stack([x_min, x_max, y_min, y_max], dim=-1)  # (B, K, 4)
    obj = (torch.arange(K, device=dev) >= 1)[None, :, None]
    return torch.where(obj, box, torch.zeros_like(box)).to(torch.int32)


def _raster_small(
    bboxes: torch.Tensor,      # (B, K, 4) int32
    out_hw: Tuple[int, int],
    offset: Tuple[int, int],   # (top, left) padding before sampling
    stride: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Rasterize boxes on the /stride nearest-sample grid: cell (i, j) is
    inside iff stride*i - top is in [y_min, y_max] and stride*j - left in
    [x_min, x_max]; slot 0 is always outside."""
    B, K = bboxes.shape[:2]
    h, w = out_hw
    top, left = offset
    dev = bboxes.device
    xs = torch.arange(w, device=dev, dtype=torch.int32) * stride - left
    ys = torch.arange(h, device=dev, dtype=torch.int32) * stride - top
    b = bboxes[..., None]
    inside_x = (xs >= b[:, :, 0]) & (xs <= b[:, :, 1])   # (B, K, w)
    inside_y = (ys >= b[:, :, 2]) & (ys <= b[:, :, 3])   # (B, K, h)
    obj = (torch.arange(K, device=dev) >= 1)[None, :, None, None]
    att = inside_y[..., :, None] & inside_x[..., None, :] & obj
    return att.to(dtype)


def regional_attention_small(
    mask: torch.Tensor,
    out_hw: Tuple[int, int],
    offset: Tuple[int, int] = (0, 0),
    stride: int = 16,
    prob_threshold: float = 0.5,
    n_pts_threshold: int = 10,
    n_bbox_loose_pixels: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (B, K, H, W) -> (att (B, K, h, w) in mask's dtype, boxes
    (B, K, 4) int32 in mask coordinates)."""
    bboxes = _bboxes(mask, prob_threshold, n_pts_threshold, n_bbox_loose_pixels)
    return _raster_small(bboxes, out_hw, offset, stride, mask.dtype), bboxes
