"""Regional attention map on the /16 grid (counterpart of
rmnet_tpu/ops/att_map.py; reference extensions/reg_att_map_generator).

Semantics of the reference CUDA op:
  * pixels with ``mask >= prob_threshold`` (0.5) vote;
  * fewer than ``n_pts_threshold`` (10) votes -> whole-frame box;
  * otherwise the tight box is dilated by ``n_bbox_loose_pixels`` (64) and
    clamped to the frame;
  * object slot 0 (background) gets a zero box and a zero map;
  * boxes are (x_min, x_max, y_min, y_max) int32, shape (B, K, 4).
The map is rasterized straight onto the nearest-sample /stride grid.

Gradients, as the reference wrapper and the JAX package give them: the map's
gradient with respect to the mask is constant ones, whatever the cotangent
(reference extensions/reg_att_map_generator/__init__.py:21-24,
rmnet_tpu/ops/att_map.py:317-331); through the fused warp it is the warp's
transpose applied to those ones, one channel-uniform splat field, with no
gradient to the flow (rmnet_tpu/ops/att_map.py:210-314).
"""

from __future__ import annotations

from typing import Tuple

import torch

from rmnet_tpu_torch.ops.warp import _axis_coverage, backward_warp

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


class _RegionalAttentionSmall(torch.autograd.Function):
    """Box map on the /stride grid; backward: constant ones for the mask."""

    @staticmethod
    def forward(ctx, mask, out_hw, offset, stride, prob_threshold, n_pts_threshold,
                n_bbox_loose_pixels):
        bboxes = _bboxes(mask, prob_threshold, n_pts_threshold, n_bbox_loose_pixels)
        ctx.mark_non_differentiable(bboxes)
        ctx.mask_meta = (mask.shape, mask.dtype, mask.device)
        return _raster_small(bboxes, out_hw, offset, stride, mask.dtype), bboxes

    @staticmethod
    def backward(ctx, g_att, g_boxes):
        shape, dtype, device = ctx.mask_meta
        return (torch.ones(shape, dtype=dtype, device=device),) + (None,) * 6


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
    (B, K, 4) int32 in mask coordinates). The gradient with respect to
    ``mask`` is ones, whatever reaches ``att``."""
    return _RegionalAttentionSmall.apply(mask, out_hw, offset, stride, prob_threshold,
                                         n_pts_threshold, n_bbox_loose_pixels)


def _warp_splat_ones(flow: torch.Tensor) -> torch.Tensor:
    """Transpose of the masked bilinear warp (ops/warp.py) applied to an
    all-ones cotangent: flow (B, H, W, 2) -> (B, H, W) float32 field
    ``omega[p] = sum_q valid(q) w_tap(q) [tap(q) == p]``, each output
    pixel's bilinear weights splatted back onto its four source taps (one
    ``scatter_add_`` over the four taps)."""
    B, H, W, _ = flow.shape
    flow32 = flow.float()
    x = torch.arange(W, dtype=torch.float32, device=flow.device)[None, None, :] + flow32[..., 0]
    y = torch.arange(H, dtype=torch.float32, device=flow.device)[None, :, None] + flow32[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    # the validity multiplier of the warped output: ones-coverage >= 0.9999
    ct = (_axis_coverage(y, H) * _axis_coverage(x, W) >= 0.9999).float()
    idx, val = [], []
    for dy, wy in ((0.0, 1.0 - wy1), (1.0, wy1)):
        yi = y0 + dy
        in_y = (yi >= 0) & (yi <= H - 1)
        for dx, wx in ((0.0, 1.0 - wx1), (1.0, wx1)):
            xi = x0 + dx
            inside = in_y & (xi >= 0) & (xi <= W - 1)
            idx.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, -1))
            val.append((ct * wy * wx * inside).reshape(B, -1))
    omega = torch.zeros(B, H * W, dtype=torch.float32, device=flow.device)
    omega.scatter_add_(1, torch.cat(idx, dim=1), torch.cat(val, dim=1))
    return omega.reshape(B, H, W)


class _WarpedRegionalAttentionSmall(torch.autograd.Function):
    """Warp all K channels, then the box map; backward: the splat field of
    ones broadcast over K for the mask, nothing for the flow."""

    @staticmethod
    def forward(ctx, mask, flow, out_hw, offset, stride, prob_threshold, n_pts_threshold,
                n_bbox_loose_pixels):
        warped, _ = backward_warp(mask.permute(0, 2, 3, 1), flow)
        bboxes = _bboxes(warped.permute(0, 3, 1, 2), prob_threshold, n_pts_threshold,
                         n_bbox_loose_pixels)
        ctx.save_for_backward(flow)
        ctx.mask_meta = (mask.shape, mask.dtype)
        return _raster_small(bboxes, out_hw, offset, stride, mask.dtype)

    @staticmethod
    def backward(ctx, g_att):
        (flow,) = ctx.saved_tensors
        shape, dtype = ctx.mask_meta
        omega = _warp_splat_ones(flow)
        return (omega[:, None].expand(shape).to(dtype),) + (None,) * 7


def warped_regional_attention_small(
    mask: torch.Tensor,            # (B, K, H, W)
    flow: torch.Tensor,            # (B, H, W, 2)
    out_hw: Tuple[int, int],
    offset: Tuple[int, int] = (0, 0),
    stride: int = 16,
    prob_threshold: float = 0.5,
    n_pts_threshold: int = 10,
    n_bbox_loose_pixels: int = 64,
) -> torch.Tensor:
    """``backward_warp`` of all K channels by ``flow``, then the box map
    -> att (B, K, h, w). The training branch of ``get_att_small``: the
    map's cotangent is always the constant ones of its straight-through
    gradient, so the mask's gradient is exactly the channel-broadcast
    splat of ones, and the flow (a data input) gets none."""
    return _WarpedRegionalAttentionSmall.apply(mask, flow, out_hw, offset, stride,
                                               prob_threshold, n_pts_threshold,
                                               n_bbox_loose_pixels)
