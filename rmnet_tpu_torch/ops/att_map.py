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

Under a width mesh (parallel/space.py) a rank holds some columns of the mask
(a :class:`ColumnShard`, possibly none): its columns vote with their global
x, the point counts are summed over the ranks and the extremes reduced in one
MIN, the maxima negated (a rank with no hit keeps the sentinels 32767 and
-1), the boxes are clamped to the global width, and the rank rasterizes its
own grid columns. The fused training warp takes the rank's flow columns
against the whole previous mask; its gradient is the splat of those output
columns onto the whole frame, which the ranks' sum completes.

Gradients, as the reference wrapper and the JAX package give them: the map's
gradient with respect to the mask is constant ones, whatever the cotangent
(reference extensions/reg_att_map_generator/__init__.py:21-24,
rmnet_tpu/ops/att_map.py:317-331); through the fused warp it is the warp's
transpose applied to those ones, one channel-uniform splat field, with no
gradient to the flow (rmnet_tpu/ops/att_map.py:210-314).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rmnet_tpu_torch.ops.warp import _axis_coverage, backward_warp

_BIG = 32767  # reference kernel's init value for the mins


class ColumnShard(NamedTuple):
    """A rank's columns of a mask sharded along its width: ``x0`` the global
    x of its first column, ``width`` the mask's global width, ``grid0`` the
    global index of its first column of the /stride grid, ``mesh`` the width
    mesh, whose ``all_reduce(t, op, kind)`` reduces over the ranks."""

    x0: int
    width: int
    grid0: int
    mesh: Any


def _bboxes(
    mask: torch.Tensor,
    prob_threshold: float,
    n_pts_threshold: int,
    n_bbox_loose_pixels: int,
    shard: Optional[ColumnShard] = None,
) -> torch.Tensor:
    """(B, K, 4) int32 dilated boxes (x_min, x_max, y_min, y_max); with
    ``shard``, of the whole mask of which ``mask`` holds the rank's columns."""
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
    if shard is not None:
        xs = xs + shard.x0
        W = shard.width
    if hit_x.shape[2]:
        x_min = torch.where(hit_x, xs, big).amin(dim=2)
        x_max = torch.where(hit_x, xs, neg).amax(dim=2)
    else:  # a rank of a width mesh that holds no column
        x_min, x_max = big.expand(B, K), neg.expand(B, K)
    y_min = torch.where(hit_y, ys, big).amin(dim=2)
    y_max = torch.where(hit_y, ys, neg).amax(dim=2)
    if shard is not None:
        n_pts = shard.mesh.all_reduce(n_pts, "sum", "box points")
        ext = shard.mesh.all_reduce(torch.stack([x_min, y_min, -x_max, -y_max]), "min",
                                    "box extremes")
        x_min, y_min, x_max, y_max = ext[0], ext[1], -ext[2], -ext[3]

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
    grid0: int = 0,
) -> torch.Tensor:
    """Rasterize boxes on the /stride nearest-sample grid: cell (i, j) is
    inside iff stride*i - top is in [y_min, y_max] and stride*j - left in
    [x_min, x_max]; slot 0 is always outside. The grid's columns are j =
    ``grid0`` .. ``grid0`` + w - 1."""
    B, K = bboxes.shape[:2]
    h, w = out_hw
    top, left = offset
    dev = bboxes.device
    xs = (torch.arange(w, device=dev, dtype=torch.int32) + grid0) * stride - left
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
                n_bbox_loose_pixels, shard):
        bboxes = _bboxes(mask, prob_threshold, n_pts_threshold, n_bbox_loose_pixels, shard)
        ctx.mark_non_differentiable(bboxes)
        ctx.mask_meta = (mask.shape, mask.dtype, mask.device)
        grid0 = 0 if shard is None else shard.grid0
        return _raster_small(bboxes, out_hw, offset, stride, mask.dtype, grid0), bboxes

    @staticmethod
    def backward(ctx, g_att, g_boxes):
        shape, dtype, device = ctx.mask_meta
        return (torch.ones(shape, dtype=dtype, device=device),) + (None,) * 7


def regional_attention_small(
    mask: torch.Tensor,
    out_hw: Tuple[int, int],
    offset: Tuple[int, int] = (0, 0),
    stride: int = 16,
    prob_threshold: float = 0.5,
    n_pts_threshold: int = 10,
    n_bbox_loose_pixels: int = 64,
    shard: Optional[ColumnShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (B, K, H, W) -> (att (B, K, h, w) in mask's dtype, boxes
    (B, K, 4) int32 in mask coordinates). The gradient with respect to
    ``mask`` is ones, whatever reaches ``att``. With ``shard``, ``mask`` and
    ``att`` are the rank's columns and the boxes the whole mask's."""
    return _RegionalAttentionSmall.apply(mask, out_hw, offset, stride, prob_threshold,
                                         n_pts_threshold, n_bbox_loose_pixels, shard)


def _warp_splat_ones(flow: torch.Tensor, x0: int = 0, width: Optional[int] = None
                     ) -> torch.Tensor:
    """Transpose of the masked bilinear warp (ops/warp.py) applied to an
    all-ones cotangent: flow (B, H, W, 2) -> (B, H, W) float32 field
    ``omega[p] = sum_q valid(q) w_tap(q) [tap(q) == p]``, each output
    pixel's bilinear weights splatted back onto its four source taps (one
    ``scatter_add_`` over the four taps). With a flow of some columns of a
    frame of ``width`` (from global x = ``x0``), the splat of those output
    columns onto the whole frame (B, H, width)."""
    B, H, Wf, _ = flow.shape
    W = Wf if width is None else width
    flow32 = flow.float()
    x = torch.arange(x0, x0 + Wf, dtype=torch.float32,
                     device=flow.device)[None, None, :] + flow32[..., 0]
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
                n_bbox_loose_pixels, shard):
        x0, grid0 = (0, 0) if shard is None else (shard.x0, shard.grid0)
        warped, _ = backward_warp(mask.permute(0, 2, 3, 1), flow, x0)
        bboxes = _bboxes(warped.permute(0, 3, 1, 2), prob_threshold, n_pts_threshold,
                         n_bbox_loose_pixels, shard)
        ctx.save_for_backward(flow)
        ctx.mask_meta = (mask.shape, mask.dtype, x0)
        return _raster_small(bboxes, out_hw, offset, stride, mask.dtype, grid0)

    @staticmethod
    def backward(ctx, g_att):
        (flow,) = ctx.saved_tensors
        shape, dtype, x0 = ctx.mask_meta
        omega = _warp_splat_ones(flow, x0, shape[-1])
        return (omega[:, None].expand(shape).to(dtype),) + (None,) * 8


def warped_regional_attention_small(
    mask: torch.Tensor,            # (B, K, H, W)
    flow: torch.Tensor,            # (B, H, W, 2)
    out_hw: Tuple[int, int],
    offset: Tuple[int, int] = (0, 0),
    stride: int = 16,
    prob_threshold: float = 0.5,
    n_pts_threshold: int = 10,
    n_bbox_loose_pixels: int = 64,
    shard: Optional[ColumnShard] = None,
) -> torch.Tensor:
    """``backward_warp`` of all K channels by ``flow``, then the box map
    -> att (B, K, h, w). The training branch of ``get_att_small``: the
    map's cotangent is always the constant ones of its straight-through
    gradient, so the mask's gradient is exactly the channel-broadcast
    splat of ones, and the flow (a data input) gets none. With ``shard``,
    ``flow`` and ``att`` hold the rank's columns, ``mask`` the whole frame:
    the boxes are reduced over the ranks and the gradient is the splat of
    the rank's output columns, a part of the whole frame's."""
    return _WarpedRegionalAttentionSmall.apply(mask, flow, out_hw, offset, stride,
                                               prob_threshold, n_pts_threshold,
                                               n_bbox_loose_pixels, shard)
