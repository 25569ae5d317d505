"""Backward (inverse) warping by optical flow (counterpart of
rmnet_tpu/ops/warp.py; reference models/rmnet.py:252-278).

Samples ``img`` at pixel coordinates ``(x + flow_x, y + flow_y)`` with
bilinear ``grid_sample(align_corners=True, padding_mode='zeros')``
semantics, warps an all-ones validity mask the same way, cuts it at 0.9999
and zeroes the invalid output pixels. The four taps are gathered at pixel
coordinates directly: normalising them for ``F.grid_sample`` and back
shifts a coordinate by about 1e-6, enough to flip the 0.9999 cut at the
frame edge. The all-ones warp has a closed form per axis.

Layout as in the JAX package: img (B, H, W, C) or (B, H, W), flow
(B, H, W, 2) with flow[..., 0] = dx and flow[..., 1] = dy. Under a width
mesh (parallel/space.py) a rank warps only its own output columns: the flow
holds those columns, from global x = ``x0``, and the image is the whole
frame, since a flow vector can point into any shard.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis_coverage(c: torch.Tensor, n: int) -> torch.Tensor:
    """Bilinear sample of an all-ones 1-D signal with zeros padding."""
    c0 = torch.floor(c)
    w1 = c - c0
    in0 = ((c0 >= 0) & (c0 <= n - 1)).to(c.dtype)
    in1 = ((c0 + 1 >= 0) & (c0 + 1 <= n - 1)).to(c.dtype)
    return (1.0 - w1) * in0 + w1 * in1


def grid_sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (B, H, W, C) at float32 pixel coords x, y (B, Ho,
    Wo) with zeros padding -> (B, Ho, Wo, C); taps weighted in float32,
    result in img's dtype."""
    B, H, W, C = img.shape
    n = x.shape[1] * x.shape[2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        vals = torch.gather(flat, 1, idx.reshape(B, n, 1).expand(B, n, C))
        return vals.reshape(x.shape + (C,)).float() * valid[..., None]

    out = (tap(y0, x0) * (wy0 * wx0)[..., None]
           + tap(y0, x0 + 1) * (wy0 * wx1)[..., None]
           + tap(y0 + 1, x0) * (wy1 * wx0)[..., None]
           + tap(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])
    return out.to(img.dtype)


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  x0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp ``img`` backwards by ``flow`` -> (warped, binary validity mask),
    both shaped like ``img``, or, with a flow narrower than ``img``, like
    its columns ``x0`` .. ``x0`` + the flow's width - 1."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[..., None]
    B, H, W, C = img.shape
    # coordinate math in float32: a bf16 pixel grid quantizes to multiples
    # of 4 beyond x = 512
    flow32 = flow.float()
    xs = torch.arange(x0, x0 + flow.shape[2], dtype=torch.float32,
                      device=img.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]
    x = xs + flow32[..., 0]
    y = ys + flow32[..., 1]
    warped = grid_sample_bilinear(img, x, y)
    ones = _axis_coverage(y, H) * _axis_coverage(x, W)
    mask = (ones >= 0.9999).to(img.dtype)[..., None].expand_as(warped)
    warped = warped * mask
    if squeeze:
        return warped[..., 0], mask[..., 0]
    return warped, mask
