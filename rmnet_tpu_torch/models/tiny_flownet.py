"""TinyFlowNet: FlowNetS-style coarse-to-fine flow CNN (counterpart of
rmnet_tpu/models/tiny_flownet.py; reference models/tiny_flownet.py).

Inputs are padded to /64 and halved (bilinear, align_corners=False) before
the conv stack; ``flow2`` is predicted at 1/8 of the padded size, upsampled
x8 and un-padded. Transposed convs are native transposed convolutions. The
Sequential-wrapped convs keep the reference's state-dict names (convX.0.*).
The convs take a compute dtype (models/layers.py): the resize runs in the
frames' dtype, every conv in its compute dtype.

Under a width mesh (``space``, parallel/space.py, on the /64 grid: ``CELL``)
the pair runs on the rank's whole /64 columns of the padded frame: the
halving resize needs no halo, every conv and transposed conv exchanges the
halo its kernel reads, the x8 resize one column each side, and the flow
comes back as the rank's columns of the unpadded frame. The mesh is set for
the call with ``WidthMesh.installed``, as ``RMNetApply.forward_video`` sets
RMNet's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rmnet_tpu_torch.models.layers import Conv2d, ConvTranspose2d, set_compute_dtype
from rmnet_tpu_torch.ops.pad import pad_divide_by, unpad

CELL = 64  # frames are padded to a multiple of 64: the coarsest grid's column


def _conv(cin, cout, k, s):
    return nn.Sequential(Conv2d(cin, cout, k, s, (k - 1) // 2), nn.LeakyReLU(0.1))


def _deconv(cin, cout):
    return nn.Sequential(ConvTranspose2d(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1))


class TinyFlowNet(nn.Module):
    """``dtype`` is every conv's compute dtype (None: the weights')."""

    space = None  # a width mesh on the /64 grid: the rank's columns (parallel/space.py)

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(6, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv3_1 = _conv(256, 256, 3, 1)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512, 3, 1)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512, 3, 1)
        self.deconv4 = _deconv(512, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        self.predict_flow5 = Conv2d(512, 2, 3, 1, 1)
        self.predict_flow4 = Conv2d(770, 2, 3, 1, 1)
        self.predict_flow3 = Conv2d(386, 2, 3, 1, 1)
        self.predict_flow2 = Conv2d(194, 2, 3, 1, 1)
        self.upsampled_flow5_to_4 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)
        self.upsampled_flow4_to_3 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)
        self.upsampled_flow3_to_2 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)
        set_compute_dtype(self, dtype)

    def pair_forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Flow img0 -> img1 for one frame pair: NCHW (B, 3, H, W) each ->
        (B, 2, H, W), channel 0 = dx, 1 = dy; under a width mesh the whole
        frames -> the rank's columns of the flow, (B, 2, H, its share)."""
        space = self.space
        if space is not None and (space.height, space.width, space.cell) != (
                *img0.shape[-2:], CELL):
            raise ValueError(f"a width mesh over {space.height}x{space.width} on the "
                             f"/{space.cell} grid, frames of {tuple(img0.shape[-2:])}")
        (img0, img1), pads = pad_divide_by([img0, img1], CELL, spatial_axes=(-2, -1))
        Hp, Wp = img0.shape[-2:]
        x = torch.cat([img0, img1], dim=1)
        if space is None:
            x = F.interpolate(x, size=(Hp // 2, Wp // 2), mode="bilinear",
                              align_corners=False)
        else:
            x = space.downsample2(space.padded_slice(x))
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))

        flow5 = self.predict_flow5(out_conv5)
        concat4 = torch.cat(
            [out_conv4, self.deconv4(out_conv5), self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat(
            [out_conv3, self.deconv3(concat4), self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat(
            [out_conv2, self.deconv2(concat3), self.upsampled_flow3_to_2(flow3)], 1)
        flow2 = self.predict_flow2(concat2)
        if space is not None:
            return unpad(space.upsample(flow2, 8), space.own_pads(pads), spatial_axes=(-2, -1))
        flow2 = F.interpolate(flow2, size=(Hp, Wp), mode="bilinear", align_corners=False)
        return unpad(flow2, pads, spatial_axes=(-2, -1))

    def video_forward(self, frames: torch.Tensor) -> torch.Tensor:
        """Per-video forward (the JAX package's ``TinyFlowNet.__call__``):
        frames (B, T, H, W, 3) -> backward flows (B, T, H, W, 2), where
        flows[:, t] maps frame t to t-1 and flows[:, 0] = 0. The T-1 pairs
        run as one batch. Under a width mesh the flows hold the rank's
        columns of the frame."""
        B, T, H, W, C = frames.shape
        if T == 1:
            lo, hi = (0, W) if self.space is None else self.space.unpadded_columns()
            return frames.new_zeros(B, T, H, hi - lo, 2)
        x = frames.permute(0, 1, 4, 2, 3)
        curr = x[:, 1:].reshape(B * (T - 1), C, H, W)
        prev = x[:, :-1].reshape(B * (T - 1), C, H, W)
        flows = self.pair_forward(curr, prev)
        flows = flows.permute(0, 2, 3, 1).reshape(B, T - 1, H, flows.shape[-1], 2)
        return torch.cat([flows.new_zeros((B, 1) + flows.shape[2:]), flows], dim=1)

    def forward(self, img0, img1):
        return self.pair_forward(img0, img1)
