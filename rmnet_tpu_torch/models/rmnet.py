"""RMNet: regional space-time-memory network, inference and training paths
(counterpart of rmnet_tpu/models/rmnet.py; reference models/rmnet.py).

Modules run in NCHW and keep the reference's state-dict names. The per-frame
control flow lives in :class:`RMNetApply`, as in the JAX package:

  * the object axis is a static ``K`` with (B, K) validity masks; slot 0 is
    the background and never reaches the encoders or the memory read;
  * the bank is a fixed-capacity ring with a write cursor; invalid slots get
    -inf scores (exactly zero probability), so it reads like the reference's
    ``torch.cat``-grown bank; past capacity the oldest slot is evicted;
  * the previous frame always rides one extra, ephemeral slot;
  * keys/values are masked by the /16 regional map, and masked-out valid
    positions keep score 0 and still take softmax mass, as in the reference;
  * every stream of the batch has its own cursor and flags, all on the
    device: ``step`` reads no value back to the host, so ``chunk_forward``
    can be captured in a CUDA graph;
  * ``step`` (inference) writes the ring in place; ``forward_video``
    (training, backprop through time) builds each frame's bank out of place,
    since the memory read saves the bank for its backward.

Constants 32.0605 / -16.1181 (reference models/rmnet.py:442-448) equal
log(eps / (1 - eps)) for the aggregation clamp eps = 1e-7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rmnet_tpu_torch.models.resnet import ResNet50Trunk
from rmnet_tpu_torch.ops.aggregation import soft_aggregation
from rmnet_tpu_torch.ops.att_map import (regional_attention_small,
                                         warped_regional_attention_small)
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read
from rmnet_tpu_torch.ops.pad import divide_pads, pad_divide_by, unpad
from rmnet_tpu_torch.ops.warp import backward_warp

NEW_OBJECT_SCALE = 32.0605
NEW_OBJECT_BIAS = -16.1181
SUPPRESSED = -16.1181


def _present_objects(one_hot: torch.Tensor) -> torch.Tensor:
    """(B, K) flags: which slots the argmax label map of (B, K, H, W) one-hot
    masks contains. Slot k >= 1 is present iff its channel fires anywhere;
    slot 0 wherever no k >= 1 channel fires."""
    fg = one_hot[:, 1:] >= 0.5
    present_fg = fg.flatten(2).any(dim=2)
    present_bg = (~fg.any(dim=1)).flatten(1).any(dim=1)
    return torch.cat([present_bg[:, None], present_fg], dim=1)


class ResBlock(nn.Module):
    """2x 3x3-conv residual block (reference models/rmnet.py:24-48)."""

    def __init__(self, indim: int, outdim: Optional[int] = None, stride: int = 1):
        super().__init__()
        outdim = outdim or indim
        self.downsample = None
        if indim != outdim or stride != 1:
            self.downsample = nn.Conv2d(indim, outdim, 3, padding=1, stride=stride)
        self.conv1 = nn.Conv2d(indim, outdim, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(outdim, outdim, 3, padding=1)

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class EncoderMemory(ResNet50Trunk):
    """ResNet-50 trunk + mask / other-mask stems (reference models/rmnet.py:51-80)."""

    def __init__(self):
        super().__init__()
        self.conv1_m = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.conv1_o = nn.Conv2d(1, 64, 7, stride=2, padding=3, bias=False)

    def forward(self, f, m, o):
        """f (B, 3, H, W); m, o (B, H, W) -> r4 (B, 1024, H/16, W/16)."""
        dt = self.conv1.weight.dtype
        extra = self.conv1_m(m[:, None].to(dt)) + self.conv1_o(o[:, None].to(dt))
        return self.trunk(f.to(dt), extra_stem=extra)[0]

    def shared(self, f, m_bk, o_bk):
        """Per-object encode with the three 7x7 stems merged into one
        5-channel conv: f (B, 3, H, W); m_bk, o_bk (B*Ko, H, W), object folded
        into the batch B-major. ``conv1(f) + conv1_m(m) + conv1_o(o)`` is one
        conv with the kernels concatenated on the input axis."""
        B = f.shape[0]
        Ko = m_bk.shape[0] // B
        dt = self.conv1.weight.dtype
        f_bk = f.to(dt)[:, None].expand(B, Ko, *f.shape[1:]).reshape(B * Ko, *f.shape[1:])
        x5 = torch.cat([f_bk, m_bk[:, None].to(dt), o_bk[:, None].to(dt)], dim=1)
        w5 = torch.cat([self.conv1.weight, self.conv1_m.weight, self.conv1_o.weight], dim=1)
        c1 = F.conv2d(x5, w5, stride=2, padding=3)
        return self.trunk(None, conv1_out=c1)[0]


class EncoderQuery(ResNet50Trunk):
    """RGB-only ResNet-50 trunk (reference models/rmnet.py:83-104)."""

    def forward(self, f):
        r4, r3, r2, _ = self.trunk(f.to(self.conv1.weight.dtype))
        return r4, r3, r2


class KeyValue(nn.Module):
    """Parallel 3x3 key/value heads (reference models/rmnet.py:168-176)."""

    def __init__(self, indim: int = 1024, keydim: int = 128, valdim: int = 512):
        super().__init__()
        self.key_conv = nn.Conv2d(indim, keydim, 3, padding=1)
        self.value_conv = nn.Conv2d(indim, valdim, 3, padding=1)

    def forward(self, x):
        return self.key_conv(x), self.value_conv(x)


class Refine(nn.Module):
    """Decoder refinement block (reference models/rmnet.py:107-120)."""

    def __init__(self, inplanes: int, planes: int, scale_factor: int = 2):
        super().__init__()
        self.convFS = nn.Conv2d(inplanes, planes, 3, padding=1)
        self.ResFS = ResBlock(planes)
        self.ResMM = ResBlock(planes)
        self.scale_factor = scale_factor

    def skip(self, f):
        """Skip branch: depends only on the frame's encoder feature, so the
        caller computes it once per frame and shares it across objects."""
        return self.ResFS(self.convFS(f))

    def fuse(self, s, pm):
        up = F.interpolate(pm, size=(pm.shape[-2] * self.scale_factor,
                                     pm.shape[-1] * self.scale_factor),
                           mode="bilinear", align_corners=False)
        return self.ResMM(s + up)

    def forward(self, f, pm):
        return self.fuse(self.skip(f), pm)


class Decoder(nn.Module):
    """1024 -> 2-logit decoder with skip refinement (reference models/rmnet.py:123-140)."""

    def __init__(self, mdim: int = 256):
        super().__init__()
        self.convFM = nn.Conv2d(1024, mdim, 3, padding=1)
        self.ResMM = ResBlock(mdim)
        self.RF3 = Refine(512, mdim)
        self.RF2 = Refine(256, mdim)
        self.pred2 = nn.Conv2d(mdim, 2, 3, padding=1)

    def skips(self, r3, r2):
        """Per-frame skip features (the object-independent half)."""
        return self.RF3.skip(r3), self.RF2.skip(r2)

    def from_skips(self, r4, s3, s2):
        """Per-object half: r4 is the memory-read output, s3/s2 precomputed."""
        m4 = self.ResMM(self.convFM(r4))
        m3 = self.RF3.fuse(s3, m4)
        m2 = self.RF2.fuse(s2, m3)
        p2 = self.pred2(F.relu(m2))
        return F.interpolate(p2, size=(p2.shape[-2] * 4, p2.shape[-1] * 4),
                             mode="bilinear", align_corners=False)

    def forward(self, r4, r3, r2):
        s3, s2 = self.skips(r3, r2)
        return self.from_skips(r4, s3, s2)


def _dense_read(m_key, m_val, q_key, slot_valid):
    """Dense memory read -> (mem (N, h, w, Cv), p (N, S*h*w, h*w)).

    Scores and softmax in float32; invalid slots get -inf."""
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    mk = m_key.reshape(N, S * hw, Ck).float()
    qk = q_key.reshape(N, hw, Ck).float()
    scores = torch.bmm(mk, qk.transpose(1, 2)) / math.sqrt(Ck)  # (N, M, Q)
    valid = slot_valid[:, :, None].expand(N, S, hw).reshape(N, S * hw)
    scores = scores.masked_fill(~valid[..., None], -math.inf)
    p = torch.softmax(scores, dim=1)
    mv = m_val.reshape(N, S * hw, Cv)
    mem = torch.bmm(p.transpose(1, 2).to(mv.dtype), mv)  # (N, Q, Cv)
    return mem.reshape(N, h, w, Cv), p


def memory_read(m_key, m_val, q_key, q_val, slot_valid):
    """Space-time memory read (reference MemoryReader, models/rmnet.py:143-165).

    m_key (N, S, h, w, Ck), m_val (N, S, h, w, Cv), q_key (N, h, w, Ck),
    q_val (N, h, w, Cv), slot_valid (N, S) bool ->
    (concat(mem, q_val) (N, h, w, 2*Cv), affinity (N, S*h*w, h*w)).
    """
    mem, p = _dense_read(m_key, m_val, q_key, slot_valid)
    return torch.cat([mem.to(q_val.dtype), q_val], dim=-1), p


def _slot_valid(capacity: int, cursor: torch.Tensor, commit: torch.Tensor) -> torch.Tensor:
    """(B, capacity + 1) bool validity of each stream's bank view, from its
    OLD cursor (B,) int32 and its commit flag (B,) bool: a slot is valid
    below the cursor, the ring slot written this step is excluded (prev rides
    the ephemeral slot), the ephemeral slot ``capacity`` always is
    (rmnet_tpu/models/rmnet.py:757-762)."""
    idx = torch.arange(capacity + 1, device=cursor.device)
    valid = idx < cursor.clamp(max=capacity)[:, None]
    valid &= ~(commit[:, None] & (idx == (cursor % capacity)[:, None]))
    return valid | (idx == capacity)


class RMNet(nn.Module):
    """Container of the RMNet sub-networks (reference state-dict names)."""

    def __init__(self):
        super().__init__()
        self.encoder_memory = EncoderMemory()
        self.encoder_query = EncoderQuery()
        self.kv_memory = KeyValue(1024, 128, 512)
        self.kv_query = KeyValue(1024, 128, 512)
        self.decoder = Decoder(256)


@dataclasses.dataclass
class VOSState:
    """Streaming state carried across frames. ``keys``/``values``/``bboxes``
    hold ``capacity`` ring slots plus the ephemeral slot at index
    ``capacity``; ``step`` writes them in place."""

    keys: torch.Tensor        # (B, K, S+1, h, w, Ck)
    values: torch.Tensor      # (B, K, S+1, h, w, Cv)
    bboxes: torch.Tensor      # (B, K, S+1, 4) int32
    cursor: torch.Tensor      # (B,) int32, committed slots so far per stream
    prev_mask: torch.Tensor   # (B, K, H, W) previous frame's estimated mask
    prev_frame: torch.Tensor  # (B, 3, H, W)
    exist: torch.Tensor       # (B, K) bool, objects revealed so far

    @property
    def capacity(self) -> int:
        return self.keys.shape[2] - 1

    def reset_(self, frame0, masks0) -> "VOSState":
        """Start new videos in place: empty bank, cursors 0, frame 0 and its
        one-hot masks (B, K, H, W) as the previous frame."""
        for t in (self.keys, self.values, self.bboxes, self.cursor):
            t.zero_()
        self.prev_mask.copy_(masks0)
        self.prev_frame.copy_(frame0)
        self.exist.copy_(_present_objects(masks0))
        return self


@dataclasses.dataclass
class RMNetApply:
    """Inference control flow of RMNet: memorize / att map / segment / step
    (reference models/rmnet.py:191-452, rmnet_tpu RMNetApply)."""

    model: RMNet
    memorize_every: int = 5
    prob_threshold: float = 0.5
    n_pts_threshold: int = 10
    n_bbox_loose_pixels: int = 64
    # block-sparse flash read through the CUDA kernel (the plain version on
    # the CPU); False reads the whole bank densely
    use_flash_attention: bool = True

    def _att(self, mask, out_hw, offset):
        return regional_attention_small(
            mask, out_hw, offset, 16,
            self.prob_threshold, self.n_pts_threshold, self.n_bbox_loose_pixels,
        )

    def memorize(self, frame, masks, obj_valid):
        """Encode one frame into per-object regional keys/values.

        frame (B, 3, H, W), masks (B, K, H, W), obj_valid (B, K) bool ->
        (k4 (B, K, h, w, Ck), v4 (B, K, h, w, Cv), bboxes (B, K, 4) int32),
        channels last; slot 0 and invalid objects are zero.
        """
        B, K = masks.shape[:2]
        (frame_p,), _ = pad_divide_by([frame], 16, spatial_axes=(-2, -1))
        (masks_p,), _ = pad_divide_by([masks], 16, spatial_axes=(-2, -1))
        Hp, Wp = masks_p.shape[-2:]
        v = obj_valid.to(masks_p.dtype)[:, :, None, None]
        masks_v = masks_p * v
        others = (masks_v.sum(dim=1, keepdim=True) - masks_v).clamp(0.0, 1.0)

        # only the K-1 object slots are encoded; the RGB stem is shared
        Ko = K - 1
        m = self.model
        r4 = m.encoder_memory.shared(frame_p, masks_p[:, 1:].reshape(B * Ko, Hp, Wp),
                                     others[:, 1:].reshape(B * Ko, Hp, Wp))
        k4, v4 = m.kv_memory(r4)
        h, w = k4.shape[-2:]
        att, bboxes = self._att(masks_p, (h, w), (0, 0))
        # zero slot 0 and invalid objects, mask by the /16 regional map
        keep = (att * v)[:, 1:].to(k4.dtype)[..., None]  # (B, Ko, h, w, 1)
        k_obj = k4.permute(0, 2, 3, 1).reshape(B, Ko, h, w, -1) * keep
        v_obj = v4.permute(0, 2, 3, 1).reshape(B, Ko, h, w, -1) * keep
        return F.pad(k_obj, (0, 0, 0, 0, 0, 0, 1, 0)), F.pad(v_obj, (0, 0, 0, 0, 0, 0, 1, 0)), bboxes

    def get_att_small(self, prev_mask, flow, out_hw, offset):
        """Warp the previous mask by ``flow`` (B, 2, H, W) and rasterize its
        dilated boxes on the /16 query grid -> (B, K, h, w).

        With autograd on (training) all K channels are warped through the
        fused op, whose gradient is the channel-uniform splat of the map's
        constant-ones gradient: that constant only cancels through the
        estimate's softmax when every channel gets it (rmnet_tpu/models/
        rmnet.py:504-509). Otherwise the background channel is not warped:
        slot 0 never reaches the box op, so the map is the same."""
        if flow is None:
            expt = prev_mask
        elif torch.is_grad_enabled():
            return warped_regional_attention_small(
                prev_mask, flow.permute(0, 2, 3, 1), out_hw, offset, 16,
                self.prob_threshold, self.n_pts_threshold, self.n_bbox_loose_pixels)
        else:
            warped, _ = backward_warp(prev_mask[:, 1:].permute(0, 2, 3, 1),
                                      flow.permute(0, 2, 3, 1))
            expt = F.pad(warped.permute(0, 3, 1, 2), (0, 0, 0, 0, 1, 0))
        return self._att(expt, out_hw, offset)[0]

    def segment(self, frame, att_small, mem_keys, mem_values, slot_valid,
                obj_valid, mem_bboxes=None):
        """One segmentation pass -> (B, K, H, W) float32 logits
        (reference models/rmnet.py:304-383).

        frame (B, 3, H, W); att_small (B, K, h, w); mem_keys/values
        (B, K, S, h, w, C); slot_valid (B, S) bool, per stream; mem_bboxes
        (B, K, S, 4), needed by the flash read.
        """
        B, K, S = mem_keys.shape[:3]
        (frame_p,), pads = pad_divide_by([frame], 16, spatial_axes=(-2, -1))
        Hp, Wp = frame_p.shape[-2:]
        m = self.model
        r4, r3, r2 = m.encoder_query(frame_p)
        k4, v4 = m.kv_query(r4)
        h, w = k4.shape[-2:]

        Ko = K - 1
        N = B * Ko
        att = att_small[:, 1:].to(k4.dtype)[:, :, None]          # (B, Ko, 1, h, w)
        q_key = (k4[:, None] * att).permute(0, 1, 3, 4, 2).reshape(N, h, w, -1)
        q_val = (v4[:, None] * att).reshape(N, -1, h, w)
        valid = slot_valid[:, None].expand(B, Ko, S).reshape(N, S)
        # views of the bank (a copy only when B > 1)
        mk = mem_keys[:, 1:].reshape(N, S, h, w, -1)
        mv = mem_values[:, 1:].reshape(N, S, h, w, -1)
        if self.use_flash_attention:
            boxes = mem_bboxes[:, 1:].reshape(N, S, 4)
            mem, _ = flash_memory_read(mk, mv, q_key.contiguous(), valid, boxes)
        else:
            mem, _ = _dense_read(mk, mv, q_key, valid)
        m4 = torch.cat([mem.to(q_val.dtype).permute(0, 3, 1, 2), q_val], dim=1)

        # skip branches once per frame, shared across objects
        s3, s2 = m.decoder.skips(r3, r2)
        s3 = s3[:, None].expand(B, Ko, *s3.shape[1:]).reshape(N, *s3.shape[1:])
        s2 = s2[:, None].expand(B, Ko, *s2.shape[1:]).reshape(N, *s2.shape[1:])
        logits2 = m.decoder.from_skips(m4, s3, s2)               # (N, 2, Hp, Wp)
        ps = torch.softmax(logits2, dim=1)[:, 1].reshape(B, Ko, Hp, Wp)
        ps = F.pad(ps, (0, 0, 0, 0, 1, 0))
        logit = soft_aggregation(ps, obj_valid)
        return unpad(logit, pads, spatial_axes=(-2, -1))

    def step(self, state: VOSState, frame, flow, gt_mask, any_new, commit,
             obj_valid) -> Tuple[VOSState, torch.Tensor]:
        """One timestep of the reference loop (models/rmnet.py:410-450) for
        each stream of the batch (rmnet_tpu/models/rmnet.py:663-802, its
        per-stream mode; a lockstep batch is the case of equal flags).

        frame (B, 3, H, W); flow (B, 2, H, W) backward flow t -> t-1; gt_mask
        (B, K, H, W) one-hot, read only where ``any_new``; any_new (B,) bool;
        commit (B,) bool commits frame t-1 to the stream's ring slot at
        ``cursor % capacity``. Returns (new_state, est_mask (B, K, H, W)).
        The bank tensors of ``state`` are updated in place; nothing is read
        back to the host.
        """
        B = frame.shape[0]
        S = state.capacity
        prev_k, prev_v, prev_box = self.memorize(state.prev_frame, state.prev_mask,
                                                 obj_valid)
        # The JAX step builds `concat(bank, prev)` every frame; on the card
        # that copies the whole bank (~200 MB at bf16, 480p, S=32) per frame.
        # Here the bank holds capacity + 1 slots and prev goes into the last
        # (ephemeral) slot in place. The ring write is one slot per stream:
        # a stream that does not commit writes its slot's own content back.
        pos = (state.cursor % S).long()
        rows = torch.arange(B, device=pos.device)
        for buf, item in ((state.keys, prev_k), (state.values, prev_v),
                          (state.bboxes, prev_box)):
            keep = commit.view((B,) + (1,) * (item.ndim - 1))
            buf[rows, :, pos] = torch.where(keep, item, buf[rows, :, pos])
            buf[:, :, S] = item

        slot_valid = _slot_valid(S, state.cursor, commit)
        est_mask, exist = self._segment_frame(
            state.prev_mask, state.exist, frame, flow, gt_mask, any_new, obj_valid,
            state.keys, state.values, state.bboxes, slot_valid)
        new_state = dataclasses.replace(
            state,
            cursor=state.cursor + commit.to(torch.int32),
            prev_mask=est_mask.to(state.prev_mask.dtype),
            prev_frame=frame,
            exist=exist,
        )
        return new_state, est_mask

    def chunk_forward(self, flow_fn, state: VOSState, frames, gt_masks, any_new, commit,
                      step_valid, obj_valid, flows=None) -> torch.Tensor:
        """The steps of one chunk of frames (rmnet_tpu/models/rmnet.py:844-918)
        -> est (C, B, K, H, W).

        frames (C, B, 3, H, W); gt_masks (C, B, K, H, W) one-hot, read only
        where ``any_new``; any_new, commit, step_valid (C, B) bool, where
        commit[c] commits the frame before frames[c]; flows (C, B, 2, H, W),
        or None to take ``flow_fn(frame, prev_frame)`` from the carried
        previous frame. A step with ``step_valid`` False (padding past a
        stream's last frame) runs, but leaves that stream's state as it was.
        Every tensor of ``state`` is updated in place, so that the state can
        be a CUDA graph's static buffers.
        """
        ests = []
        for c in range(frames.shape[0]):
            frame, valid = frames[c], step_valid[c]
            flow = flow_fn(frame, state.prev_frame) if flows is None else flows[c]
            # a padded step commits nothing, so the bank and cursor stay put
            new, est = self.step(state, frame, flow, gt_masks[c], any_new[c],
                                 commit[c] & valid, obj_valid)
            v = valid[:, None, None, None]
            state.cursor.copy_(new.cursor)
            state.prev_mask.copy_(torch.where(v, new.prev_mask, state.prev_mask))
            state.prev_frame.copy_(torch.where(v, new.prev_frame, state.prev_frame))
            state.exist.copy_(torch.where(valid[:, None], new.exist, state.exist))
            ests.append(est)
        return torch.stack(ests)

    def _segment_frame(self, prev_mask, exist, frame, flow, gt_mask, any_new,
                       obj_valid, keys, values, bboxes, slot_valid):
        """Segment ``frame`` against the bank, inject new objects, suppress
        unrevealed ones -> (est_mask (B, K, H, W), exist)."""
        H, W = frame.shape[-2:]
        lw, uw, lh, uh = divide_pads(H, W, 16)
        out_hw = ((H + lh + uh) // 16, (W + lw + uw) // 16)
        att_small = self.get_att_small(prev_mask, flow, out_hw, (lh, lw))
        logit = self.segment(frame, att_small, keys, values, slot_valid, obj_valid,
                             mem_bboxes=bboxes)

        # new-object injection (models/rmnet.py:436-442), per stream
        newly = _present_objects(gt_mask) & ~exist & any_new[:, None]
        inj = gt_mask.to(logit.dtype) * NEW_OBJECT_SCALE + NEW_OBJECT_BIAS
        logit = torch.where(newly[:, :, None, None], inj, logit)
        exist = exist | newly
        # suppress objects not revealed yet (models/rmnet.py:444-448)
        logit = torch.where(exist[:, :, None, None], logit,
                            torch.full_like(logit, SUPPRESSED))
        return torch.softmax(logit, dim=1), exist

    def forward_video(self, frames, masks, flows, n_objects) -> torch.Tensor:
        """Whole-clip forward with backprop through time (training; the JAX
        package's forward_video, rmnet_tpu/models/rmnet.py:921-984).

        frames (B, T, H, W, 3), masks (B, T, K, H, W) one-hot, flows
        (B, T, H, W, 2) backward flows (flows[:, t] maps t -> t-1), n_objects
        (B, T) on the host -> est (B, T, K, H, W); frame 0's estimate is the
        ground truth. The bank has capacity max(T-1, 1), so it never evicts.
        Each frame's bank is built out of place (committed slots ++ prev),
        because the memory read saves it for the backward pass.
        """
        B, T, K, H, W = masks.shape
        n_objects = np.asarray(n_objects.cpu() if torch.is_tensor(n_objects) else n_objects)
        ks = torch.arange(K, device=masks.device)
        n_max = torch.as_tensor(n_objects.max(axis=1), device=masks.device)
        obj_valid = (ks[None] >= 1) & (ks[None] <= n_max[:, None])  # (B, K)

        # frame-level flags (reference models/rmnet.py:404-408)
        any_new = np.zeros((T,), bool)
        any_new[1:] = np.any(n_objects[:, 1:] != n_objects[:, :-1], axis=0)
        commit = np.array([t % self.memorize_every == 0 for t in range(T)]) | any_new

        capacity = max(T - 1, 1)
        frames_c = frames.permute(0, 1, 4, 2, 3)   # (B, T, 3, H, W)
        flows_c = flows.permute(0, 1, 4, 2, 3)     # (B, T, 2, H, W)
        prev_mask, prev_frame = masks[:, 0], frames_c[:, 0]
        exist = _present_objects(masks[:, 0])
        slots = [None] * capacity                  # committed (k, v, box) per slot
        cursor = 0
        est = [masks[:, 0]]

        def flag(value, dtype=torch.bool):  # one host flag for every stream
            return torch.full((B,), value, dtype=dtype, device=masks.device)

        for t in range(1, T):
            prev = self.memorize(prev_frame, prev_mask, obj_valid)
            write_pos = cursor % capacity
            if commit[t - 1]:
                slots[write_pos] = prev
            filled = [s if s is not None else tuple(torch.zeros_like(x) for x in prev)
                      for s in slots]
            keys, values, bboxes = (torch.stack([s[i] for s in filled] + [prev[i]], dim=2)
                                    for i in range(3))
            slot_valid = _slot_valid(capacity, flag(cursor, torch.int32),
                                     flag(bool(commit[t - 1])))
            est_t, exist = self._segment_frame(
                prev_mask, exist, frames_c[:, t], flows_c[:, t], masks[:, t],
                flag(bool(any_new[t])), obj_valid, keys, values, bboxes, slot_valid)
            est.append(est_t)
            cursor += int(commit[t - 1])
            prev_mask, prev_frame = est_t, frames_c[:, t]
        return torch.stack(est, dim=1)

    def init_state(self, frame0, masks0, capacity: int, dtype=torch.float32,
                   key_dim: int = 128, val_dim: int = 512) -> VOSState:
        """frame0 (B, 3, H, W), masks0 (B, K, H, W) one-hot -> a new state
        with an empty bank of ``capacity`` ring slots plus the ephemeral slot
        and a (B,) cursor (rmnet_tpu/models/rmnet.py:805-841)."""
        B, K, H, W = masks0.shape
        lw, uw, lh, uh = divide_pads(H, W, 16)
        h, w = (H + lh + uh) // 16, (W + lw + uw) // 16
        dev = masks0.device
        return VOSState(
            keys=torch.zeros(B, K, capacity + 1, h, w, key_dim, dtype=dtype, device=dev),
            values=torch.zeros(B, K, capacity + 1, h, w, val_dim, dtype=dtype, device=dev),
            bboxes=torch.zeros(B, K, capacity + 1, 4, dtype=torch.int32, device=dev),
            cursor=torch.zeros(B, dtype=torch.int32, device=dev),
            prev_mask=torch.empty(B, K, H, W, dtype=dtype, device=dev),
            prev_frame=torch.empty(frame0.shape, dtype=frame0.dtype, device=dev),
            exist=torch.empty(B, K, dtype=torch.bool, device=dev),
        ).reset_(frame0, masks0)
