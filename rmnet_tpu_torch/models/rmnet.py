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
    since the memory read saves the bank for its backward (and a
    rematerialised frame reads it again);
  * rematerialisation (training, ``torch.utils.checkpoint``, non-reentrant):
    ``remat_encoders`` recomputes the two ResNet-50 encoders in the backward
    pass, ``remat`` each whole frame of ``forward_video``
    (rmnet_tpu/models/rmnet.py:401-430, 958);
  * trainable BatchNorm (training, ``train_bn``): the encoders normalize
    with batch statistics, and their running statistics (a dict by
    state-dict name) go in and out of ``memorize``, ``segment`` and each
    frame of ``forward_video`` as values, the memory encoder's then the
    query encoder's per frame, as the JAX package threads its
    ``batch_stats`` (rmnet_tpu/models/rmnet.py:411-430, 921-984); nothing
    is written in place, so a rematerialised frame counts nothing twice.
    With a data-parallel ``mesh`` the statistics are the global batch's
    (one collective per BatchNorm call, repeated by a recompute on every
    rank alike). ``step`` is the serving step and never trains them;
  * width sharding (``space``, a width mesh of parallel/space.py, which
    ``spatial_forward_video`` and the hybrid grid's loss set):
    ``forward_video`` runs on the rank's columns of the padded frame. The
    encoders, heads and decoder exchange halos (their modules' ``space``);
    ``memorize`` gathers each frame's keys and values along the /16 width,
    so every rank's bank is the single forward's; the boxes are reduced over
    the ranks, so they are the whole frame's; the read takes the rank's
    query columns against the whole bank; each frame's estimate is gathered
    once, for the next frame's warp. Soft aggregation, injection,
    suppression and the softmax over K are per pixel. Every parameterised
    op runs on the rank's columns only, never on the gathered bank or
    estimate, so summing the parameters' gradients over the ranks counts
    each pixel once; the gathers' backward sums the ranks' partial
    gradients of the gathered copies (parallel/space.py).

Constants 32.0605 / -16.1181 (reference models/rmnet.py:442-448) equal
log(eps / (1 - eps)) for the aggregation clamp eps = 1e-7.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rmnet_tpu_torch.models.layers import (Conv2d, running_stats, set_compute_dtype,
                                          train_batch_norm)
from rmnet_tpu_torch.models.resnet import ResNet50Trunk
from rmnet_tpu_torch.ops.aggregation import soft_aggregation
from rmnet_tpu_torch.ops.att_map import (regional_attention_small,
                                         warped_regional_attention_small)
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read
from rmnet_tpu_torch.ops.pad import divide_pads, pad_divide_by, unpad
from rmnet_tpu_torch.ops.warp import backward_warp
from rmnet_tpu_torch.parallel.mesh import DataMesh
from rmnet_tpu_torch.parallel.space import WidthMesh
from rmnet_tpu_torch.utils.profiling import phase

NEW_OBJECT_SCALE = 32.0605
NEW_OBJECT_BIAS = -16.1181
SUPPRESSED = -16.1181


def _present_objects(one_hot: torch.Tensor, space: Optional[WidthMesh] = None) -> torch.Tensor:
    """(B, K) flags: which slots the argmax label map of (B, K, H, W) one-hot
    masks contains. Slot k >= 1 is present iff its channel fires anywhere;
    slot 0 wherever no k >= 1 channel fires. With ``space``, of the whole
    frame of which ``one_hot`` holds the rank's columns (MAX over ranks)."""
    fg = one_hot[:, 1:] >= 0.5
    present_fg = fg.flatten(2).any(dim=2)
    present_bg = (~fg.any(dim=1)).flatten(1).any(dim=1)
    present = torch.cat([present_bg[:, None], present_fg], dim=1)
    if space is not None:
        present = space.all_reduce(present.to(torch.int32), "max", "objects max") > 0
    return present


class ResBlock(nn.Module):
    """2x 3x3-conv residual block (reference models/rmnet.py:24-48)."""

    def __init__(self, indim: int, outdim: Optional[int] = None, stride: int = 1):
        super().__init__()
        outdim = outdim or indim
        self.downsample = None
        if indim != outdim or stride != 1:
            self.downsample = Conv2d(indim, outdim, 3, padding=1, stride=stride)
        self.conv1 = Conv2d(indim, outdim, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(outdim, outdim, 3, padding=1)

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class EncoderMemory(ResNet50Trunk):
    """ResNet-50 trunk + mask / other-mask stems (reference models/rmnet.py:51-80)."""

    def __init__(self):
        super().__init__()
        self.conv1_m = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.conv1_o = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)

    def forward(self, f, m, o):
        """f (B, 3, H, W); m, o (B, H, W) -> r4 (B, 1024, H/16, W/16)."""
        extra = self.conv1_m(m[:, None]) + self.conv1_o(o[:, None])
        return self.trunk(f, extra_stem=extra)[0]

    def shared(self, f, m_bk, o_bk):
        """Per-object encode with the three 7x7 stems merged into one
        5-channel conv: f (B, 3, H, W); m_bk, o_bk (B*Ko, H, W), object folded
        into the batch B-major. ``conv1(f) + conv1_m(m) + conv1_o(o)`` is one
        conv with the kernels concatenated on the input axis."""
        B = f.shape[0]
        Ko = m_bk.shape[0] // B
        dt = self.conv1.dtype
        f_bk = f.to(dt)[:, None].expand(B, Ko, *f.shape[1:]).reshape(B * Ko, *f.shape[1:])
        x5 = torch.cat([f_bk, m_bk[:, None].to(dt), o_bk[:, None].to(dt)], dim=1)
        w5 = torch.cat([self.conv1.weight, self.conv1_m.weight, self.conv1_o.weight], dim=1)
        if self.space is None:
            c1 = F.conv2d(x5, w5.to(dt), stride=2, padding=3)
        else:
            c1 = self.space.conv2d(x5, w5.to(dt), None, 2, 3)
        return self.trunk(None, conv1_out=c1)[0]


class EncoderQuery(ResNet50Trunk):
    """RGB-only ResNet-50 trunk (reference models/rmnet.py:83-104)."""

    def forward(self, f):
        r4, r3, r2, _ = self.trunk(f)
        return r4, r3, r2


class KeyValue(nn.Module):
    """Parallel 3x3 key/value heads (reference models/rmnet.py:168-176);
    under a width mesh both read one halo of ``x``."""

    space = None

    def __init__(self, indim: int = 1024, keydim: int = 128, valdim: int = 512):
        super().__init__()
        self.key_conv = Conv2d(indim, keydim, 3, padding=1)
        self.value_conv = Conv2d(indim, valdim, 3, padding=1)

    def forward(self, x):
        if self.space is None:
            return self.key_conv(x), self.value_conv(x)
        # both heads are 3x3, stride 1, padding 1: one halo serves them
        x = self.space.conv_halo(x.to(self.key_conv.dtype), 3, 1, 1)
        return tuple(self.space.conv_extended(x, c.weight.to(c.dtype), None if c.bias is None
                                              else c.bias.to(c.dtype), 1, 1)
                     for c in (self.key_conv, self.value_conv))


class Refine(nn.Module):
    """Decoder refinement block (reference models/rmnet.py:107-120)."""

    space = None

    def __init__(self, inplanes: int, planes: int, scale_factor: int = 2):
        super().__init__()
        self.convFS = Conv2d(inplanes, planes, 3, padding=1)
        self.ResFS = ResBlock(planes)
        self.ResMM = ResBlock(planes)
        self.scale_factor = scale_factor

    def skip(self, f):
        """Skip branch: depends only on the frame's encoder feature, so the
        caller computes it once per frame and shares it across objects."""
        return self.ResFS(self.convFS(f))

    def fuse(self, s, pm):
        if self.space is not None:
            return self.ResMM(s + self.space.upsample(pm, self.scale_factor))
        up = F.interpolate(pm, size=(pm.shape[-2] * self.scale_factor,
                                     pm.shape[-1] * self.scale_factor),
                           mode="bilinear", align_corners=False)
        return self.ResMM(s + up)

    def forward(self, f, pm):
        return self.fuse(self.skip(f), pm)


class Decoder(nn.Module):
    """1024 -> 2-logit decoder with skip refinement (reference models/rmnet.py:123-140)."""

    space = None

    def __init__(self, mdim: int = 256):
        super().__init__()
        self.convFM = Conv2d(1024, mdim, 3, padding=1)
        self.ResMM = ResBlock(mdim)
        self.RF3 = Refine(512, mdim)
        self.RF2 = Refine(256, mdim)
        self.pred2 = Conv2d(mdim, 2, 3, padding=1)

    def skips(self, r3, r2):
        """Per-frame skip features (the object-independent half)."""
        return self.RF3.skip(r3), self.RF2.skip(r2)

    def from_skips(self, r4, s3, s2):
        """Per-object half: r4 is the memory-read output, s3/s2 precomputed."""
        m4 = self.ResMM(self.convFM(r4))
        m3 = self.RF3.fuse(s3, m4)
        m2 = self.RF2.fuse(s2, m3)
        p2 = self.pred2(F.relu(m2))
        if self.space is not None:
            return self.space.upsample(p2, 4)
        return F.interpolate(p2, size=(p2.shape[-2] * 4, p2.shape[-1] * 4),
                             mode="bilinear", align_corners=False)

    def forward(self, r4, r3, r2):
        s3, s2 = self.skips(r3, r2)
        return self.from_skips(r4, s3, s2)


def _dense_read(m_key, m_val, q_key, slot_valid):
    """Dense memory read -> (mem (N, h, w_q, Cv), p (N, S*h*w, h*w_q)) for a
    query q_key (N, h, w_q, Ck): the bank's columns, or a rank's under a
    width mesh.

    Scores and softmax in float32 (or the inputs' type where it is wider);
    invalid slots get -inf."""
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    ft = torch.promote_types(q_key.dtype, torch.float32)
    mk = m_key.reshape(N, S * hw, Ck).to(ft)
    qk = q_key.reshape(N, h * q_key.shape[2], Ck).to(ft)
    scores = torch.bmm(mk, qk.transpose(1, 2)) / math.sqrt(Ck)  # (N, M, Q)
    valid = slot_valid[:, :, None].expand(N, S, hw).reshape(N, S * hw)
    scores = scores.masked_fill(~valid[..., None], -math.inf)
    p = torch.softmax(scores, dim=1)
    mv = m_val.reshape(N, S * hw, Cv)
    mem = torch.bmm(p.transpose(1, 2).to(mv.dtype), mv)  # (N, Q, Cv)
    return mem.reshape(q_key.shape[:3] + (Cv,)), p


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
    """Container of the RMNet sub-networks (reference state-dict names);
    ``dtype`` is every conv's compute dtype (None: the weights')."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder_memory = EncoderMemory()
        self.encoder_query = EncoderQuery()
        self.kv_memory = KeyValue(1024, 128, 512)
        self.kv_query = KeyValue(1024, 128, 512)
        self.decoder = Decoder(256)
        set_compute_dtype(self, dtype)


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
    # training: keep only what a frame carries to the next and recompute each
    # frame's activations in the backward pass (TRAIN.REMAT = "step")
    remat: bool = False
    # training: recompute only the two encoders' interiors in the backward
    # pass, most of the saved activations (TRAIN.REMAT = "encoders")
    remat_encoders: bool = False
    # training: BatchNorm on batch statistics, the running statistics
    # threaded through forward_video (TRAIN.USE_BATCH_NORM)
    train_bn: bool = False
    # training under TRAIN.DATA_PARALLEL or on a hybrid grid: the mesh whose
    # ranks' batch gives trainable BatchNorm its statistics (the grid's world)
    mesh: Optional[DataMesh] = None
    # width sharding (spatial_forward_video, the hybrid grid): the rank's
    # width mesh
    space: Optional[WidthMesh] = None

    def running_stats(self):
        """The encoders' running BatchNorm statistics by state-dict name
        (the module's buffers)."""
        return {**running_stats(self.model.encoder_memory, "encoder_memory."),
                **running_stats(self.model.encoder_query, "encoder_query.")}

    def load_running_stats(self, bn) -> None:
        """Copy ``bn`` (as :meth:`running_stats` names them) into the
        module's buffers."""
        with torch.no_grad():
            for name, buf in self.running_stats().items():
                buf.copy_(bn[name])

    def _encoder(self, name, method, bn, *args):
        """``method`` of encoder ``name`` on ``args`` -> (its output, bn):
        with ``bn`` (running statistics), BatchNorm on batch statistics and
        ``bn`` with this encoder's updated; rematerialised under
        ``remat_encoders``."""
        encoder = getattr(self.model, name)
        fn = getattr(encoder, method)
        if bn is not None:
            fn = functools.partial(train_batch_norm, encoder, name + ".", bn, fn,
                                   mesh=self.mesh)
        if self.remat_encoders and torch.is_grad_enabled():
            if self.space is not None:  # the recompute runs after forward_video's install
                fn = self.space.within(encoder, fn)
            out = checkpoint(fn, *args, use_reentrant=False)
        else:
            out = fn(*args)
        return out if bn is not None else (out, None)

    def _att(self, mask, out_hw, offset, padded=False):
        """The box map of ``mask`` on the /16 grid and the boxes; under a
        width mesh, of the rank's columns of a mask in ``padded`` (or frame)
        coordinates."""
        shard = None if self.space is None else self.space.box_shard(padded)
        return regional_attention_small(
            mask, out_hw, offset, 16,
            self.prob_threshold, self.n_pts_threshold, self.n_bbox_loose_pixels, shard,
        )

    def _pad(self, x):
        """``x`` (..., H, W) zero-padded to multiples of 16 -> (the padded
        tensor, or under a width mesh the rank's columns of it; the pads)."""
        (x_p,), pads = pad_divide_by([x], 16, spatial_axes=(-2, -1))
        return (x_p, pads) if self.space is None else (self.space.padded_slice(x_p), pads)

    def memorize(self, frame, masks, obj_valid, bn=None):
        """Encode one frame into per-object regional keys/values.

        frame (B, 3, H, W), masks (B, K, H, W), obj_valid (B, K) bool ->
        (k4 (B, K, h, w, Ck), v4 (B, K, h, w, Cv), bboxes (B, K, 4) int32,
        bn), channels last; slot 0 and invalid objects are zero. ``bn``:
        running statistics, the memory encoder's updated (None: frozen).
        """
        B, K = masks.shape[:2]
        frame_p, _ = self._pad(frame)
        masks_p, _ = self._pad(masks)
        Hp, Wp = masks_p.shape[-2:]
        v = obj_valid.to(masks_p.dtype)[:, :, None, None]
        masks_v = masks_p * v
        others = (masks_v.sum(dim=1, keepdim=True) - masks_v).clamp(0.0, 1.0)

        # only the K-1 object slots are encoded; the RGB stem is shared
        Ko = K - 1
        m = self.model
        r4, bn = self._encoder("encoder_memory", "shared", bn, frame_p,
                               masks_p[:, 1:].reshape(B * Ko, Hp, Wp),
                               others[:, 1:].reshape(B * Ko, Hp, Wp))
        k4, v4 = m.kv_memory(r4)
        h, w = k4.shape[-2:]
        att, bboxes = self._att(masks_p, (h, w), (0, 0), padded=True)
        # zero slot 0 and invalid objects, mask by the /16 regional map
        keep = (att * v)[:, 1:].to(k4.dtype)[..., None]  # (B, Ko, h, w, 1)
        if self.space is None:
            k_obj = k4.permute(0, 2, 3, 1).reshape(B, Ko, h, w, k4.shape[1]) * keep
            v_obj = v4.permute(0, 2, 3, 1).reshape(B, Ko, h, w, v4.shape[1]) * keep
        else:  # the whole /16 width on every rank: one gather of both
            C = k4.shape[1] + v4.shape[1]
            kv = torch.cat([k4, v4], dim=1).reshape(B, Ko, C, h, w) * keep[..., 0][:, :, None]
            kv = self.space.gather_grid(kv, "gather bank").permute(0, 1, 3, 4, 2)
            k_obj, v_obj = kv[..., :k4.shape[1]], kv[..., k4.shape[1]:]
        pad = (0, 0, 0, 0, 0, 0, 1, 0)
        return F.pad(k_obj, pad), F.pad(v_obj, pad), bboxes, bn

    def get_att_small(self, prev_mask, flow, out_hw, offset):
        """Warp the previous mask by ``flow`` (B, 2, H, W) and rasterize its
        dilated boxes on the /16 query grid -> (B, K, h, w).

        With autograd on (training) all K channels are warped through the
        fused op, whose gradient is the channel-uniform splat of the map's
        constant-ones gradient: that constant only cancels through the
        estimate's softmax when every channel gets it (rmnet_tpu/models/
        rmnet.py:504-509). Otherwise the background channel is not warped:
        slot 0 never reaches the box op, so the map is the same.

        Under a width mesh ``prev_mask`` is the whole frame's, ``flow`` and
        the map the rank's columns; the training warp's gradient is then the
        splat of the rank's own output columns onto the whole frame, which
        the estimate's gather sums over the ranks."""
        shard = None if self.space is None else self.space.box_shard(padded=False)
        if flow is None:
            expt = prev_mask if self.space is None else self.space.unpadded_slice(prev_mask)
        elif torch.is_grad_enabled():
            return warped_regional_attention_small(
                prev_mask, flow.permute(0, 2, 3, 1), out_hw, offset, 16,
                self.prob_threshold, self.n_pts_threshold, self.n_bbox_loose_pixels, shard)
        else:
            warped, _ = backward_warp(prev_mask[:, 1:].permute(0, 2, 3, 1),
                                      flow.permute(0, 2, 3, 1), 0 if shard is None else shard.x0)
            expt = F.pad(warped.permute(0, 3, 1, 2), (0, 0, 0, 0, 1, 0))
        return self._att(expt, out_hw, offset)[0]

    def segment(self, frame, att_small, mem_keys, mem_values, slot_valid,
                obj_valid, mem_bboxes=None, bn=None, phases=False):
        """One segmentation pass -> ((B, K, H, W) float32 logits, bn)
        (reference models/rmnet.py:304-383).

        frame (B, 3, H, W); att_small (B, K, h, w); mem_keys/values
        (B, K, S, h, w, C); slot_valid (B, S) bool, per stream; mem_bboxes
        (B, K, S, 4), needed by the flash read; ``bn``: running statistics,
        the query encoder's updated (None: frozen). ``phases``: stamp the
        device phases ``query`` (up to the read) and ``read``.
        """
        B, K, S = mem_keys.shape[:3]
        frame_p, pads = self._pad(frame)
        Hp, Wp = frame_p.shape[-2:]
        m = self.model
        (r4, r3, r2), bn = self._encoder("encoder_query", "forward", bn, frame_p)
        k4, v4 = m.kv_query(r4)
        h, w = k4.shape[-2:]

        Ko = K - 1
        N = B * Ko
        att = att_small[:, 1:].to(k4.dtype)[:, :, None]          # (B, Ko, 1, h, w)
        q_key = (k4[:, None] * att).permute(0, 1, 3, 4, 2).reshape(N, h, w, k4.shape[1])
        q_val = (v4[:, None] * att).reshape(N, v4.shape[1], h, w)
        valid = slot_valid[:, None].expand(B, Ko, S).reshape(N, S)
        # views of the bank (a copy only when B > 1); under a width mesh the
        # bank holds the whole /16 width and the query the rank's columns
        mk = mem_keys[:, 1:].reshape(N, S, *mem_keys.shape[3:])
        mv = mem_values[:, 1:].reshape(N, S, *mem_values.shape[3:])
        if phases:
            phase("query", frame.device)
        if self.use_flash_attention:
            boxes = mem_bboxes[:, 1:].reshape(N, S, 4)
            mem, _ = flash_memory_read(mk, mv, q_key.contiguous(), valid, boxes)
        else:
            mem, _ = _dense_read(mk, mv, q_key, valid)
        if phases:
            phase("read", frame.device)
        m4 = torch.cat([mem.to(q_val.dtype).permute(0, 3, 1, 2), q_val], dim=1)

        # skip branches once per frame, shared across objects
        s3, s2 = m.decoder.skips(r3, r2)
        s3 = s3[:, None].expand(B, Ko, *s3.shape[1:]).reshape(N, *s3.shape[1:])
        s2 = s2[:, None].expand(B, Ko, *s2.shape[1:]).reshape(N, *s2.shape[1:])
        logits2 = m.decoder.from_skips(m4, s3, s2)               # (N, 2, Hp, Wp)
        ps = torch.softmax(logits2, dim=1)[:, 1].reshape(B, Ko, Hp, Wp)
        ps = F.pad(ps, (0, 0, 0, 0, 1, 0))
        logit = soft_aggregation(ps, obj_valid)
        if self.space is not None:
            pads = self.space.own_pads(pads)
        return unpad(logit, pads, spatial_axes=(-2, -1)), bn

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
        back to the host. Stamps the device phases ``memorize`` (with the
        ring write), ``query`` and ``read`` of :meth:`chunk_forward`.
        """
        B = frame.shape[0]
        S = state.capacity
        prev_k, prev_v, prev_box, _ = self.memorize(state.prev_frame, state.prev_mask,
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
        phase("memorize", frame.device)

        slot_valid = _slot_valid(S, state.cursor, commit)
        est_mask, exist, _ = self._segment_frame(
            state.prev_mask, state.exist, frame, flow, gt_mask, any_new, obj_valid,
            state.keys, state.values, state.bboxes, slot_valid, phases=True)
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

        With the profiling recorder on, each step stamps contiguous device
        phases (utils/profiling.py ``phase``): ``flow`` | ``memorize`` (with
        the ring write) | ``query`` (query trunk, key/value heads, regional
        attention map) | ``read`` | ``decode`` (skips, decoder, softmax,
        aggregation, unpad, the state's carry), which add up to the step.
        """
        ests = []
        phase(None, frames.device)
        for c in range(frames.shape[0]):
            frame, valid = frames[c], step_valid[c]
            flow = flow_fn(frame, state.prev_frame) if flows is None else flows[c]
            phase("flow", frame.device)
            # a padded step commits nothing, so the bank and cursor stay put
            new, est = self.step(state, frame, flow, gt_masks[c], any_new[c],
                                 commit[c] & valid, obj_valid)
            v = valid[:, None, None, None]
            state.cursor.copy_(new.cursor)
            state.prev_mask.copy_(torch.where(v, new.prev_mask, state.prev_mask))
            state.prev_frame.copy_(torch.where(v, new.prev_frame, state.prev_frame))
            state.exist.copy_(torch.where(valid[:, None], new.exist, state.exist))
            phase("decode", frame.device)
            ests.append(est)
        return torch.stack(ests)

    def _segment_frame(self, prev_mask, exist, frame, flow, gt_mask, any_new,
                       obj_valid, keys, values, bboxes, slot_valid, bn=None, phases=False):
        """Segment ``frame`` against the bank, inject new objects, suppress
        unrevealed ones -> (est_mask (B, K, H, W), exist, bn). Under a width
        mesh ``flow``, ``gt_mask`` and the estimate hold the rank's columns.
        ``phases``: :meth:`segment`'s."""
        H, W = frame.shape[-2:]
        lw, uw, lh, uh = divide_pads(H, W, 16)
        out_hw = ((H + lh + uh) // 16, (W + lw + uw) // 16)
        if self.space is not None:
            lo, hi = self.space.grid[self.space.rank]
            out_hw = (out_hw[0], hi - lo)
        att_small = self.get_att_small(prev_mask, flow, out_hw, (lh, lw))
        logit, bn = self.segment(frame, att_small, keys, values, slot_valid, obj_valid,
                                 mem_bboxes=bboxes, bn=bn, phases=phases)

        # new-object injection (models/rmnet.py:436-442), per stream
        newly = _present_objects(gt_mask, self.space) & ~exist & any_new[:, None]
        inj = gt_mask.to(logit.dtype) * NEW_OBJECT_SCALE + NEW_OBJECT_BIAS
        logit = torch.where(newly[:, :, None, None], inj, logit)
        exist = exist | newly
        # suppress objects not revealed yet (models/rmnet.py:444-448)
        logit = torch.where(exist[:, :, None, None], logit,
                            torch.full_like(logit, SUPPRESSED))
        return torch.softmax(logit, dim=1), exist, bn

    def forward_video(self, frames, masks, flows, n_objects, bn=None, gathered=False):
        """Whole-clip forward with backprop through time (training; the JAX
        package's forward_video, rmnet_tpu/models/rmnet.py:921-984).

        frames (B, T, H, W, 3), masks (B, T, K, H, W) one-hot, flows
        (B, T, H, W, 2) backward flows (flows[:, t] maps t -> t-1), n_objects
        (B, T) on the host -> est (B, T, K, H, W); frame 0's estimate is the
        ground truth. The bank has capacity max(T-1, 1), so it never evicts.
        Each frame's bank is built out of place (committed slots ++ prev),
        because the memory read saves it for the backward pass. With
        ``train_bn`` -> (est, the running statistics after the clip),
        starting from ``bn`` (default: the module's own).

        Under a width mesh the inputs are the rank's rows at the whole width,
        of which each frame runs on the rank's columns; each frame's
        estimate is gathered whole for the next frame (its gradient summed
        over the ranks), and est holds the rank's columns of the frame, W =
        its share, or with ``gathered`` the whole clip as gathered.
        """
        if self.space is None:
            return self._forward_video(frames, masks, flows, n_objects, bn, gathered)
        with self.space.installed(self.model):
            return self._forward_video(frames, masks, flows, n_objects, bn, gathered)

    def _forward_video(self, frames, masks, flows, n_objects, bn, gathered):
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
        # what a frame reads per pixel: the rank's columns under a width mesh
        own = (lambda x: x) if self.space is None else self.space.unpadded_slice
        exist = _present_objects(own(masks[:, 0]), self.space)
        slots = [None] * capacity                  # committed (k, v, box) per slot
        cursor = 0
        est, whole = [own(masks[:, 0])], [masks[:, 0]]

        def flag(value, dtype=torch.bool):  # one host flag for every stream
            return torch.full((B,), value, dtype=dtype, device=masks.device)

        def frame_step(t, cursor, filled, prev_frame, prev_mask, exist, bn, *committed):
            """Frame t from what frame t-1 carries -> (est_t, the whole
            frame's est_t, exist, bn, k, v, box), the last three frame t-1's
            memory. ``filled`` flags the ring slots that ``committed`` holds,
            as (k, v, box) in slot order; when frame t-1 is committed, its
            memory takes slot ``cursor % capacity``. Everything it reads
            comes in as an argument, so that a rematerialised frame
            recomputes the same."""
            write = cursor % capacity if commit[t - 1] else -1
            *prev, bn = self.memorize(prev_frame, prev_mask, obj_valid, bn)
            it = iter(committed)
            bank = [prev if i == write else
                    (next(it), next(it), next(it)) if filled[i] else
                    tuple(torch.zeros_like(x) for x in prev) for i in range(capacity)]
            keys, values, bboxes = (torch.stack([s[i] for s in bank] + [prev[i]], dim=2)
                                    for i in range(3))
            slot_valid = _slot_valid(capacity, flag(cursor, torch.int32),
                                     flag(bool(commit[t - 1])))
            est_t, exist, bn = self._segment_frame(
                prev_mask, exist, frames_c[:, t], own(flows_c[:, t]), own(masks[:, t]),
                flag(bool(any_new[t])), obj_valid, keys, values, bboxes, slot_valid, bn)
            whole_t = est_t
            if self.space is not None:  # the last frame's only for a gathered result
                whole_t = (self.space.gather_unpadded(est_t, "gather estimate")
                           if t < T - 1 or gathered else None)
            return (est_t, whole_t, exist, bn, *prev)

        if self.train_bn and bn is None:
            bn = self.running_stats()
        if self.remat and torch.is_grad_enabled() and self.space is not None:
            step_fn = self.space.within(self.model, frame_step)
        else:
            step_fn = frame_step
        for t in range(1, T):
            write = cursor % capacity if commit[t - 1] else -1
            filled = tuple(s is not None and i != write for i, s in enumerate(slots))
            committed = [x for i, s in enumerate(slots) if filled[i] for x in s]
            args = (t, cursor, filled, prev_frame, prev_mask, exist, bn, *committed)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(step_fn, *args, use_reentrant=False)
            else:
                out = step_fn(*args)
            est_t, whole_t, exist, bn, prev = out[0], out[1], out[2], out[3], out[4:]
            if commit[t - 1]:
                slots[write] = prev
            est.append(est_t)
            whole.append(whole_t)
            cursor += int(commit[t - 1])
            prev_mask, prev_frame = whole_t, frames_c[:, t]
        est = torch.stack(whole if gathered else est, dim=1)
        return (est, bn) if self.train_bn else est

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
