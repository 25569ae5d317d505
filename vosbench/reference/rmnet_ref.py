"""Plain-PyTorch reference of RMNet and TinyFlowNet, the yardstick that
decides ``correct``.

A frozen copy of the repository's torch spec of the published network
(tests/torch_ref.py: hzxie/RMNet models/rmnet.py, models/tiny_flownet.py and
extensions/reg_att_map_generator), with three changes that leave its
mathematics as it was:

  * every tensor it makes lives on the device of its inputs;
  * each convolution and the memory read's two products can round their
    operands through a quantiser (``set_quant``), which the lower-precision
    control uses; by default they do not;
  * ``infer`` runs the per-frame loop of ``RMNet.forward`` with TinyFlowNet's
    flows computed in it (the served path), under ``torch.no_grad``, and
    ``train_loss`` is the reference objective (Lovasz + NLL on frames 1..T-1,
    core/train.py).

The memory read is dense over the whole grown bank (``torch.cat``), the box
op runs the reference kernel's semantics in numpy. It imports neither JAX
nor anything of the program under test.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose operands go through ``quant`` when one is set."""

    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        return self._conv_forward(self.quant(x), self.quant(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d whose operands go through ``quant`` when one is set."""

    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight), self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def set_quant(model: nn.Module, quant) -> nn.Module:
    """Route every convolution's operands (and the memory read's) through
    ``quant`` (None: exact)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, RMNetT)):
            m.quant = quant
    return model


@contextlib.contextmanager
def computed_in(quant, *models):
    """``models`` with ``quant`` on their operands (set_quant) for the block."""
    for m in models:
        set_quant(m, quant)
    try:
        yield
    finally:
        for m in models:
            set_quant(m, None)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448, e4m3's largest), in ``x``'s type: the
    precision below bfloat16 that the control computes in."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bfloat16, in ``x``'s type."""
    return x.to(torch.bfloat16).to(x.dtype)


def _q(quant, x):
    return x if quant is None else quant(x)


# ----------------------------------------------------------- resnet trunk
class BottleneckT(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + idn)


def _layer(cin, planes, blocks, stride):
    mods = [BottleneckT(cin, planes, stride)]
    for _ in range(blocks - 1):
        mods.append(BottleneckT(planes * 4, planes, 1))
    return nn.Sequential(*mods)


class TrunkT(nn.Module):
    """conv1..layer3 of ResNet-50 with reference encoder naming (res2..res4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.res2 = _layer(64, 64, 3, 1)
        self.res3 = _layer(256, 128, 4, 2)
        self.res4 = _layer(512, 256, 6, 2)


class EncoderMemoryT(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1_m = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        self.conv1_o = Conv2d(1, 64, 7, stride=2, padding=3, bias=False)
        t = TrunkT()
        self.conv1, self.bn1, self.maxpool = t.conv1, t.bn1, t.maxpool
        self.res2, self.res3, self.res4 = t.res2, t.res3, t.res4

    def forward(self, f, m, o):
        m = m.unsqueeze(1).float()
        o = o.unsqueeze(1).float()
        x = self.conv1(f) + self.conv1_m(m) + self.conv1_o(o)
        c1 = F.relu(self.bn1(x))
        x = self.maxpool(c1)
        r2 = self.res2(x)
        r3 = self.res3(r2)
        r4 = self.res4(r3)
        return r4, r3, r2, c1, f


class EncoderQueryT(nn.Module):
    def __init__(self):
        super().__init__()
        t = TrunkT()
        self.conv1, self.bn1, self.maxpool = t.conv1, t.bn1, t.maxpool
        self.res2, self.res3, self.res4 = t.res2, t.res3, t.res4

    def forward(self, f):
        x = self.conv1(f)
        c1 = F.relu(self.bn1(x))
        x = self.maxpool(c1)
        r2 = self.res2(x)
        r3 = self.res3(r2)
        r4 = self.res4(r3)
        return r4, r3, r2, c1, f


# ------------------------------------------------------------ heads/decoder
class ResBlockT(nn.Module):
    def __init__(self, indim, outdim=None, stride=1):
        super().__init__()
        outdim = outdim or indim
        self.downsample = (None if (indim == outdim and stride == 1)
                           else Conv2d(indim, outdim, 3, padding=1, stride=stride))
        self.conv1 = Conv2d(indim, outdim, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(outdim, outdim, 3, padding=1)

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class RefineT(nn.Module):
    def __init__(self, inplanes, planes):
        super().__init__()
        self.convFS = Conv2d(inplanes, planes, 3, padding=1)
        self.ResFS = ResBlockT(planes)
        self.ResMM = ResBlockT(planes)

    def forward(self, f, pm):
        s = self.ResFS(self.convFS(f))
        m = s + F.interpolate(pm, scale_factor=2, mode="bilinear", align_corners=False)
        return self.ResMM(m)


class DecoderT(nn.Module):
    def __init__(self, mdim=256):
        super().__init__()
        self.convFM = Conv2d(1024, mdim, 3, padding=1)
        self.ResMM = ResBlockT(mdim)
        self.RF3 = RefineT(512, mdim)
        self.RF2 = RefineT(256, mdim)
        self.pred2 = Conv2d(mdim, 2, 3, padding=1)

    def forward(self, r4, r3, r2):
        m4 = self.ResMM(self.convFM(r4))
        m3 = self.RF3(r3, m4)
        m2 = self.RF2(r2, m3)
        p2 = self.pred2(F.relu(m2))
        return F.interpolate(p2, scale_factor=4, mode="bilinear", align_corners=False)


class KeyValueT(nn.Module):
    def __init__(self, indim=1024, keydim=128, valdim=512):
        super().__init__()
        self.key_conv = Conv2d(indim, keydim, 3, padding=1)
        self.value_conv = Conv2d(indim, valdim, 3, padding=1)

    def forward(self, x):
        return self.key_conv(x), self.value_conv(x)


def memory_read_t(m_key, m_val, q_key, q_val, quant=None):
    """Reference MemoryReader math (models/rmnet.py:143-165), dense."""
    B, D_e, T, H, W = m_key.size()
    D_o = m_val.size(1)
    mi = m_key.view(B, D_e, T * H * W).transpose(1, 2)
    qi = q_key.view(B, D_e, H * W)
    p = torch.softmax(torch.bmm(_q(quant, mi), _q(quant, qi)) / math.sqrt(D_e), dim=1)
    mem = torch.bmm(_q(quant, m_val.view(B, D_o, T * H * W)), _q(quant, p)).view(B, D_o, H, W)
    return torch.cat([mem, q_val], dim=1), p


# ------------------------------------------------------------- tinyflownet
class TinyFlowNetT(nn.Module):
    def __init__(self):
        super().__init__()
        lk = lambda: nn.LeakyReLU(0.1)  # noqa: E731
        self.conv1 = nn.Sequential(Conv2d(6, 64, 7, 2, 3), lk())
        self.conv2 = nn.Sequential(Conv2d(64, 128, 5, 2, 2), lk())
        self.conv3 = nn.Sequential(Conv2d(128, 256, 5, 2, 2), lk())
        self.conv3_1 = nn.Sequential(Conv2d(256, 256, 3, 1, 1), lk())
        self.conv4 = nn.Sequential(Conv2d(256, 512, 3, 2, 1), lk())
        self.conv4_1 = nn.Sequential(Conv2d(512, 512, 3, 1, 1), lk())
        self.conv5 = nn.Sequential(Conv2d(512, 512, 3, 2, 1), lk())
        self.conv5_1 = nn.Sequential(Conv2d(512, 512, 3, 1, 1), lk())
        self.deconv4 = nn.Sequential(ConvTranspose2d(512, 256, 4, 2, 1), lk())
        self.deconv3 = nn.Sequential(ConvTranspose2d(770, 128, 4, 2, 1), lk())
        self.deconv2 = nn.Sequential(ConvTranspose2d(386, 64, 4, 2, 1), lk())
        self.predict_flow5 = Conv2d(512, 2, 3, 1, 1)
        self.predict_flow4 = Conv2d(770, 2, 3, 1, 1)
        self.predict_flow3 = Conv2d(386, 2, 3, 1, 1)
        self.predict_flow2 = Conv2d(194, 2, 3, 1, 1)
        self.upsampled_flow5_to_4 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)
        self.upsampled_flow4_to_3 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)
        self.upsampled_flow3_to_2 = ConvTranspose2d(2, 2, 4, 2, 1, bias=False)

    def pair(self, img0, img1):
        """Flow img0 -> img1 (the backward flow of frame t when img0 is frame
        t and img1 frame t-1)."""
        (img0, img1), pad = pad_divide_by_t([img0, img1], 64, img0.shape[2:])
        img0 = F.interpolate(img0, scale_factor=0.5, mode="bilinear", align_corners=False)
        img1 = F.interpolate(img1, scale_factor=0.5, mode="bilinear", align_corners=False)
        out_conv2 = self.conv2(self.conv1(torch.cat((img0, img1), dim=1)))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        flow5 = self.predict_flow5(out_conv5)
        concat4 = torch.cat(
            (out_conv4, self.deconv4(out_conv5), self.upsampled_flow5_to_4(flow5)), 1)
        flow4 = self.predict_flow4(concat4)
        concat3 = torch.cat(
            (out_conv3, self.deconv3(concat4), self.upsampled_flow4_to_3(flow4)), 1)
        flow3 = self.predict_flow3(concat3)
        concat2 = torch.cat(
            (out_conv2, self.deconv2(concat3), self.upsampled_flow3_to_2(flow3)), 1)
        flow2 = self.predict_flow2(concat2)
        flow2 = F.interpolate(flow2, scale_factor=8, mode="bilinear", align_corners=False)
        if pad[2] + pad[3] > 0:
            flow2 = flow2[:, :, pad[2]:-pad[3], :]
        if pad[0] + pad[1] > 0:
            flow2 = flow2[:, :, :, pad[0]:-pad[1]]
        return flow2


# --------------------------------------------------------------- utilities
def pad_divide_by_t(in_list, d, in_size):
    h, w = in_size
    new_h = h + d - h % d if h % d > 0 else h
    new_w = w + d - w % d if w % d > 0 else w
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    pad = (lw, uw, lh, uh)
    return [F.pad(x, pad) for x in in_list], pad


def reg_att_map_t(mask, prob_threshold=0.5, n_pts_threshold=10, loose=64):
    """Numpy semantics of the reference CUDA op, torch in/out (on the
    mask's device)."""
    m = mask.detach().float().cpu().numpy()
    B, K, H, W = m.shape
    att = np.zeros_like(m, dtype=np.float32)
    box = np.zeros((B, K, 4), np.int32)
    for b in range(B):
        for k in range(1, K):
            ys, xs = np.where(m[b, k] >= prob_threshold)
            if len(xs) < n_pts_threshold:
                x0, x1, y0, y1 = 0, W - 1, 0, H - 1
            else:
                x0 = max(xs.min() - loose, 0)
                x1 = min(xs.max() + loose, W - 1)
                y0 = max(ys.min() - loose, 0)
                y1 = min(ys.max() + loose, H - 1)
            box[b, k] = (x0, x1, y0, y1)
            att[b, k, y0:y1 + 1, x0:x1 + 1] = 1
    return (torch.from_numpy(att).to(mask.device), torch.from_numpy(box).to(mask.device))


class _RegAttMapST(torch.autograd.Function):
    """Straight-through wrapper of the box op: backward returns constant ones
    to the mask, whatever the upstream gradient (reference
    extensions/reg_att_map_generator/__init__.py:14-24)."""

    @staticmethod
    def forward(ctx, mask, prob_threshold, n_pts_threshold, loose):
        att, box = reg_att_map_t(mask, prob_threshold, n_pts_threshold, loose)
        ctx.mark_non_differentiable(box)
        return att, box

    @staticmethod
    def backward(ctx, grad_att_map, grad_bbox):
        return torch.ones_like(grad_att_map), None, None, None


def reg_att_map_st(mask, prob_threshold=0.5, n_pts_threshold=10, loose=64):
    return _RegAttMapST.apply(mask, prob_threshold, n_pts_threshold, loose)


def warp_t(img0, flow):
    B, C, H, W = img0.size()
    dev = img0.device
    xg = torch.arange(0, W, device=dev).view(1, -1).repeat(H, 1)
    yg = torch.arange(0, H, device=dev).view(-1, 1).repeat(1, W)
    grid = torch.cat(
        (xg.view(1, 1, H, W).repeat(B, 1, 1, 1), yg.view(1, 1, H, W).repeat(B, 1, 1, 1)), 1
    ).float()
    vgrid = grid + flow
    vgrid[:, 0] = 2.0 * vgrid[:, 0].clone() / max(W - 1, 1) - 1.0
    vgrid[:, 1] = 2.0 * vgrid[:, 1].clone() / max(H - 1, 1) - 1.0
    vgrid = vgrid.permute(0, 2, 3, 1)
    img1 = F.grid_sample(img0.clone(), vgrid, align_corners=True)
    mask = F.grid_sample(torch.ones(img0.size(), device=dev), vgrid, align_corners=True)
    mask[mask < 0.9999] = 0
    mask[mask > 0] = 1
    return img1 * mask, mask


# -------------------------------------------------------------- full RMNet
class RMNetT(nn.Module):
    """The reference per-frame loop (models/rmnet.py:179-452)."""

    quant = None

    def __init__(self, n_bbox_loose_pixels=64, n_pts_threshold=10, prob_threshold=0.5):
        super().__init__()
        self.encoder_memory = EncoderMemoryT()
        self.encoder_query = EncoderQueryT()
        self.kv_memory = KeyValueT()
        self.kv_query = KeyValueT()
        self.decoder = DecoderT(256)
        self.loose = n_bbox_loose_pixels
        self.n_pts = n_pts_threshold
        self.threshold = prob_threshold

    def _att(self, mask):
        return reg_att_map_st(mask, self.threshold, self.n_pts, self.loose)

    def pad_memory(self, mems, n_objects, K):
        pad_mems = []
        B = len(n_objects)
        for mem in mems:
            _, C, H, W = mem.size()
            pm = torch.zeros(B, K, C, 1, H, W, device=mem.device)
            for i in range(B):
                begin = sum(n_objects[:i])
                pm[i, 1:n_objects[i] + 1, :, 0] = mem[begin:begin + n_objects[i]]
            pad_mems.append(pm)
        return pad_mems

    def memorize(self, frame, masks, n_objects):
        B, K, H, W = masks.shape
        (frame, masks), _ = pad_divide_by_t([frame, masks], 16, (H, W))
        fs, ms, os_ = [], [], []
        for i in range(B):
            for o in range(1, n_objects[i] + 1):
                fs.append(frame[i].unsqueeze(0))
                ms.append(masks[i, o].unsqueeze(0))
                os_.append((torch.sum(masks[i, 1:o].unsqueeze(0), dim=1)
                            + torch.sum(masks[i, o + 1:n_objects[i] + 1].unsqueeze(0), dim=1)
                            ).clamp(0, 1))
        f, m, o = torch.cat(fs), torch.cat(ms), torch.cat(os_)
        r4 = self.encoder_memory(f, m, o)[0]
        k4, v4 = self.kv_memory(r4)
        k4, v4 = self.pad_memory([k4, v4], n_objects, K)
        att, box = self._att(masks)
        att = F.interpolate(att, scale_factor=1 / 16).unsqueeze(2).unsqueeze(2)
        return k4 * att, v4 * att, box

    def soft_aggregation(self, ps, K, n_objects):
        B = len(n_objects)
        _, H, W = ps.shape
        em = torch.zeros(B, K, H, W, device=ps.device)
        for i in range(B):
            begin = sum(n_objects[:i])
            em[i, 0] = torch.prod(1 - ps[begin:begin + n_objects[i]], dim=0)
            em[i, 1:n_objects[i] + 1] = ps[begin:begin + n_objects[i]]
        em = torch.clamp(em, 1e-7, 1 - 1e-7)
        return torch.log(em / (1 - em))

    def segment(self, frame, att_map, keys, values, n_objects):
        B, K = keys.shape[:2]
        (frame, att_map), pad = pad_divide_by_t([frame, att_map], 16, frame.shape[2:])
        r4, r3, r2, _, _ = self.encoder_query(frame)
        k4, v4 = self.kv_query(r4)
        ks, vs, k4e, v4e, r3e, r2e, ams = [], [], [], [], [], [], []
        for i in range(B):
            n = n_objects[i]
            ks.append(keys[i, 1:n + 1])
            vs.append(values[i, 1:n + 1])
            ams.append(att_map[i, 1:n + 1].unsqueeze(1))
            k4e.append(k4[i].expand(n, -1, -1, -1))
            v4e.append(v4[i].expand(n, -1, -1, -1))
            r3e.append(r3[i].expand(n, -1, -1, -1))
            r2e.append(r2[i].expand(n, -1, -1, -1))
        key, value = torch.cat(ks), torch.cat(vs)
        k4e, v4e = torch.cat(k4e), torch.cat(v4e)
        r3e, r2e = torch.cat(r3e), torch.cat(r2e)
        am = F.interpolate(torch.cat(ams), scale_factor=1 / 16)
        m4, _ = memory_read_t(key, value, k4e * am, v4e * am, self.quant)
        logits = self.decoder(m4, r3e, r2e)
        ps = torch.softmax(logits, dim=1)[:, 1]
        logit = self.soft_aggregation(ps, K, n_objects)
        if pad[2] + pad[3] > 0:
            logit = logit[:, :, pad[2]:-pad[3], :]
        if pad[0] + pad[1] > 0:
            logit = logit[:, :, :, pad[0]:-pad[1]]
        return logit

    def forward(self, frames, masks, optical_flows, n_objects, memorize_every, flow_fn=None,
                follow=None, stop=None):
        """frames (B, T, 3, H, W), masks (B, T, K, H, W) one-hot, flows (B,
        T, 2, H, W) backward flows or None with ``flow_fn(frame_t,
        frame_t-1)``, n_objects (B, T) -> est (B, T, K, H, W). With
        ``follow`` (B, T, K, H, W), each frame t starts from follow[:, t-1]
        as the previous frame's estimate instead of its own: one step of the
        loop at a time from another run's estimates. With ``stop``, frames
        from ``stop`` on are left unestimated (zero); the object rows are
        still those of the whole clip."""
        B, T, _, H, W = frames.size()
        K = masks.size(2)
        est = torch.zeros(B, T, K, H, W, device=frames.device)
        est[:, 0] = masks[:, 0]
        n_objects = torch.as_tensor(n_objects)
        n_max = [int(torch.max(no).item()) for no in n_objects]
        existing = [torch.unique(torch.argmax(masks[i, 0], dim=0)).tolist() for i in range(B)]
        to_mem = set(range(0, T, memorize_every))
        new_at = [j for j in range(1, T) if (n_objects[:, j] != n_objects[:, j - 1]).any()]
        keys = values = None
        for t in range(1, T if stop is None else min(T, stop)):
            prev_mask = est[:, t - 1] if follow is None else follow[:, t - 1].float()
            pk, pv, _ = self.memorize(frames[:, t - 1], prev_mask, n_max)
            if t - 1 == 0:
                tk, tv = pk, pv
            else:
                tk = torch.cat([keys, pk], dim=3)
                tv = torch.cat([values, pv], dim=3)
            if t - 1 in to_mem or t - 1 in new_at:
                keys, values = tk, tv
            flow = (optical_flows[:, t] if flow_fn is None
                    else flow_fn(frames[:, t], frames[:, t - 1]))
            warped, _ = warp_t(prev_mask, flow)
            att, _ = self._att(warped)
            logit = self.segment(frames[:, t], att, tk, tv, n_max)
            if t in new_at:
                for i in range(B):
                    for j in torch.unique(torch.argmax(masks[i, t], dim=0)).tolist():
                        if j not in existing[i]:
                            existing[i].append(j)
                            logit[i, j] = masks[i, t, j].float() * 32.0605 - 16.1181
            for i in range(B):
                for j in range(n_max[i] + 1):
                    if j not in existing[i]:
                        logit[i, j] = -16.1181
            est[:, t] = torch.softmax(logit, dim=1)
        return est


# --------------------------------------------------------------- entry points
def build(loose=64, n_pts=10, threshold=0.5):
    """(RMNetT, TinyFlowNetT), uninitialised, on the meta device: their
    state dicts give the names and shapes of the weights."""
    with torch.device("meta"):
        return RMNetT(loose, n_pts, threshold), TinyFlowNetT()


def on_device(rmnet_state, tfn_state, device, loose=64, n_pts=10, threshold=0.5):
    """The reference modules on ``device`` with these state dicts, eval mode
    (BatchNorm frozen, as the program trains and serves); TinyFlowNet is
    None without ``tfn_state``."""
    rm, tfn = build(loose, n_pts, threshold)
    rm = rm.to_empty(device=device)
    rm.load_state_dict(rmnet_state)
    if tfn_state is None:
        return rm.eval(), None
    tfn = tfn.to_empty(device=device)
    tfn.load_state_dict(tfn_state)
    return rm.eval(), tfn.eval()


@torch.no_grad()
def infer(rm, tfn, frames, masks, n_objects, memorize_every, follow=None, stop=None):
    """One video through the reference with TinyFlowNet's flows: frames (T,
    H, W, 3) normalised, masks (T, K, H, W) one-hot, n_objects (T,), on the
    reference's device -> probabilities (T, K, H, W). With ``follow`` (T, K,
    H, W), each frame from follow's previous frame; with ``stop``, only the
    frames before it (RMNetT.forward)."""
    f = frames.permute(0, 3, 1, 2)[None].float()
    est = rm(f, masks[None].float(), None, torch.as_tensor(n_objects)[None],
             memorize_every, flow_fn=tfn.pair, follow=None if follow is None else follow[None],
             stop=stop)
    return est[0]


def lovasz_t(input_t, target_t, ignore_index=255):
    """Lovasz-Softmax with the semantics of reference models/lovasz_loss.py:
    input (B, C, F, H, W) probabilities, target (B, F, H, W)."""
    B, C, FF, H, W = input_t.size()
    inp = input_t.permute(0, 2, 3, 4, 1).contiguous().view(-1, C)
    tgt = target_t.view(-1)
    valid = tgt.ne(ignore_index).nonzero(as_tuple=False).squeeze()
    inp, tgt = inp[valid], tgt[valid]
    if inp.numel() == 0:
        return inp.sum() * 0.0
    losses = []
    for c in range(C):
        fg = (tgt == c).float()
        if fg.sum() == 0:
            continue
        errors = (fg - inp[:, c]).abs()
        errors_sorted, perm = torch.sort(errors, 0, descending=True)
        fg_sorted = fg[perm.data]
        p = len(fg_sorted)
        gts = fg_sorted.sum()
        intersection = gts - fg_sorted.float().cumsum(0)
        union = gts + (1 - fg_sorted).float().cumsum(0)
        jaccard = 1.0 - intersection / union
        if p > 1:
            jaccard[1:p] = jaccard[1:p] - jaccard[0:-1]
        losses.append(torch.dot(errors_sorted, jaccard))
    if not losses:
        return inp.sum() * 0.0
    acc = losses[0]
    for v in losses[1:]:
        acc = acc + v
    return acc / len(losses)


def train_loss(rm, frames, masks, flows, n_objects, memorize_every, ignore_index=255,
               with_est=False):
    """The reference objective of one batch: frames (B, T, H, W, 3), masks (B,
    T, K, H, W) one-hot, flows (B, T, H, W, 2), n_objects (B, T) -> Lovasz +
    NLL over frames 1..T-1 (core/train.py:80-82, 174-180); with
    ``with_est``, (the loss, the estimates (B, T, K, H, W))."""
    est = rm(frames.permute(0, 1, 4, 2, 3).float(), masks.float(),
             flows.permute(0, 1, 4, 2, 3).float(), n_objects, memorize_every)
    probs = est[:, 1:].permute(0, 2, 1, 3, 4)           # (B, K, T-1, H, W)
    labels = torch.argmax(masks[:, 1:], dim=2)           # (B, T-1, H, W)
    loss = lovasz_t(probs, labels, ignore_index) + F.nll_loss(
        torch.log(probs), labels, ignore_index=ignore_index)
    return (loss, est) if with_est else loss


def adam_step(params, grads, state, lr, betas, eps=1e-8, weight_decay=0.0):
    """torch.optim.Adam's update (L2 weight decay folded into the gradient),
    written out: ``state`` holds step, exp_avg and exp_avg_sq per name."""
    b1, b2 = betas
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            if weight_decay:
                g = g + weight_decay * p
            s = state.setdefault(name, dict(step=0, exp_avg=torch.zeros_like(p),
                                            exp_avg_sq=torch.zeros_like(p)))
            s["step"] += 1
            s["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
            s["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1, bc2 = 1 - b1 ** s["step"], 1 - b2 ** s["step"]
            denom = (s["exp_avg_sq"].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(s["exp_avg"], denom, value=-lr / bc1)
