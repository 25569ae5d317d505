"""Inputs made from ``--seed``: weights, video clips and training batches.

The same seed gives the same inputs on the same kind of device. Both sides
get them: the program loads the weights with ``load_state_dict`` and takes the
clips and batches through its entry points; the reference reads the same
arrays. Weights are drawn on the device, in a few large calls, in the
reference's state-dict layout.

The clip and batch generators follow the repository's smoke test
(chip_smoke.py ``make_clip``, ``make_train_batch``): uniform-noise frames in
[-1, 1], objects as drifting boxes whose masks are given at frame 0 and at
the frame each later object first appears.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vosbench.reference import rmnet_ref

_SEED_MOD = 2 ** 63


def rng(seed: int, *path: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a path of
    sub-stream indices."""
    return np.random.default_rng([int(seed) % _SEED_MOD, *path])


def torch_generator(seed: int, device, *path: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, 7, *path).integers(_SEED_MOD)))
    return g


def _conv_leaves(module: nn.Module, prefix: str) -> List[Tuple[str, str, int, bool]]:
    """(name, kind, fan_in, trunk) of every conv weight and bias and every
    BatchNorm leaf of ``module``; kind is weight / bias / bn_weight / bn_bias
    / bn_mean / bn_var."""
    out = []
    for name, mod in module.named_modules():
        full = prefix + name + "."
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            cin = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
            fan_in = cin * w.shape[2] * w.shape[3]
            trunk = name.startswith(("encoder_memory.", "encoder_query."))
            out.append((full + "weight", "weight", fan_in, trunk))
            if mod.bias is not None:
                out.append((full + "bias", "bias", fan_in, trunk))
        elif isinstance(mod, nn.BatchNorm2d):
            out += [(full + k, "bn_" + k.split("_")[-1], 0, True)
                    for k in ("weight", "bias", "running_mean", "running_var")]
    return out


def weights(seed: int, device, loose=64, n_pts=10, threshold=0.5
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(RMNet, TinyFlowNet) state dicts in float32 on ``device``, drawn from
    ``seed`` by the reference's scheme (core/train.py:48-53, as the port's
    ``build_models`` follows it): ResNet trunks and mask stems
    U(+-1/sqrt(fan_in)) (torch's conv default), heads, decoder and
    TinyFlowNet kaiming-normal (fan_in, gain sqrt(2)), zero biases, identity
    BatchNorm. Two draws on the device in all."""
    rm, tfn = rmnet_ref.build(loose, n_pts, threshold)
    shapes = {**{"rm." + k: v.shape for k, v in rm.state_dict().items()},
              **{"tfn." + k: v.shape for k, v in tfn.state_dict().items()}}
    leaves = _conv_leaves(rm, "rm.") + _conv_leaves(tfn, "tfn.")
    draws = {"normal": [], "uniform": []}
    for name, kind, fan_in, trunk in leaves:
        if kind == "weight":
            n = math.prod(shapes[name])
            if trunk:
                bound = 1.0 / math.sqrt(fan_in)
                draws["uniform"].append((name, n, -bound, 2 * bound))
            else:
                draws["normal"].append((name, n, 0.0, math.sqrt(2.0 / fan_in)))
    g = torch_generator(seed, device, 0)
    out: Dict[str, torch.Tensor] = {}
    for dist, items in draws.items():
        total = sum(n for _, n, _, _ in items)
        buf = (torch.randn if dist == "normal" else torch.rand)(
            total, generator=g, device=device, dtype=torch.float32)
        at = 0
        for name, n, shift, scale in items:
            out[name] = (buf[at:at + n] * scale + shift).view(shapes[name])
            at += n
    for name, kind, _, _ in leaves:
        if kind in ("bn_weight", "bn_var"):
            out[name] = torch.ones(shapes[name], device=device)
    for name, shape in shapes.items():  # biases, BatchNorm shift and mean, counters
        if name not in out:
            dtype = torch.int64 if name.endswith("num_batches_tracked") else torch.float32
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    rm_sd = {k[3:]: out[k] for k in shapes if k.startswith("rm.")}
    tfn_sd = {k[4:]: out[k] for k in shapes if k.startswith("tfn.")}
    return rm_sd, tfn_sd


def object_boxes(r: np.random.Generator, n_obj: int, H: int, W: int, size=None) -> np.ndarray:
    """(n_obj, 4) int boxes (y, x, height, width), one per column band of the
    frame so that no object hides another. ``size``: {"height": [lo, hi],
    "width": [lo, hi]} as shares of the frame's height and width; without
    it, heights of H/6..H/3 and widths of half to all of the band."""
    band = W // n_obj
    boxes = np.zeros((n_obj, 4), np.int64)
    for k in range(n_obj):
        if size is None:
            bw = int(r.integers(max(band // 2, 1), max(band - 4, band // 2 + 1) + 1))
            bh = int(r.integers(max(H // 6, 2), max(H // 3, H // 6 + 1) + 1))
        else:
            bh = max(2, int(round(r.uniform(*size["height"]) * H)))
            bw = min(band, max(2, int(round(r.uniform(*size["width"]) * W))))
        x = k * band + int(r.integers(0, max(band - bw, 0) + 1))
        y = int(r.integers(0, max(H - bh - H // 4, 0) + 1))
        boxes[k] = (y, x, bh, bw)
    return boxes


def clip_masks(boxes: np.ndarray, T: int, H: int, W: int, appear: Sequence[int]):
    """Label maps of the given frames and the clip's one-hot masks (T, K, H,
    W), written only at frame 0 and at each object's first frame (the engine
    and the reference read no other), and n_objects (T,). Boxes drift down
    by 1 pixel a frame, clamped to the frame."""
    n_obj = len(boxes)
    K = n_obj + 1
    masks = np.zeros((T, K, H, W), np.float32)  # pages never written stay unbacked
    given = sorted({0, *[a for a in appear if a < T]})
    for t in given:
        labels = np.zeros((H, W), np.uint8)
        for k, (y, x, bh, bw) in enumerate(boxes, start=1):
            if appear[k - 1] <= t:
                yy = min(y + t, H - bh)
                labels[yy:yy + bh, x:x + bw] = k
        masks[t] = labels[None] == np.arange(K)[:, None, None]
    n_objects = np.array([sum(a <= t for a in appear) for t in range(T)], np.int32)
    return masks, n_objects


def stream_clip(seed: int, index: int, T: int, H: int, W: int, appear: Sequence[int],
                device, size=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clip ``index`` of the seed's pool: frames (T, H, W, 3) float32 noise in
    [-1, 1] (drawn on ``device``), masks (T, K, H, W) one-hot, n_objects (T,)
    with object k first given at frame ``appear[k-1]``, objects of ``size``
    (object_boxes)."""
    g = torch_generator(seed, device, 1, index)
    frames = torch.rand((T, H, W, 3), generator=g, device=device).mul_(2).sub_(1)
    frames = frames.cpu().numpy()
    boxes = object_boxes(rng(seed, 2, index), len(appear), H, W, size)
    masks, n_objects = clip_masks(boxes, T, H, W, appear)
    return frames, masks, n_objects


def train_batch(seed: int, index: int, B: int, T: int, H: int, W: int, n_obj: int,
                device, pin: bool) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the seed's pool at the reference's training shape:
    frames (B, T, H, W, 3) noise, masks (B, T, K, H, W) of drifting boxes with
    the last object appearing at t=1, flows (B, T, H, W, 2) smooth random
    fields within +-3 px (flows[:, 0] = 0), n_objects (B, T); host tensors,
    pinned with ``pin`` (as the loader hands them to the step)."""
    K = n_obj + 1
    r = rng(seed, 3, index)
    g = torch_generator(seed, device, 4, index)
    frames = torch.rand((B, T, H, W, 3), generator=g, device=device).mul_(2).sub_(1)
    labels = np.zeros((B, T, H, W), np.uint8)
    for b in range(B):
        for k in range(1, K):
            y0, x0 = r.integers(0, max(min(H, W) - H // 3, 1), 2)
            hh, ww = r.integers(max(H // 8, 2), max(H // 3, H // 8 + 1), 2)
            dy, dx = r.integers(-8, 9, 2)
            for t in range(1 if k == n_obj else 0, T):
                y, x = y0 + dy * t, x0 + dx * t
                labels[b, t, max(y, 0):max(y + hh, 0), max(x, 0):max(x + ww, 0)] = k
    masks = (labels[:, :, None] == np.arange(K)[:, None, None]).astype(np.float32)
    amp = torch.as_tensor(r.uniform(1.0, 3.0, (B, T, 1, 1, 2)), dtype=torch.float32)
    phase = torch.as_tensor(r.uniform(0.0, 2 * np.pi, (B, T, 1, 1, 2)), dtype=torch.float32)
    freq = torch.as_tensor(r.uniform(0.5, 2.0, (B, T, 1, 1, 2, 2)), dtype=torch.float32)
    yy, xx = torch.meshgrid(torch.arange(H, device=device) / max(H, W),
                            torch.arange(W, device=device) / max(H, W), indexing="ij")
    freq = freq.to(device)
    arg = 2 * np.pi * (freq[..., 0] * yy[..., None] + freq[..., 1] * xx[..., None])
    flows = amp.to(device) * torch.sin(arg + phase.to(device))
    flows[:, 0] = 0
    n_objects = np.tile(np.array([n_obj - 1] + [n_obj] * (T - 1), np.int32), (B, 1))
    batch = dict(frames=frames.cpu(), masks=torch.from_numpy(masks), flows=flows.cpu(),
                 n_objects=torch.from_numpy(n_objects))
    if pin:
        batch = {k: v.pin_memory() for k, v in batch.items()}
    return batch
