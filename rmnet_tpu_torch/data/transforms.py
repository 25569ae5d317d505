"""Video transforms of the data pipeline, numpy on the host (counterpart of
rmnet_tpu/data/transforms.py; reference utils/data_transforms.py).

The test path's Compose, ReorganizeObjectID, ToOneHot, Normalize and
ToArrays, and the training transforms: RandomPermuteRGB, RandomFlip,
Resize, RandomCrop, ColorJitter, HistogramEqualization and RandomAffine,
whose warps and flow re-computation run through the native op of
data/flow_affine.py. Every draw goes through ``pyrand()`` / ``nprand()``
(data/rng.py) in the JAX package's order, so a seeded loader gives the same
batches in both packages.

The JAX package's divergences from the reference are kept: RandomAffine
warps masks with nearest sampling (the reference blends label ids
bilinearly), Resize uses half-pixel bilinear and floor nearest sampling,
the affine centre is (h/2 + .5, w/2 + .5) in (x, y) slots
(utils/data_transforms.py:276), and the flow update reads x1 before y1.
"""

from __future__ import annotations

import math
import numbers
import sys
from typing import List, Sequence

import numpy as np

from rmnet_tpu_torch.data.flow_affine import (affine_warp, affine_warp_numpy,  # noqa: F401
                                              update_optical_flow)
from rmnet_tpu_torch.data.rng import nprand, pyrand


def _invert_affine_2x3(m: np.ndarray) -> np.ndarray:
    full = np.vstack([m, [0.0, 0.0, 1.0]]).astype(np.float64)
    return np.linalg.inv(full)[:2].astype(np.float32)


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-centre bilinear resize (torch's align_corners=False),
    float32 out."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape

    def coords(out_size, in_size):
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0, in_size - 1)
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, in_size - 1)
        return i0, i1, (src - i0).astype(np.float32)

    y0, y1, wy = coords(out_h, h)
    x0, x1, wx = coords(out_w, w)
    imgf = img.astype(np.float32)
    top = imgf[y0][:, x0] * (1 - wx)[None, :, None] + imgf[y0][:, x1] * wx[None, :, None]
    bot = imgf[y1][:, x0] * (1 - wx)[None, :, None] + imgf[y1][:, x1] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]
    return out[..., 0] if squeeze else out


def resize_nearest_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    return img[ys][:, xs]


class Compose:
    """Dict-driven transform pipeline (reference utils/data_transforms.py:23-38)."""

    REGISTRY = {}

    def __init__(self, transforms: Sequence[dict]):
        self.transformers = []
        for tr in transforms:
            cls = self.REGISTRY[tr["callback"]]
            self.transformers.append(cls(tr.get("parameters")))

    def __call__(self, frames, masks, optical_flows):
        for tr in self.transformers:
            frames, masks, optical_flows = tr(frames, masks, optical_flows)
        return frames, masks, optical_flows


def register(cls):
    Compose.REGISTRY[cls.__name__] = cls
    return cls


@register
class ToArrays:
    """Stack per-frame lists into contiguous NHWC arrays: frames (T, H, W, 3)
    float32, masks (T, K, H, W) uint8, flows (T, H, W, 2) float32."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, frames, masks, optical_flows):
        frames = np.ascontiguousarray(np.stack(frames), np.float32)
        masks = np.ascontiguousarray(np.stack(masks))
        optical_flows = np.ascontiguousarray(np.stack(optical_flows), np.float32)
        return frames, masks, optical_flows


# the reference pipeline's name
Compose.REGISTRY["ToTensor"] = ToArrays


@register
class ReorganizeObjectID:
    """Densify mask ids to 0..n (reference utils/data_transforms.py:53-68)."""

    def __init__(self, parameters):
        self.ignore_idx = parameters["ignore_idx"]

    def __call__(self, frames, masks, optical_flows):
        mask_indexes = np.unique(np.array(masks))
        mask_indexes = mask_indexes[mask_indexes != self.ignore_idx]
        for m_idx, m in enumerate(masks):
            _m = np.zeros(m.shape, np.uint8)
            for idx, mi in enumerate(mask_indexes):
                _m[m == mi] = idx
            masks[m_idx] = _m
        return frames, masks, optical_flows


@register
class ToOneHot:
    """Label map -> n_objects + 1 binary channels, optionally with the object
    ids shuffled (reference utils/data_transforms.py:71-83)."""

    def __init__(self, parameters):
        self.shuffle = parameters["shuffle"]
        self.n_objects = parameters["n_objects"]

    def __call__(self, frames, masks, optical_flows):
        perm = nprand().permutation(self.n_objects) + 1
        perm = np.insert(perm, 0, 0)
        out = []
        for m in masks:
            oh = np.stack([(m == k) for k in range(self.n_objects + 1)]).astype(np.uint8)
            out.append(oh[perm] if self.shuffle else oh)
        return frames, out, optical_flows


@register
class Normalize:
    def __init__(self, parameters):
        self.mean = np.asarray(parameters["mean"], np.float32)
        self.std = np.asarray(parameters["std"], np.float32)

    def __call__(self, frames, masks, optical_flows):
        for idx, (f, m) in enumerate(zip(frames, masks)):
            frames[idx] = ((np.asarray(f, np.float32) / 255.0 - self.mean) / self.std).astype(
                np.float32
            )
            masks[idx] = np.asarray(m, np.uint8)
        return frames, masks, optical_flows


@register
class RandomPermuteRGB:
    def __init__(self, parameters=None):
        pass

    def __call__(self, frames, masks, optical_flows):
        perm = nprand().permutation(3)
        for idx, f in enumerate(frames):
            frames[idx] = f[..., perm]
        return frames, masks, optical_flows


@register
class RandomFlip:
    """Horizontal flip with the flow's x negated (reference :111-125; no
    stock pipeline uses it)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, frames, masks, optical_flows):
        if pyrand().random() <= 0.5:
            for idx in range(len(frames)):
                frames[idx] = np.flip(frames[idx], axis=1).copy()
                masks[idx] = np.flip(masks[idx], axis=1).copy()
                of = np.flip(optical_flows[idx], axis=1).copy()
                of[..., 0] = -of[..., 0]
                optical_flows[idx] = of
        return frames, masks, optical_flows


@register
class Resize:
    """Short-side resize keeping the ratio; flow values scaled by the same
    factor (reference utils/data_transforms.py:128-156)."""

    def __init__(self, parameters):
        self.size = parameters["size"]
        self.keep_ratio = parameters["keep_ratio"]

    def __call__(self, frames, masks, optical_flows):
        img_h, img_w = masks[0].shape
        if self.keep_ratio:
            scale = max(self.size / img_h, self.size / img_w)
            height = int(img_h * scale + 0.5)
            width = int(img_w * scale + 0.5)
        else:
            scale = 1.0
            height = width = self.size
        frames = [resize_bilinear_np(f, height, width) for f in frames]
        masks = [resize_nearest_np(m, height, width) for m in masks]
        optical_flows = [resize_bilinear_np(of, height, width) * scale for of in optical_flows]
        return frames, masks, optical_flows


@register
class RandomCrop:
    """A crop that keeps the objects' box in view when it fits; each flow
    is shifted by the crop's offset from the previous frame's (reference
    utils/data_transforms.py:159-230)."""

    def __init__(self, parameters):
        self.height = parameters["height"]
        self.width = parameters["width"]
        self.ignore_idx = parameters["ignore_idx"]

    def __call__(self, frames, masks, optical_flows):
        prev_x_min = 0
        prev_y_min = 0
        for i in range(len(frames)):
            x_min, y_min = sys.maxsize, sys.maxsize
            x_max, y_max = 0, 0
            mask = masks[i].copy()
            mask[mask == 255] = 0
            for j in np.unique(mask):
                if j == 0:
                    continue
                rows = np.where(np.any(mask == j, axis=1))[0]
                cols = np.where(np.any(mask == j, axis=0))[0]
                if len(rows) == 0 or len(cols) == 0:
                    continue
                x_min = min(x_min, cols[0])
                x_max = max(x_max, cols[-1])
                y_min = min(y_min, rows[0])
                y_max = max(y_max, rows[-1])

            bbox_height = y_max - y_min + 1
            bbox_width = x_max - x_min + 1
            img_h, img_w = masks[i].shape
            height_diff = abs(bbox_height - self.height)
            width_diff = abs(bbox_width - self.width)

            if bbox_height <= self.height:
                y_lb = max(y_min - height_diff, 0)
                y_ub = min(img_h - self.height, y_min)
                y_min = pyrand().randint(y_lb, y_ub) if y_lb < y_ub else 0
            else:
                y_min = pyrand().randint(y_min, y_min + height_diff)
            if bbox_width <= self.width:
                x_lb = max(x_min - width_diff, 0)
                x_ub = min(img_w - self.width, x_min)
                x_min = pyrand().randint(x_lb, x_ub) if x_lb < x_ub else 0
            else:
                x_min = pyrand().randint(x_min, x_min + width_diff)

            frames[i] = frames[i][y_min:y_min + self.height, x_min:x_min + self.width, :]
            masks[i] = masks[i][y_min:y_min + self.height, x_min:x_min + self.width]
            optical_flows[i] = optical_flows[i][
                y_min:y_min + self.height, x_min:x_min + self.width, :
            ].copy()
            if i > 0:
                optical_flows[i][..., 0] -= prev_x_min - x_min
                optical_flows[i][..., 1] -= prev_y_min - y_min
            prev_x_min, prev_y_min = x_min, y_min
        return frames, masks, optical_flows


@register
class ColorJitter:
    """Brightness, contrast, saturation and hue jitter with torchvision's
    parameters (reference utils/data_transforms.py:233-248): the enabled ops
    run in a random order, each factor drawn uniformly from its range."""

    def __init__(self, parameters):
        self.brightness = parameters["brightness"]
        self.contrast = parameters["contrast"]
        self.saturation = parameters["saturation"]
        self.hue = parameters["hue"]

    @staticmethod
    def _blend(a, b, factor):
        return np.clip(a * factor + b * (1.0 - factor), 0, 255)

    def _apply(self, img, op, factor):
        img = img.astype(np.float32)
        if op == "brightness":
            return self._blend(img, np.zeros_like(img), factor)
        if op == "contrast":
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            return self._blend(img, gray.mean(), factor)
        if op == "saturation":
            gray = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
            return self._blend(img, gray, factor)
        if op == "hue":
            # a YIQ rotation of the hue
            t = factor * 2.0 * math.pi
            u, w = math.cos(t), math.sin(t)
            m = np.array(
                [
                    [0.299 + 0.701 * u + 0.168 * w, 0.587 - 0.587 * u + 0.330 * w,
                     0.114 - 0.114 * u - 0.497 * w],
                    [0.299 - 0.299 * u - 0.328 * w, 0.587 + 0.413 * u + 0.035 * w,
                     0.114 - 0.114 * u + 0.292 * w],
                    [0.299 - 0.300 * u + 1.250 * w, 0.587 - 0.588 * u - 1.050 * w,
                     0.114 + 0.886 * u - 0.203 * w],
                ],
                np.float32,
            )
            return np.clip(img @ m.T, 0, 255)
        return img

    def __call__(self, frames, masks, optical_flows):
        ops = []
        if self.brightness is not None:
            ops.append(("brightness", pyrand().uniform(*self.brightness)))
        if self.contrast is not None:
            ops.append(("contrast", pyrand().uniform(*self.contrast)))
        if self.saturation is not None:
            ops.append(("saturation", pyrand().uniform(*self.saturation)))
        if self.hue is not None:
            ops.append(("hue", pyrand().uniform(*self.hue)))
        pyrand().shuffle(ops)
        for idx, f in enumerate(frames):
            out = f.astype(np.float32)
            for op, factor in ops:
                out = self._apply(out, op, factor)
            frames[idx] = out.astype(np.uint8)
        return frames, masks, optical_flows


@register
class HistogramEqualization:
    """Histogram equalization of the luma (reference :251-261; no stock
    pipeline uses it)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, frames, masks, optical_flows):
        for idx, f in enumerate(frames):
            img = f.astype(np.float32)
            y = img @ np.array([0.299, 0.587, 0.114], np.float32)
            hist, _ = np.histogram(y.astype(np.uint8), bins=256, range=(0, 256))
            cdf = np.cumsum(hist).astype(np.float64)
            nz = cdf[cdf > 0]
            if len(nz) == 0:
                continue
            lut = np.clip((cdf - nz[0]) / max(cdf[-1] - nz[0], 1) * 255.0, 0, 255)
            y_eq = lut[y.astype(np.uint8)]
            scale = (y_eq + 1.0) / (y + 1.0)
            frames[idx] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
        return frames, masks, optical_flows


@register
class RandomAffine:
    """A random affine per frame, with each flow re-computed between the
    two warped frames (reference utils/data_transforms.py:264-361)."""

    def __init__(self, parameters):
        self.degrees = parameters["degrees"]
        self.translate = parameters["translate"]
        self.scale = parameters["scale"]
        self.shears = parameters["shears"]
        self.frame_fill_color = parameters["frame_fill_color"]
        self.mask_fill_color = parameters["mask_fill_color"]
        self.optical_flow_fill_color = parameters["optical_flow_fill_color"]

    @staticmethod
    def get_params(degrees, translate, scale_ranges, shears, img_size):
        """torchvision's RandomAffine.get_params."""
        angle = pyrand().uniform(degrees[0], degrees[1])
        if translate is not None:
            max_dx = translate[0] * img_size[0]
            max_dy = translate[1] * img_size[1]
            translations = (
                np.round(pyrand().uniform(-max_dx, max_dx)),
                np.round(pyrand().uniform(-max_dy, max_dy)),
            )
        else:
            translations = (0, 0)
        scale = pyrand().uniform(scale_ranges[0], scale_ranges[1]) if scale_ranges else 1.0
        shear = pyrand().uniform(shears[0], shears[1]) if shears else 0.0
        return angle, translations, scale, shear

    @staticmethod
    def inverse_affine_matrix(center, angle, translate, scale, shear):
        """Inverse of M = T * C * RSS * C^-1, mapping output coordinates to
        input ones (the torchvision helper of utils/data_transforms.py:
        309-361)."""
        if isinstance(shear, numbers.Number):
            shear = [shear, 0]
        rot = math.radians(angle)
        sx, sy = [math.radians(s) for s in shear]
        cx, cy = center
        tx, ty = translate

        a = math.cos(rot - sy) / math.cos(sy)
        b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
        c = math.sin(rot - sy) / math.cos(sy)
        d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

        M = [d, -b, 0, -c, a, 0]
        M = [x / scale for x in M]
        M[2] += M[0] * (-cx - tx) + M[1] * (-cy - ty)
        M[5] += M[3] * (-cx - tx) + M[4] * (-cy - ty)
        M[2] += cx
        M[5] += cy
        return np.array(M, np.float32).reshape(2, 3)

    def __call__(self, frames, masks, optical_flows):
        img_h, img_w = masks[0].shape
        # the reference's centre: (h-based, w-based) values in (x, y) slots
        center = (img_h * 0.5 + 0.5, img_w * 0.5 + 0.5)

        tr_matrices: List[np.ndarray] = []
        for idx in range(len(frames)):
            angle, translations, scale, shear = self.get_params(
                self.degrees, self.translate, self.scale, self.shears, (img_h, img_w)
            )
            G = self.inverse_affine_matrix(center, angle, translations, scale, shear)
            tr_matrices.append(G)
            # cv2.warpAffine(img, G) samples the source at inv(G).(x, y)
            sampling = _invert_affine_2x3(G)
            frames[idx] = affine_warp(frames[idx], sampling, self.frame_fill_color,
                                      nearest=False).astype(frames[idx].dtype)
            masks[idx] = affine_warp(masks[idx], sampling, self.mask_fill_color,
                                     nearest=True).astype(np.uint8)

        for idx in range(1, len(optical_flows)):
            of = update_optical_flow(np.asarray(optical_flows[idx], np.float32),
                                     tr_matrices[idx - 1], tr_matrices[idx])
            sampling = _invert_affine_2x3(tr_matrices[idx])
            optical_flows[idx] = affine_warp(of, sampling, self.optical_flow_fill_color,
                                             nearest=False).astype(np.float32)
        return frames, masks, optical_flows
