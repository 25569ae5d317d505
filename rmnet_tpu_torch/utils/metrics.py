"""DAVIS-protocol segmentation metrics (counterpart of
rmnet_tpu/utils/metrics.py): J (region IoU) and F (boundary F-measure).

  * J = Jaccard index per object per frame, frames 1..T-1, objects 1..K
    (reference utils/metrics.py:70-102);
  * F = boundary F-measure: 1-px boundary maps (seg2bmap, reference
    utils/metrics.py:172-226) dilated with a disk of radius
    ceil(0.008 * ||shape||), precision and recall of matched boundaries
    (reference utils/metrics.py:119-169);
  * JF-Mean = (J-Mean + F-Mean) / 2, the main model-selection metric.

skimage is replaced by scipy.ndimage with the same disk structuring element
(x^2 + y^2 <= r^2).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import scipy.ndimage


def _dilate_disk(boundary: np.ndarray, radius: int) -> np.ndarray:
    """binary_dilation by a disk of ``radius`` (x^2 + y^2 <= r^2), exactly,
    through the Euclidean distance transform: a pixel is set iff a boundary
    pixel lies within L2 distance ``radius`` of it. The transform is O(H W),
    the dilation O(H W r^2)."""
    if not boundary.any():
        return np.zeros_like(boundary, dtype=bool)
    dist = scipy.ndimage.distance_transform_edt(~boundary)
    return dist <= int(radius)


def to_onehot(mask: np.ndarray, k: int) -> np.ndarray:
    """Label map -> (k, H, W) binary masks (reference utils/helpers.py:81-90)."""
    return np.stack([(mask == i) for i in range(k)]).astype(np.uint8)


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-px-wide binary boundary map, offset 1/2 px toward the origin
    (reference utils/metrics.py:172-226, same-size path)."""
    seg = seg.astype(bool)

    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)

    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = seg ^ e | seg ^ s | seg ^ se
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def get_iou(segmentation: np.ndarray, annotation: np.ndarray) -> float:
    """Region similarity (Jaccard). Empty pred + empty gt -> 1."""
    segmentation = segmentation.astype(bool)
    annotation = annotation.astype(bool)
    if np.isclose(np.sum(annotation), 0) and np.isclose(np.sum(segmentation), 0):
        return 1.0
    return float(
        np.sum(annotation & segmentation) / np.sum(annotation | segmentation, dtype=np.float32)
    )


def get_f_score(foreground_mask: np.ndarray, gt_mask: np.ndarray, bound_th: float = 0.008) -> float:
    """Boundary F-measure between binary masks (reference utils/metrics.py:119-169)."""
    bound_pix = (
        bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))
    )
    fg_boundary = seg2bmap(foreground_mask)
    gt_boundary = seg2bmap(gt_mask)

    fg_dil = _dilate_disk(fg_boundary, bound_pix)
    gt_dil = _dilate_disk(gt_boundary, bound_pix)

    gt_match = gt_boundary * fg_dil
    fg_match = fg_boundary * gt_dil

    n_fg = np.sum(fg_boundary)
    n_gt = np.sum(gt_boundary)

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = np.sum(fg_match) / float(n_fg)
        recall = np.sum(gt_match) / float(n_gt)

    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


class Metrics:
    """Value object for J-Mean / F-Mean / JF-Mean with ``better_than``
    comparison on a main metric (reference utils/metrics.py:232-279)."""

    NAMES = ["J-Mean", "F-Mean", "JF-Mean"]

    @classmethod
    def names(cls) -> List[str]:
        return list(cls.NAMES)

    @classmethod
    def get(cls, pred: np.ndarray, gt: np.ndarray,
            n_workers: Optional[int] = None) -> List[float]:
        """Evaluate a (T, H, W) predicted label video vs ground truth.

        Frames 1..T-1 and objects 1..n_objects are scored, matching
        reference utils/metrics.py:70-116. ``n_workers`` > 1 scores frames
        on a thread pool (numpy/scipy release the GIL in the heavy
        kernels); results are collected in frame order, so the means are
        bit-identical to the serial path.
        """
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        n_frames = gt.shape[0]
        n_objects = int(np.max(gt))

        def score_frame(i: int):
            gt_oh = to_onehot(gt[i], n_objects + 1)
            pred_oh = to_onehot(pred[i], n_objects + 1)
            js = [get_iou(pred_oh[j], gt_oh[j]) for j in range(1, n_objects + 1)]
            fs = [get_f_score(pred_oh[j], gt_oh[j]) for j in range(1, n_objects + 1)]
            return js, fs

        idxs = range(1, n_frames)
        if n_workers and n_workers > 1 and n_frames > 2:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(int(n_workers)) as pool:
                per_frame = list(pool.map(score_frame, idxs))
        else:
            per_frame = [score_frame(i) for i in idxs]
        jaccard: List[float] = []
        f_scores: List[float] = []
        for js, fs in per_frame:
            jaccard.extend(js)
            f_scores.extend(fs)
        # plain mean, like the reference (utils/metrics.py:55-57): a NaN
        # score PROPAGATES instead of being silently dropped, so a broken
        # video surfaces in the summary rather than being masked
        j_mean = float(np.mean(jaccard)) if jaccard else 0.0
        f_mean = float(np.mean(f_scores)) if f_scores else 0.0
        return [j_mean, f_mean, (j_mean + f_mean) / 2.0]

    def __init__(self, metric_name: str, values):
        self.metric_name = metric_name
        self._values = [0.0] * len(self.NAMES)
        if isinstance(values, (list, tuple)):
            self._values = list(values)
        elif isinstance(values, dict):
            for k, v in values.items():
                if k not in self.NAMES:
                    logging.warning("Ignoring unknown metric %s", k)
                    continue
                self._values[self.NAMES.index(k)] = v
        else:
            raise TypeError(f"Unsupported value type: {type(values)}")

    def state_dict(self) -> Dict[str, float]:
        return dict(zip(self.NAMES, self._values))

    def __repr__(self) -> str:
        return str(self.state_dict())

    def better_than(self, other: Optional["Metrics"]) -> bool:
        if other is None:
            return True
        idx = self.NAMES.index(self.metric_name)
        return self._values[idx] >= other._values[idx]
