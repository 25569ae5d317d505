"""A summary writer of JSON lines (counterpart of rmnet_tpu/utils/summary.py,
without its TensorBoard backend): scalars go to ``<log_dir>/<phase>/
scalars.jsonl``, one object per line, images to PNG files beside it."""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
from PIL import Image


class SummaryWriter:
    def __init__(self, log_dir: str, phase: str):
        self.log_dir = os.path.join(log_dir, phase)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, global_step: Optional[int] = None):
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": global_step}) + "\n")
        self._jsonl.flush()

    def add_image(self, tag: str, img_hwc: np.ndarray, global_step: Optional[int] = None):
        """Writes ``img_hwc`` (uint8 RGB) as ``images/<tag>-<step>.png``,
        with the tag's characters outside [A-Za-z0-9_.-] made '_'."""
        name = re.sub(r"[^A-Za-z0-9_.-]", "_", tag)
        path = os.path.join(self.log_dir, "images", f"{name}-{global_step}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(np.asarray(img_hwc, np.uint8)).save(path)

    def close(self):
        self._jsonl.close()
