"""A synthetic DAVIS-format tree on disk (counterpart of
rmnet_tpu/data/synthetic.py): JPEG frames, palette PNG annotations, .flo
optical flows and a DAVIS.json index, two moving square objects per video.
With the same arguments it writes the JAX package's tree."""

import json
import os
from typing import Sequence, Union

import numpy as np
from PIL import Image

from rmnet_tpu_torch.data.io import write_flo


def make_synthetic_davis(root, n_videos=2, n_frames: Union[int, Sequence[int]] = 4,
                         hw=(64, 96)):
    """Build the tree under ``root``; ``n_frames`` is every video's length or
    one length per video. Returns (index_path, img, ann, flo) dirs."""
    h, w = hw
    lengths = [n_frames] * n_videos if isinstance(n_frames, int) else list(n_frames)
    if len(lengths) != n_videos:
        raise ValueError(f"{len(lengths)} lengths for {n_videos} videos")
    img_dir = os.path.join(root, "JPEGImages/480p")
    ann_dir = os.path.join(root, "Annotations/480p")
    flo_dir = os.path.join(root, "OpticalFlows/480p")
    index = {"train": [], "val": [], "test": [], "test-challenge": []}
    rs = np.random.RandomState(7)
    for v, n in enumerate(lengths):
        name = f"vid{v:02d}"
        for d in (img_dir, ann_dir, flo_dir):
            os.makedirs(os.path.join(d, name), exist_ok=True)
        for i in range(n):
            img = rs.randint(0, 255, (h, w, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(img_dir, name, f"{i:05d}.jpg"))
            mask = np.zeros((h, w), np.uint8)
            # two moving square objects
            y = 8 + 3 * i
            mask[y:y + 16, 10:30] = 1
            mask[y + 4:y + 20, 50:70] = 2
            pm = Image.fromarray(mask, mode="P")
            pm.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
            pm.save(os.path.join(ann_dir, name, f"{i:05d}.png"))
            flow = np.zeros((h, w, 2), np.float32)
            flow[..., 1] = -3.0  # objects moved +3px in y; backward flow -3
            write_flo(os.path.join(flo_dir, name, f"{i:05d}.flo"), flow)
        for subset in index:
            index[subset].append({"name": name, "n_frames": n})
    index_path = os.path.join(root, "DAVIS.json")
    with open(index_path, "w") as f:
        json.dump(index, f)
    return index_path, img_dir, ann_dir, flo_dir
