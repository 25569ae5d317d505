"""Benchmark-submission export (counterpart of rmnet_tpu/core/inference.py,
reference core/inference.py:21-71): the TEST subset through
``multi_scale_inference``, one palette PNG per frame under
``DIR.OUTPUT_DIR/benchmark/<CONST.EXP_NAME>/<video>/%05d.png``."""

from __future__ import annotations

import logging
import os

from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset
from rmnet_tpu_torch.test import engine_from_cfg
from rmnet_tpu_torch.utils.seg_viz import get_segmentation


def inference_net(cfg, save_overlays: bool = False, device=None) -> None:
    """Writes the PNGs of every TEST video; with ``save_overlays``, the
    frames with the objects blended in instead. On the card unless
    ``device`` says otherwise."""
    engine = engine_from_cfg(cfg, device)
    test_loader = DataLoader(
        DatasetCollector.get_dataset(cfg, cfg.DATASET.TEST_DATASET, DatasetSubset.TEST),
        batch_size=1,
        shuffle=False,
        n_workers=cfg.CONST.N_WORKERS,
    )
    norm = {"mean": cfg.CONST.DATASET_MEAN, "std": cfg.CONST.DATASET_STD}
    for idx, (names, n_objects, frames, masks, _) in enumerate(test_loader):
        video_name = names[0]
        _, est_probs = engine.multi_scale_inference(frames[0], masks[0], n_objects[0])
        est_labels = est_probs.argmax(axis=1)  # (T, H, W)

        out_dir = os.path.join(cfg.DIR.OUTPUT_DIR, "benchmark", cfg.CONST.EXP_NAME, video_name)
        os.makedirs(out_dir, exist_ok=True)
        for i in range(est_labels.shape[0]):
            if save_overlays:
                img = get_segmentation(frames[0][i], est_labels[i], norm)
            else:
                img = get_segmentation(None, est_labels[i])
            img.save(os.path.join(out_dir, "%05d.png" % i))
        logging.info("Inference[%d/%d] VideoName = %s", idx + 1, len(test_loader), video_name)
