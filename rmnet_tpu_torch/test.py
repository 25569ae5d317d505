"""Evaluation: each video streamed through the engine, scored with the DAVIS
J&F metrics (counterpart of rmnet_tpu/core/test.py, reference
core/test.py:24-141).

Two modes:
  * standalone (``epoch_idx == -1``): every VAL video, with test-time
    augmentation when ``TEST.FRAME_SCALES`` or ``TEST.FLIP_LR`` ask for it;
  * in-training validation: only ``TEST.TESTING_VIDEOS_INDEXES``, one scale.
Per-video metrics are weighted by the video's object count (reference
core/test.py:104-105). ``TEST.N_STREAMS > 1`` serves that many videos of one
frame size as one batch (``InferenceEngine.run_video_batch``).

A video whose run raises is logged and skipped, as in the reference
(core/test.py:99-101); a batch whose run raises is served again one video at
a time. Both are counted (:class:`EvalStats`) and logged with the summary,
and a sweep in which every video failed raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np

from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.utils.average_meter import AverageMeter
from rmnet_tpu_torch.utils.checkpoint import load_weights_auto
from rmnet_tpu_torch.utils.metrics import Metrics
from rmnet_tpu_torch.utils.profiling import trace_if
from rmnet_tpu_torch.utils.seg_viz import get_segmentation


@dataclasses.dataclass
class EvalStats:
    """What one ``test_net`` sweep did: videos attempted, scored and
    skipped, batches served again one video at a time, frames scored, and
    the host seconds spent in the engine's runs and in ``Metrics.get``."""

    attempted: int = 0
    scored: int = 0
    skipped: int = 0
    batch_fallbacks: int = 0
    frames: int = 0
    engine_s: float = 0.0
    metrics_s: float = 0.0


def engine_from_cfg(cfg, device=None) -> InferenceEngine:
    """An f32 engine with the weights of ``cfg.CONST.WEIGHTS`` (a reference
    .pth), or without them the random weights of ``cfg.CONST.RNG_SEED``;
    on the card unless ``device`` says otherwise."""
    if cfg.CONST.WEIGHTS:
        logging.info("Recovering from %s ...", cfg.CONST.WEIGHTS)
        rm_state, tfn_state, _ = load_weights_auto(cfg.CONST.WEIGHTS)
    else:
        rmnet, tfn = build_models(cfg, cfg.CONST.RNG_SEED, device="cpu")
        rm_state, tfn_state = rmnet.state_dict(), tfn.state_dict()
    return InferenceEngine(cfg, rm_state, tfn_state, device=device)


def test_net(
    cfg,
    epoch_idx: int = -1,
    test_data_loader: Optional[DataLoader] = None,
    test_writer=None,
    engine: Optional[InferenceEngine] = None,
    raise_on_total_failure: bool = True,
    device=None,
    stats: Optional[EvalStats] = None,
) -> Metrics:
    """Scores the VAL subset -> Metrics on ``TEST.MAIN_METRIC_NAME``. Without
    ``engine``, builds one on ``device`` (None: the card) with
    :func:`engine_from_cfg`; ``stats``, when given, is filled in."""
    if engine is None:
        engine = engine_from_cfg(cfg, device)
    if test_data_loader is None:
        test_data_loader = DataLoader(
            DatasetCollector.get_dataset(cfg, cfg.DATASET.TEST_DATASET, DatasetSubset.VAL),
            batch_size=1,
            shuffle=False,
            n_workers=cfg.CONST.N_WORKERS,
        )
    # RMNET_TRACE_DIR=<dir> traces the sweep with torch.profiler
    with trace_if():
        return _test_videos(cfg, epoch_idx, test_data_loader, test_writer, engine,
                            raise_on_total_failure, EvalStats() if stats is None else stats)


def _test_videos(cfg, epoch_idx, test_data_loader, test_writer, engine,
                 raise_on_total_failure, stats: EvalStats) -> Metrics:
    n_videos = len(test_data_loader)
    test_metrics = AverageMeter(Metrics.names())
    fps_meter = AverageMeter()
    n_streams = max(1, int(cfg.TEST.N_STREAMS or 1))

    def score_one(idx, video_name, frames0, masks0, n_objects0, est_labels, fps):
        stats.scored += 1
        stats.frames += est_labels.shape[0]
        gt_labels = masks0.argmax(axis=1)
        tic = time.perf_counter()
        metrics = Metrics.get(est_labels, gt_labels, n_workers=cfg.CONST.N_WORKERS)
        stats.metrics_s += time.perf_counter() - tic
        test_metrics.update(metrics, int(np.max(n_objects0)))
        fps_meter.update(fps)

        if test_writer is not None and idx < 3 and cfg.TEST.VISUALIZE_EVERY > 0:
            norm = {"mean": cfg.CONST.DATASET_MEAN, "std": cfg.CONST.DATASET_STD}
            for i in range(0, est_labels.shape[0], cfg.TEST.VISUALIZE_EVERY):
                est_img = get_segmentation(frames0[i], est_labels[i], norm,
                                           cfg.CONST.IGNORE_IDX)
                gt_img = get_segmentation(frames0[i], gt_labels[i], norm,
                                          cfg.CONST.IGNORE_IDX)
                test_writer.add_image(
                    "%s/Frame%03d" % (video_name, i),
                    np.concatenate((np.array(est_img), np.array(gt_img)), axis=0),
                    epoch_idx,
                )

        logging.info(
            "Test[%d/%d] VideoName = %s FPS = %.2f Metrics = %s",
            idx + 1, n_videos, video_name, fps, ["%.4f" % m for m in metrics],
        )

    def timed(fn, *args):
        tic = time.perf_counter()
        out = fn(*args)
        dt = max(time.perf_counter() - tic, 1e-9)
        stats.engine_s += dt
        return out, dt

    # videos waiting to be served as one batch (TEST.N_STREAMS > 1); a batch
    # holds one frame size, so it closes when the size changes
    pending = []

    def flush_pending():
        if not pending:
            return
        group = list(pending)
        del pending[:]
        try:
            outs, dt = timed(engine.run_video_batch, [(f, m, n) for _, _, f, m, n in group])
        except Exception as ex:
            logging.exception(ex)
            stats.batch_fallbacks += 1
            for item in group:
                serve_one(*item)
            return
        # each video's FPS is the batch's aggregate (the streams finish together)
        agg_fps = sum(o.shape[0] for o in outs) / dt
        for (idx, name, f, m, n), est_labels in zip(group, outs):
            score_one(idx, name, f, m, n, est_labels, agg_fps)

    def serve_one(idx, video_name, frames0, masks0, n_objects0, tta=False):
        try:
            if tta:
                (_, est_probs), dt = timed(engine.multi_scale_inference, frames0, masks0,
                                           n_objects0)
                est_labels = est_probs.argmax(axis=1)  # (T, H, W)
            else:
                est_labels, dt = timed(engine.run_video_labels, frames0, masks0, n_objects0)
        except Exception as ex:  # skip the video (reference core/test.py:99-101)
            logging.exception(ex)
            stats.skipped += 1
            return
        score_one(idx, video_name, frames0, masks0, n_objects0, est_labels,
                  est_labels.shape[0] / dt)

    single_scale = tuple(cfg.TEST.FRAME_SCALES) == (1.0,) and not cfg.TEST.FLIP_LR
    for idx, (names, n_objects, frames, masks, _) in enumerate(test_data_loader):
        # in-training validation visits only the selected videos
        # (reference core/test.py:71-72)
        if epoch_idx != -1 and idx not in cfg.TEST.TESTING_VIDEOS_INDEXES:
            continue
        stats.attempted += 1
        item = (idx, names[0], frames[0], masks[0], n_objects[0])
        if single_scale and n_streams > 1:
            if pending and pending[-1][2].shape[1:3] != frames[0].shape[1:3]:
                flush_pending()
            pending.append(item)
            if len(pending) >= n_streams:
                flush_pending()
            continue
        serve_one(*item, tta=epoch_idx == -1 and not single_scale)
    flush_pending()

    if stats.attempted > 0 and stats.scored == 0 and raise_on_total_failure:
        # every video failed: the engine is broken, not one video
        raise RuntimeError(f"all {stats.attempted} videos failed to evaluate")
    logging.info(
        "[Test Summary] FPS = %.2f Metrics = %s",
        fps_meter.avg(), ["%.4f" % m for m in test_metrics.avg()],
    )
    logging.log(logging.WARNING if stats.skipped or stats.batch_fallbacks else logging.INFO,
                "Skipped videos = %d, batches served again one video at a time = %d",
                stats.skipped, stats.batch_fallbacks)
    if test_writer is not None:
        for i, name in enumerate(Metrics.names()):
            test_writer.add_scalar("Metric/%s" % name, test_metrics.avg(i), epoch_idx)

    return Metrics(cfg.TEST.MAIN_METRIC_NAME, test_metrics.avg())
