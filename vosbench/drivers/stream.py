"""Streaming inference: one client, a closed loop of whole videos through
``InferenceEngine.run_video`` (frames and first masks in, per-frame object
probabilities out), each video the next clip of a pool made from the seed.

Set-up: the weights and the pool, the engine, and one video that builds the
kernels and captures the CUDA graphs of this geometry. The window: videos
back to back until the first that finishes after ``--seconds``; each video
is timed from handing over its frames to holding its probabilities. With
``--trace`` a few videos after the first are profiled, and the read's work
is counted on the device. After the window: a sample of the videos served,
drawn from the seed, is run through the plain reference (float32, TF32 off)
on the same weights and inputs. The reference takes each frame from the
judged run's previous probabilities (teacher forcing): a box decision that
rounding flips then costs one frame's gap, not the rest of the video's. The
gaps are also read against a yardstick, the reference computed with float8
operands and judged alike on the same clip, and against the reference's own
run over the first ``free_frames`` frames (``workloads/<cell>.json``).
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from vosbench import harness, inputs, work
from vosbench.reference import rmnet_ref
from vosbench.trace import Tracer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def frame_gaps(got: torch.Tensor, ref: torch.Tensor):
    """The mean gap of each frame 1..len(ref)-1 of a run's probabilities
    ``got`` (T, K, H, W) to the reference's ``ref`` (frame 0 is the given
    masks)."""
    return [float((got[t].float() - ref[t].float()).abs().mean(dtype=torch.float64))
            for t in range(1, len(ref))]


def carried(c, probs: torch.Tensor) -> torch.Tensor:
    """The state a run carries from a frame to the next: its probabilities
    in the configuration's compute dtype (the engine keeps the previous
    mask in it)."""
    return probs.to(DTYPES[c["dtype"]]).float()


def _video(clip, dev):
    frames, masks, n_objects = clip
    return torch.from_numpy(frames).to(dev), torch.from_numpy(masks).to(dev), n_objects


def judge_run(c, rm, tfn, clip, got: torch.Tensor, dev):
    """Per-frame gaps of a run's probabilities ``got`` (T, K, H, W) on
    ``clip`` to the reference, which takes every frame from the previous
    frame's state of the run it judges (teacher forcing)."""
    ref = rmnet_ref.infer(rm, tfn, *_video(clip, dev), c["memorize_every"],
                          follow=carried(c, got))
    return frame_gaps(got, ref)


def below(c, rm, tfn, clip, dev):
    """Per-frame gaps of the reference computed with float8 e4m3 operands
    (the precision below the configuration's bfloat16, the control), judged
    as a run is: the yardstick of ``prob_gap_ratio`` on this clip."""
    with rmnet_ref.computed_in(rmnet_ref.fp8_e4m3, rm, tfn):
        probs = rmnet_ref.infer(rm, tfn, *_video(clip, dev), c["memorize_every"])
    return judge_run(c, rm, tfn, clip, probs, dev)


def free_gaps(c, rm, tfn, clip, got: torch.Tensor, n_frames: int, dev):
    """Per-frame gaps of a run's first ``n_frames`` frames to the
    reference's own run over them (no teacher forcing)."""
    ref = rmnet_ref.infer(rm, tfn, *_video(clip, dev), c["memorize_every"],
                          stop=n_frames + 1)
    return frame_gaps(got, ref[:n_frames + 1])


def numbers(gap, yardstick=None, free=None) -> dict:
    """The numbers of one video that a cell may compare, from its per-frame
    gaps to the teacher-forced reference: ``prob_gap_mean`` and
    ``prob_gap_frame``, their mean and largest; with the float8 yardstick's
    gaps on the same clip, ``prob_gap_ratio``, the run's median frame gap
    over the yardstick's (a box decision that rounding flips moves a frame,
    not the median), and ``prob_gap_first_ratio``, the same of frame 1, the
    start, which takes nothing of the run's state; with ``free``, the gaps
    to the reference's own run, ``prob_gap_free``, their mean."""
    out = dict(prob_gap_mean=float(np.mean(gap)), prob_gap_frame=max(gap))
    if yardstick is not None:
        out.update(prob_gap_ratio=float(np.median(gap) / np.median(yardstick)),
                   prob_gap_first_ratio=gap[0] / yardstick[0])
    if free:
        out["prob_gap_free"] = float(np.mean(free))
    return out


def reference_numbers(cell, rm_sd, tfn_sd, clips, dev):
    """Each (clip, probabilities) pair judged against the reference -> a
    list of ``numbers`` dicts; the float8 yardstick where the cell compares
    a ratio, the free-running gaps over the cell's ``free_frames``."""
    c = cell.config
    ratio = any(k.endswith("_ratio") for k in cell.limits)
    n_free = cell.judge.get("free_frames", 0)
    rm, tfn = rmnet_ref.on_device(rm_sd, tfn_sd, dev, c["bbox_loose_pixels"],
                                  c["n_pts_threshold"], c["prob_threshold"])
    out = []
    with harness.no_tf32():
        for clip, probs in clips:
            got = torch.as_tensor(probs).to(dev)
            out.append(numbers(judge_run(c, rm, tfn, clip, got, dev),
                               below(c, rm, tfn, clip, dev) if ratio else None,
                               free_gaps(c, rm, tfn, clip, got, n_free, dev) if n_free else None))
            del got
    return out


def make_engine(c, rm_sd, tfn_sd, dev):
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    return InferenceEngine(
        Config(), rm_sd, tfn_sd, memorize_every=c["memorize_every"],
        capacity=c["memory_capacity"], dtype=DTYPES[c["dtype"]], chunk=c["chunk"],
        use_flash_attention=c["flash_attention"], device=dev,
        apply_overrides=dict(prob_threshold=c["prob_threshold"],
                             n_pts_threshold=c["n_pts_threshold"],
                             n_bbox_loose_pixels=c["bbox_loose_pixels"]))


def make_pool(c, tr, seed, dev):
    return [inputs.stream_clip(seed, i, tr["frames"], c["frame_height"], c["frame_width"],
                               tr["appear"], dev, tr.get("object_size"))
            for i in range(tr["pool"])]


def run(cell, opt: harness.Options) -> harness.Run:
    import rmnet_tpu_torch.models.rmnet as rmnet_mod

    c, tr = cell.config, cell.traffic
    dev = torch.device(opt.device)
    sync = harness.synchronizer(dev)
    reset_peak, peak = harness.memory(dev)
    T = tr["frames"]
    rm_sd, tfn_sd = inputs.weights(opt.seed, dev, c["bbox_loose_pixels"],
                                   c["n_pts_threshold"], c["prob_threshold"])
    pool = make_pool(c, tr, opt.seed, dev)
    tracer = Tracer(sync) if opt.trace else None
    counted = work.ReadWork(rmnet_mod, dev) if opt.trace else contextlib.nullcontext()
    with counted:
        engine = make_engine(c, rm_sd, tfn_sd, dev)
        engine.run_video(*pool[0])  # builds the kernels, captures this geometry's graphs
        sync()
        setup_s = time.perf_counter() - opt.t0
        setup_peak = peak()
        reset_peak()

        sample = harness.Reservoir(opt.seed, tr["sampled_videos"])
        walls, traced, read_work = [], [], {}
        first, n_traced = tr["trace_after"], tr["traced_videos"]
        replays0 = engine.replays
        start = time.perf_counter()
        while True:
            n = len(walls)
            if tracer is not None and n == first:
                counted.zero()
                tracer.start()
            clip = pool[n % len(pool)]
            t = time.perf_counter()
            probs = engine.run_video(*clip)
            walls.append(time.perf_counter() - t)
            if tracer is not None and tracer.active and n == first + n_traced - 1:
                tracer.stop()
                read_work = counted.read()
                traced = walls[first:]
            sample.offer((n % len(pool), probs))
            del probs
            if time.perf_counter() - start >= opt.seconds and not (
                    tracer is not None and (tracer.active or n < first)):
                break
        window_s = time.perf_counter() - start
        videos = len(walls)
        replays = engine.replays - replays0
        window_peak = peak()
        del engine
    summary = None
    if tracer is not None:
        summary = tracer.summary()
        summary.units = n_traced * (T - 1)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    harness.note("window", harness.spread_note(walls))
    picked = [(pool[i], probs) for i, probs in sample.items.values()]
    results = reference_numbers(cell, rm_sd, tfn_sd, picked, dev)
    for (i, _), r in zip(sample.items.items(), results):
        harness.note(f"video {i} against the reference", r)
    limits = cell.limits
    failed = sum(not harness.judge({k: (r[k], limits.get(k)) for k in limits})
                 for r in results)
    checks = {k: (max(r[k] for r in results), limits[k]) for k in limits}
    untraced_s = sum(walls) - sum(traced)
    return harness.Run(
        kind="stream", setup_s=setup_s, window_s=window_s, attempted=videos, failed=failed,
        counts=dict(videos=videos, frames=videos * (T - 1), replays=replays,
                    traced_videos=len(traced)),
        walls=walls, peak_bytes_window=window_peak,
        peak_bytes_process=max(setup_peak, window_peak),
        checks=checks, correct=bool(limits) and failed == 0 and harness.judge(checks),
        device=harness.device_info(dev), trace=summary, read_work=read_work,
        flops_untraced=(videos - len(traced)) * work.video_flops(
            T, c["frame_height"], c["frame_width"], tr["appear"], c["memorize_every"]),
        untraced_s=untraced_s, peak_flops=work.PEAK_FLOPS[c["dtype"]])
