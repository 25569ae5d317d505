"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, check them,
run inference and training through them.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --ab OTHER_CHECKOUT [--blocks 2]

The second form only times the main path's engine of this checkout and of
another (for example the parent commit, unpacked with ``git archive`` into a
directory that .gitignore lists) in turns, blocks of other, this, this,
other, each run a fresh process that measures with this file's code (phase
ab); it writes build/chip_smoke/engine_ab.json.

Phases, in order (each raises on failure; nothing is caught):
  device  require CUDA, print the card's name and power limit;
  build   build rmnet_tpu_torch/csrc/flash_read_{fwd,bwd}.cu with nvcc for
          sm_90a (one nvcc each, started together); registers, spills and
          shared memory of each; the tensor-core (HMMA, HGMMA) instructions of
          each kernel in the built SASS (cuobjdump; fails on 0 in a forward main
          kernel or a backward kernel);
  kernel  hold the flash-read forward (main and merge kernels) against its
          plain PyTorch version and against the plain split and merge at the
          wrapper's split count, at the main-path shapes, the streams
          phase's largest read (16 rows, S=33), the eval phase's (10 rows,
          S=33, f32), the graphs phase's (S=3), the training read in f32
          and bf16 and phase dp's reads (6 rows in f32 and bf16, 3 rows in
          f32), phase spatial's query shard (30x27 rows against a 30x54
          bank of S=12, f32 and bf16), phase hybrid's (30x15 rows of 6
          objects' rows against a 30x30 bank of S=3, f32 and bf16, and the
          same read by a rank that holds no column: Q = 0, no launch, an
          empty output and lse) (f32 at
          2e-4; bf16 within 1e-2 of the plain output's largest magnitude;
          lse at 2e-4); two calls at S33_bf16, at both training reads and at
          each query shard in both types give bit-identical out and lse;
  kernel_bwd  hold the backward kernel against its plain version on the same
          cases but the inference-only ones, the query shards among them (dQ,
          dK, dV each within 1e-4 of the plain gradient's largest magnitude
          in f32, 1e-2 in bf16; at Q = 0 no launch, an empty dQ and zero
          dK, dV); two calls on the f32 training read and on
          each query shard in both types give bit-identical gradients;
  engine  480x854, 2 objects, memorize_every=5, T=48, bf16, flash read, auto
          capacity, random weights, the chunk step captured as a CUDA graph
          and replayed per chunk: labels, the forward launches replayed
          (one per chunk step, padded steps included: 48), and one f32 step
          through the kernel read against the dense read (the read's output
          at 2e-4, the probabilities at 1e-3);
  times   engine per-frame ms / FPS and graph replays per video, and
          run_video_raw's; the kernel, its plain version and
          scaled_dot_product_attention over the dense bank, all on the
          inputs of the engine's last flash read; the kernel's bound; its
          ms by CUDA kernel (main, merge); the work its kernels execute by
          the design's count beside the useful work (fails past 1.3x);
  profile device time per frame by kernel kind over graph replays
          (torch.profiler), the device's busy share; the kernel table in
          build/chip_smoke/profile.txt;
  graphs  a 12-frame 480x854 clip, memorize_every 5, capacity 2 (the ring
          wraps): the graphed engine against the engine's chunk function run
          eagerly on the card, bit-identical probabilities and labels, at
          bf16 and at f32 (TF32 off); then update_weights to the weights of
          seed 1 and a replay, bit-identical to a fresh engine with them;
  raw     run_video_raw against run_video_labels on one uint8 clip with an
          ignore region (f32, T=16): label mismatch share below 2e-3;
  tta     multi_scale_inference with scales (1.0, 0.75) and the flip, T=12;
  train   the reference training shape at full width (B=4, T=3, 3 objects,
          465x465, f32, flash read, frozen BN, Adam at lr 1e-5): the first
          step's gradient through the flash read against the dense read
          (per tensor within 1e-3), and the backward kernel against its
          plain version on that step's reads; 1 warm-up and 5 timed steps,
          finite losses, parameters that change, T-1 = 2 forward and 2
          backward kernel launches per step; the gradient comparison again
          after the steps, reported only, beside the flash step run twice;
  train_times  ms per step, clips/s, peak memory; the forward kernel, its
          plain version and scaled_dot_product_attention at the step's last
          read (f32), with its bound and executed work; the backward kernel,
          its plain version and the backward of scaled_dot_product_attention
          at the same read; the backward's bound and the work its kernels
          execute by the design's count (chip_bwd_probe.py counts it on the
          card); one step profiled
          (build/chip_smoke/profile_train.txt);
  train_net  the training entry points on a synthetic DAVIS tree of three
          480x854 videos of 12 frames (build/chip_smoke/train_net): train_net
          in process at the reference's TRAIN (B=4, T=3, 3 objects, resize
          480, 465x465 crops, the default augmentation, REMAT "encoders",
          flash read, f32 with TF32 as torch defaults it, Adam at 1e-5),
          'DAVISx4' = 3 batches per epoch, 2 epochs, N_WORKERS=4: finite
          losses, 0 batches skipped, T-1 forward and T-1 backward launches per
          step, ckpt-epoch-001/002 and ckpt-best written; BatchTime and
          DataTime (median over epoch 2), the card's busy share over epoch 2's
          training loop (build/chip_smoke/profile_train_net.txt), validation
          seconds per epoch, peak memory, bytes uploaded per batch, the TRAIN
          pipeline's host time per clip by stage on one thread; the CLI's
          --test on ckpt-best.pth within 5e-5 of the best in-training
          validation, run beside the CLI trained for one epoch and stopped by
          SIGTERM after its first batch (exit 0, ckpt-interrupt.pth at the
          epoch before), then resumed from that file (it starts at the
          interrupted epoch with the saved Adam state, exit 0); one timed
          step each of REMAT "none", "encoders", "step" and of
          GRAD_ACCUM_STEPS=2 on the train phase's batch (TF32 off), ms and
          peak memory, each mode's gradient against "none" per tensor within
          1e-3 (the escape of the train phase), "none" twice as the floor;
  eval_server  the eval server on train_net's checkpoints (TF32 as torch
          defaults it): eval_server in process on a hard-linked copy of
          them, two polls and a stop event: every checkpoint scored by one
          engine (the later ones through update_weights), each within 5e-5
          of test_net on a fresh engine, the best kept and the rest pruned,
          the forward launches replayed = the chunk steps of every sweep;
          seconds per checkpoint, first and later; then ``python -m
          rmnet_tpu_torch.runner --eval-server --ckpt-dir`` as a process on
          another copy until its log shows every checkpoint evaluated
          (within 5e-5 of the in-process scores), stopped by SIGTERM: exit 0;
  train_bf16  TRAIN.BF16 at the reference TRAIN shape: the bf16 step's loss
          and gradients against the f32 step's (TF32 off) on the same batch
          and weights (loss within 2e-3 relative; per tensor max|bf16 - f32|
          within 0.1 of max|f32|, the median over tensors within 0.04); one
          step with the counts at 0: T-1 forward and T-1 backward read
          launches with bf16 keys, values, queries, output and cotangent,
          every convolution bf16 x bf16 forward and backward (a torch
          dispatch mode); ms, clips/s and peak memory at bf16, f32 TF32 off
          and f32 TF32 on; the bf16 step profiled
          (build/chip_smoke/profile_train_bf16.txt; convolution kernels' ms
          by the type in their names); both kernels against their plain
          versions and timed (plain, SDPA, bound) at the bf16 step's last
          read; trainable BN at bf16: statistics bit-identical across REMAT
          "none" (twice), "encoders" and "step", all moved, a NaN batch
          leaving parameters, statistics and moments as they were, the step
          timed and profiled (build/chip_smoke/profile_train_bn.txt) and at
          f32; one train_net epoch with TRAIN.BF16 and TRAIN.USE_BATCH_NORM
          on the train_net tree: finite losses, an f32 checkpoint whose
          running statistics all moved;
  dp      TRAIN.DATA_PARALLEL on the one card (build/chip_smoke/dp): train_net
          at DATA_PARALLEL = 2 (two gloo ranks on cuda:0, TF32 off) in a
          process of its own over train_net's tree, 2 epochs, stopped by
          SIGTERM after epoch 2's first batch (exit 0, ckpt-interrupt.pth at
          epoch 1), beside single-process train_net for one epoch in this
          process: epoch 1's logged losses within 1e-3 relative, one
          validation, ckpt-best.pth only; then two gloo ranks on cuda:0 at
          the reference TRAIN batch (two rows a rank), TF32 off, one step
          each of f32, GRAD_ACCUM_STEPS = 2, USE_BATCH_NORM, and
          USE_BATCH_NORM with BF16 against the Trainer's single-process
          step on the same weights and batch: the loss within 5e-5
          relative (trainable BN: 1e-4; bf16: 2e-3, phase train_bf16's
          bar); the gradients within 1e-3 per tensor as phase train's (with
          trainable BN they are reported beside the single step run twice:
          the JAX layer's E[x^2] - mean^2 in float32 cancels, and BN's
          backward amplifies it; tests/test_torch_dp.py holds the layer
          exactly in float64); BN's statistics within 1e-3 of each tensor's
          largest value (bf16: 2e-2); replicas bit-identical, the reads'
          launches per rank, collectives counted by kind; ms per DP step,
          peak memory per rank, and each collective alone (ms, bytes); and,
          while the train_net process runs, an NCCL group of one in this
          process against the Trainer's step (the same loss bit for bit,
          gradients within 1e-3, parameters bit-identical wherever the
          gradients are);
  spatial spatial_forward_video (width-sharded whole-clip inference) on the
          one card (build/chip_smoke/spatial): the single forward_video
          first, in this process, then two gloo ranks on cuda:0 (27 of
          the 54 /16 columns each), 480x854, T=12, 2 objects
          (the second appearing at frame 4), memorize_every 5, seeded flows
          of up to 24 columns, flash read, f32 with TF32 off and cuDNN
          deterministic, the weights of seed 0: every rank's estimate of the
          whole clip within 1e-4 of the single forward's, every frame's
          boxes (memorize's and the warped mask's) equal as integers, a
          repeated call bit-identical and building no new plan, T-1 read
          launches per rank; ms per frame against the single forward, peak
          memory per rank, the collectives per frame by kind (calls, bytes,
          ms); the read at its query shard timed (kernel, plain, SDPA over
          the dense bank, bound);
  hybrid  hybrid batch x width training (make_hybrid_mesh, build/chip_smoke/
          hybrid): the Trainer's single-process step first, in this process,
          then a 2 x 2 grid of gloo ranks on cuda:0 (2 rows and 15 of the 30
          /16 columns a rank) at the reference TRAIN (B=4, T=3, 3 objects,
          465x465, full-width RMNet, flash read, REMAT "encoders", f32 with
          TF32 off and cuDNN deterministic, Adam at 1e-5, the weights of seed
          0): the grid's step against the single step (the loss within 5e-5
          relative, each gradient tensor within 5e-4 of its norm or 1e-6 of
          the largest gradient: tests/test_parallel.py's bar), T-1 = 2
          forward and 2 backward read launches per rank at the query shard,
          3 timed steps after it with finite losses and the 4 replicas
          bit-identical after them; ms per step against the single step's,
          collectives per step by kind (calls, MB, ms), peak memory per rank
          against the single step's; one step with USE_BATCH_NORM (loss
          within 1e-4, statistics within 1e-3: phase dp's bars); variant
          columnless, one f32 step at the crop's columns 200-215 (one /16
          column, held by the first space rank of each row, none by the
          second) within tests/test_parallel.py's bar, 2 forward and 2
          backward read launches on the holding ranks and none on the
          others, timed as the f32 step is; on every rank the single
          step's parameters carry a gradient; the forward and the backward timed at the query shard
          (kernel, plain, SDPA, bound);
  hybrid_tfn  TinyFlowNet's step on the same grid (build/chip_smoke/hybrid):
          the single step, then the reference TRAIN batch at 465x465 padded
          to 512x512, 4 of the 8 /64 columns a rank, held to
          tests/test_parallel.py's bar, 3 timed steps with finite losses and
          the replicas bit-identical after them; ms per step against the
          single step's, the halos, gathers and gradient bucket per step
          (calls, MB, ms), peak memory per rank; no read launch;
  eval    the evaluation and export entry points at 480x854: a synthetic DAVIS
          tree of three VAL videos (24, 17 and 9 frames; a third object
          appears in the second at frame 8), a reference-format checkpoint
          of the random weights and a config file (build/chip_smoke/eval);
          ``python -m rmnet_tpu_torch.runner --test`` and ``--inference`` as
          processes, started together: both exit 0, the test run's summary
          J&F in [0, 1]; then, with TF32 as torch leaves it (the CLI's
          setting), test_net in process on the engine the CLI builds (f32,
          K = TEST.N_MAX_OBJECTS + 1 = 11 slots): its scores within 5e-5 of
          the CLI's printed ones, each video's labels bit-identical to
          run_video_labels on the same engine, forward launches replayed =
          chunk steps, the largest read at the eval_N10_S33_f32 kernel case,
          no video skipped and no batch served again (also at N_STREAMS=2);
          the sweep's wall, the engine's, the loader's decode and
          Metrics.get per frame, graph captures and their seconds, the busy
          share (build/chip_smoke/profile_eval.txt); every PNG of
          --inference equal to the argmax of multi_scale_inference; the
          forward timed at a read of the path (from an eager run); the
          2-stream sweep's labels against the 1-stream sweep's, with TF32
          on and, on a second engine, off (reported);
  streams lockstep N = 1, 2, 4, 8 at 480x854, T=48, bf16: aggregate FPS and
          peak memory; at f32 (T=16) each batched stream against the stream
          served alone, and a ragged run_video_batch of three lengths with
          mixed schedules against each video alone: frame 1's
          probabilities within 1e-4, the clip's label mismatch share below
          2e-3 (STREAM_PROB_TOL, STREAM_LABEL_BUDGET); what differs with the
          batch (batch_variance: the leaf modules where the batch enters);
          the same runs again with one split count for every read and cuDNN
          off (pinned_splits, without_cudnn): every stream bit-identical to
          itself alone.
Every engine run holds the forward launches replayed to the chunk steps of
its chunk plan (``counted``).

Prints the card's name and power limit, the kernel table as one JSON line
before the last, and as the last line {"ok": true, "device": {...}}. The
numbers also go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
H100_BF16_FLOPS = 989e12   # tensor cores
# float32 products at float32 accuracy: 3xTF32 on the tensor cores, three
# TF32 passes (495 TFLOP/s) per product, beats the CUDA cores' 67 TFLOP/s
H100_F32_FLOPS = 495e12 / 3
H100_BYTES = 3.35e12       # HBM3 bytes per second

# the main path (bench.py's protocol)
T_FRAMES, HEIGHT, WIDTH, N_OBJECTS, MEMORIZE_EVERY = 48, 480, 854, 2, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    if not (ROOT / "rmnet_tpu_torch" / "csrc" / "flash_read_fwd.cu").exists():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# the forward's main kernels, one per input type; the merge kernel is a template
FWD_MAIN_KERNELS = ("bf16", "f32")


def phase_build() -> dict:
    """Build both kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from rmnet_tpu_torch.ops.flash_attention import BWD_LIBRARY, LIBRARY

    libs = (LIBRARY, BWD_LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(force_build=True), libs))
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"build: {lib.path.name} in {lib.build_seconds:.2f} s, dynamic shared "
            f"memory {lib.smem_bytes()} bytes per block (largest kernel)")
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "error", "warning")):
                log(f"  ptxas: {line.strip()}")
    hmma = {lib.name: sass_mma_counts(lib) for lib in libs}
    for name, counts in hmma.items():
        for kernel, count in counts.items():
            log(f"build: {name} {kernel}: {count} tensor-core instructions (HMMA, HGMMA) "
                f"in the SASS")
    # every kernel but the forward's merge (a weighted sum of the splits) is a product
    fwd, bwd = hmma[LIBRARY.name], hmma[BWD_LIBRARY.name]
    products = [fwd.get(k, 0) for k in FWD_MAIN_KERNELS] + list(bwd.values())
    if len(bwd) != 6 or not all(products):
        raise AssertionError(f"kernels without tensor-core instructions: {hmma}")
    return dict(seconds={lib.name: lib.build_seconds for lib in libs}, fwd_hmma=fwd,
                bwd_hmma=bwd)


def _kernel_name(mangled: str) -> str:
    """The short name of a flash-read kernel from its mangled name: 'ds<float>'
    for flash_read_bwd_ds_kernel<float>, 'bf16' for flash_read_fwd_bf16_kernel,
    'merge<bf16>' for flash_read_fwd_merge_kernel<__nv_bfloat16>."""
    m = re.search(r"flash_read_(?:fwd|bwd)_([a-z0-9]+)_kernel(?:I(f|13__nv_bfloat16)E)?",
                  mangled)
    if m is None:
        raise AssertionError(f"unexpected kernel in a flash-read library: {mangled}")
    if m.group(2) is None:
        return m.group(1)
    return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}>"


def sass_mma_counts(lib) -> dict:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) per kernel in
    the SASS of ``lib``'s build, read with cuobjdump."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _kernel_name(line.split("Function :")[1].strip())
            counts[kernel] = 0
        elif kernel is not None and ("HMMA" in line or "HGMMA" in line):
            counts[kernel] += 1
    return counts


# ----------------------------------------------------------------- kernel
# Kernel against plain version: f32 out and lse at 2e-4 (the read's tolerance
# in tests/test_flash_attention.py). In bf16 the kernel rounds P to bf16 for
# P V, as the TPU kernel does (p.astype(v.dtype)), where the plain version
# keeps P in f32, and both round the output once: a relative error of at most
# 2^-9 per weight, summed over positions of random sign, plus an output ulp
# (max|plain|/128), so max|out - plain| <= 1e-2 * max|plain|. lse comes from
# the unrounded f32 P in both, hence 2e-4 in either type.
F32_TOL, BF16_REL_TOL = 2e-4, 1e-2


def bank_case(N, S, h, w, dtype, seed, invalid=(), all_invalid_row=None, loose=64,
              q_cols=None, row_invalid=None, ring=None):
    """Bank-like read inputs on the card at /16 grid (h, w): boxes made as
    memorize makes them (dilated box of a thresholded mask, rasterized on
    the /16 grid), k/v zero outside the boxes, some slots invalid; with
    ``q_cols`` (start, end) the query holds those columns only, as a rank of
    a width mesh reads its shard against the whole bank. ``row_invalid``
    (row, slots): that row's further invalid slots. ``ring`` (slots,
    first): k/v are a view of slots first .. first + S - 1 of a zeroed bank
    of that many slots, as the engine reads its ring."""
    from rmnet_tpu_torch.ops.att_map import _bboxes, _raster_small

    g = torch.Generator().manual_seed(seed)
    Hp, Wp = h * 16, w * 16
    mk = torch.randn(N, S, h, w, 128, generator=g)
    mv = torch.randn(N, S, h, w, 512, generator=g)
    qk = torch.randn(N, h, w, 128, generator=g)
    masks = torch.zeros(N * S, 2, Hp, Wp)
    for i in range(N * S):
        if i % 7 == 3:
            continue  # too few points: whole-frame box
        y0 = int(torch.randint(0, Hp - 8, (1,), generator=g))
        x0 = int(torch.randint(0, Wp - 8, (1,), generator=g))
        hh = int(torch.randint(4, max(5, Hp // 3), (1,), generator=g))
        ww = int(torch.randint(4, max(5, Wp // 3), (1,), generator=g))
        masks[i, 1, y0:y0 + hh, x0:x0 + ww] = 1.0
    boxes = _bboxes(masks, 0.5, 10, loose)                       # (N*S, 2, 4)
    cell = _raster_small(boxes, (h, w), (0, 0), 16, torch.float32)
    cell = cell[:, 1].reshape(N, S, h, w, 1)
    valid = torch.ones(N, S, dtype=torch.bool)
    for s in invalid:
        valid[:, s] = False
    if all_invalid_row is not None:
        valid[all_invalid_row] = False
    if row_invalid is not None:
        valid[row_invalid[0], list(row_invalid[1])] = False
    if q_cols is not None:
        qk = qk[:, :, q_cols[0]:q_cols[1]].contiguous()
    m_key, m_val = (mk * cell).to("cuda", dtype), (mv * cell).to("cuda", dtype)
    if ring is not None:
        slots, first = ring
        bank_k = torch.zeros((N, slots) + m_key.shape[2:], dtype=dtype, device="cuda")
        bank_v = torch.zeros((N, slots) + m_val.shape[2:], dtype=dtype, device="cuda")
        bank_k[:, first:first + S] = m_key
        bank_v[:, first:first + S] = m_val
        m_key, m_val = bank_k[:, first:first + S], bank_v[:, first:first + S]
    return dict(
        m_key=m_key, m_val=m_val, q_key=qk.to("cuda", dtype), slot_valid=valid.to("cuda"),
        bboxes=boxes[:, 1].reshape(N, S, 4).to("cuda"),
    )


# name -> bank_case arguments; h x w = 30 x 54 is 480x854 padded to 480x864,
# /16; S = 33 is the auto capacity 32 plus the ephemeral slot
KERNEL_CASES = {
    "S12_f32": (2, 12, 30, 54, torch.float32, 0, (10, 11)),
    "S33_f32": (2, 33, 30, 54, torch.float32, 1, range(11, 32)),
    "S12_bf16": (2, 12, 30, 54, torch.bfloat16, 2, (10, 11)),
    "S33_bf16": (2, 33, 30, 54, torch.bfloat16, 3, range(11, 32)),
    "S12_f32_row_all_invalid": (2, 12, 30, 54, torch.float32, 4, (), 1),
    "unaligned_7x9_S5_f32": (3, 5, 7, 9, torch.float32, 5, (4,), None, 8),
    "unaligned_7x9_S5_bf16": (3, 5, 7, 9, torch.bfloat16, 6, (4,), None, 8),
    # the training read: N = B*(K-1) = 12 rows, the 465x465 crop padded to
    # 480x480 (30x30), capacity 2 plus the ephemeral slot, the slot being
    # written this frame invalid
    "train_S3_f32": (12, 3, 30, 30, torch.float32, 8, (1,)),
    # the same read of the bf16 training step (TRAIN.BF16)
    "train_S3_bf16": (12, 3, 30, 30, torch.bfloat16, 9, (1,)),
    # the streams phase's largest read: N = 8 lockstep streams of 2 objects
    # (16 rows), S = 33, where fwd_splits takes 6 splits on an H100
    "streams_N16_S33_bf16": (16, 33, 30, 54, torch.bfloat16, 12, range(11, 32)),
    "streams_N16_S33_f32": (16, 33, 30, 54, torch.float32, 13, range(11, 32)),
    # the graphs phase's read: capacity 2 plus the ephemeral slot, the slot
    # being written this frame invalid
    "graphs_S3_bf16": (2, 3, 30, 54, torch.bfloat16, 14, (1,)),
    "graphs_S3_f32": (2, 3, 30, 54, torch.float32, 15, (1,)),
    # the eval phase's read: test_net's f32 engine carries TEST.N_MAX_OBJECTS
    # = 10 object rows per video, S = the auto capacity 32 plus the ephemeral
    # slot; a 24-frame video at memorize_every 5 commits 5 or 6 slots
    "eval_N10_S33_f32": (10, 33, 30, 54, torch.float32, 16, range(6, 32)),
    # the reads of phase dp's ranks: half the training batch a rank (6 rows),
    # a quarter under GRAD_ACCUM_STEPS = 2 (3 rows), at f32 and, with
    # TRAIN.BF16, bf16
    "dp_N6_S3_f32": (6, 3, 30, 30, torch.float32, 17, (1,)),
    "dp_N6_S3_bf16": (6, 3, 30, 30, torch.bfloat16, 18, (1,)),
    "dp_N3_S3_f32": (3, 3, 30, 30, torch.float32, 19, (1,)),
    # the read of phase spatial's ranks: a 30 x 27 query shard (the first of
    # two ranks' columns at 480x854) against the whole bank, capacity 11 plus
    # the ephemeral slot, the slot being written this frame invalid; and bf16
    "spatial_S12_f32": (2, 12, 30, 54, torch.float32, 20, (10,), None, 64, (0, 27)),
    "spatial_S12_bf16": (2, 12, 30, 54, torch.bfloat16, 21, (10,), None, 64, (0, 27)),
    # the read of phase hybrid's ranks: the reference TRAIN crop 465x465
    # padded to 480x480 (30x30 on the /16 grid) on 2 space ranks, rank 0's
    # 30x15 query columns, of its 2 rows x 3 objects (N = 6), against the
    # whole bank of capacity 2 plus the ephemeral slot, the slot being
    # written this frame invalid; and bf16
    "hybrid_N6_S3_f32": (6, 3, 30, 30, torch.float32, 22, (1,), None, 64, (0, 15)),
    "hybrid_N6_S3_bf16": (6, 3, 30, 30, torch.bfloat16, 23, (1,), None, 64, (0, 15)),
    # the same read on a space rank that holds no column (variant columnless
    # of phase hybrid): a query of Q = 0 rows, which launches nothing and
    # gives an empty output and lse, an empty dQ and zero dK/dV
    "hybrid_N6_S3_empty_f32": (6, 3, 30, 30, torch.float32, 24, (1,), None, 64, (0, 0)),
    "hybrid_N6_S3_empty_bf16": (6, 3, 30, 30, torch.bfloat16, 25, (1,), None, 64, (0, 0)),
    # the read of the benchmark's long-video cell: 5 objects, capacity 64
    # plus the ephemeral slot, 21 slots committed; the fifth object, which
    # joined later, 11 of them (1620 positions a slot: slot boundaries fall
    # inside tiles)
    "obj5_N5_S65_bf16": (5, 65, 30, 54, torch.bfloat16, 26, range(21, 64), None, 64, None,
                         (4, range(11, 21))),
    # a view of 5 slots of an 8-slot ring, 63 positions a slot: every tile
    # straddles two slots of the strided bank
    "ring_7x9_S5_bf16": (3, 5, 7, 9, torch.bfloat16, 27, (4,), None, 8, None, None, (8, 2)),
    "S12_bf16_row_all_invalid": (2, 12, 30, 54, torch.bfloat16, 28, (), 1),
}
# inference-only reads that the backward never takes (its plain version
# would hold tens of GB at 10 or 16 rows of S = 33 and at 5 rows of S = 65)
FWD_ONLY_CASES = ("streams_N16_S33_bf16", "streams_N16_S33_f32", "eval_N10_S33_f32",
                  "obj5_N5_S65_bf16")


def read_args(c) -> tuple:
    """The forward kernel's arguments for read inputs ``c``: the inputs and
    their tile metadata."""
    from rmnet_tpu_torch.ops.flash_attention import tile_metadata

    h, w = c["m_key"].shape[2:4]
    _, z, order, counts = tile_metadata(c["slot_valid"], c["bboxes"], h, w)
    return (c["m_key"], c["m_val"], c["q_key"], c["slot_valid"], order, counts, z)


def plain_read(c):
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read_reference

    return flash_memory_read_reference(*read_args(c))


def plain_split_read(c):
    """The plain versions of the forward's two kernels, split and merge, at
    the split count the wrapper takes on this card -> (out, lse, splits)."""
    from rmnet_tpu_torch.ops.flash_attention import (
        flash_read_fwd_merge_reference, flash_read_fwd_partials_reference, fwd_splits_for)

    mk, mv, q, valid, order, counts, z = read_args(c)
    splits = fwd_splits_for(mk, q.device, q.shape[2])
    m, l, acc = flash_read_fwd_partials_reference(mk, mv, q, valid, order, counts, splits)
    out, lse = flash_read_fwd_merge_reference(m, l, acc, z, q.dtype)
    return out.reshape(q.shape[:3] + (out.shape[-1],)), lse, splits


def _read_agreement(out, lse, ref_out, ref_lse) -> tuple:
    """(ok, max |out - ref|, max |ref|, max |lse - ref lse|, tolerance text) at
    the read's tolerances; +inf lse rows must match. A read of no query row
    agrees where both are empty of the same shapes."""
    if ref_out.numel() == 0:
        ok = out.shape == ref_out.shape and lse.shape == ref_lse.shape == (out.shape[0], 0)
        return ok, 0.0, 0.0, 0.0, "empty, of the same shapes"
    o, r = out.float(), ref_out.float()
    err, peak = (o - r).abs().max().item(), r.abs().max().item()
    fin = torch.isfinite(ref_lse)
    same_inf = torch.equal(torch.isfinite(lse), fin) and bool((lse[~fin] == math.inf).all())
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    if out.dtype == torch.bfloat16:
        tol = f"max|out-plain| <= {BF16_REL_TOL} * max|plain|"
        ok = err <= BF16_REL_TOL * peak
    else:
        tol = f"allclose {F32_TOL}"
        ok = torch.allclose(o, r, rtol=F32_TOL, atol=F32_TOL)
    return ok and same_inf and lse_err <= F32_TOL, err, peak, lse_err, tol


def compare_read(name, c) -> float:
    """Kernel against its plain version on ``c`` (on the card), and against
    the plain split and merge at the wrapper's split count; raises past the
    tolerance or unless the wrapper counted exactly one launch (none for a
    query of no row). Returns max |out - plain|."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read

    want = 1 if c["q_key"].shape[2] else 0
    before = flash_memory_read.launches
    out, lse = flash_memory_read(**c)
    torch.cuda.synchronize()
    if flash_memory_read.launches != before + want:
        raise AssertionError(f"{name}: the wrapper counted "
                             f"{flash_memory_read.launches - before} launches, want {want}")
    ok, err, peak, lse_err, tol = _read_agreement(out, lse, *plain_read(c))
    s_out, s_lse, splits = plain_split_read(c)
    s_ok, s_err, _, s_lse_err, _ = _read_agreement(out, lse, s_out, s_lse)
    log(f"kernel {name}: max|out-plain|={err:.3e} max|plain|={peak:.3e} "
        f"max|lse-plain|={lse_err:.3e}; against the plain split and merge ({splits} "
        f"splits) {s_err:.3e}, lse {s_lse_err:.3e} ({tol}, lse {F32_TOL}) "
        f"{'ok' if ok and s_ok else 'FAIL'}")
    if not (ok and s_ok):
        raise AssertionError(f"kernel {name} disagrees with its plain version")
    return err


def check_fwd_deterministic(name) -> None:
    """The forward kernels twice on KERNEL_CASES[name]: bit-identical out and
    lse, or raises."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_fwd

    args = read_args(bank_case(*KERNEL_CASES[name]))
    first = flash_read_fwd(*args)
    second = flash_read_fwd(*args)
    torch.cuda.synchronize()
    same = {k: torch.equal(a, b) for k, a, b in zip(("out", "lse"), first, second)}
    log(f"kernel {name} twice: bit-identical {same} {'ok' if all(same.values()) else 'FAIL'}")
    if not all(same.values()):
        raise AssertionError(f"forward kernel {name} is not deterministic: {same}")


# the forward's determinism cases: the engine's type (at its reads of 2, 5 and
# 16 rows), the training reads' and the width meshes' query shards
FWD_DETERMINISM_CASES = ("S33_bf16", "train_S3_f32", "train_S3_bf16", "spatial_S12_f32",
                         "spatial_S12_bf16", "hybrid_N6_S3_f32", "hybrid_N6_S3_bf16",
                         "obj5_N5_S65_bf16", "streams_N16_S33_bf16")


def phase_kernel() -> None:
    for name, args in KERNEL_CASES.items():
        compare_read(name, bank_case(*args))
    for name in FWD_DETERMINISM_CASES:
        check_fwd_deterministic(name)


# ------------------------------------------------------------- kernel_bwd
# Backward kernel against plain version, for each of dQ, dK, dV:
# max|g - plain| <= tol * max|plain|. f32: 1e-4 (sums of up to Q*M products
# taken in another order; single-pass TF32 lands at 6e-4 or more, which
# chip_bwd_probe.py shows). bf16: both compute in f32 from the same bf16
# inputs and the kernel rounds once, so at most half an ulp, max|plain|/256.
BWD_F32_REL_TOL, BWD_BF16_REL_TOL = 1e-4, 1e-2

# the forward's cases (the training reads among them) but the inference-only ones
BWD_CASES = {k: v for k, v in KERNEL_CASES.items() if k not in FWD_ONLY_CASES}


def bwd_args(c, d_out, out=None, lse=None) -> tuple:
    """The backward kernel's arguments for read inputs ``c`` and cotangent
    ``d_out``, as FlashMemoryRead.backward makes them: the tile metadata,
    the forward's lse (the plain forward's unless given) and D =
    rowsum(dO * O)."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read_reference, tile_metadata

    mk, mv, q, valid = c["m_key"], c["m_val"], c["q_key"], c["slot_valid"]
    h, w = mk.shape[2:4]
    _, z, order, counts = tile_metadata(valid, c["bboxes"], h, w)
    if out is None:
        out, lse = flash_memory_read_reference(mk, mv, q, valid, order, counts, z)
    d_out = d_out.to(q.dtype).contiguous()
    delta = (d_out.float() * out.float()).sum(dim=-1).reshape(lse.shape)
    return (mk, mv, q, valid, order, counts, d_out, lse, delta)


def bwd_case(name):
    """BWD_CASES[name] as backward-kernel arguments, d_out from the seed."""
    c = bank_case(*BWD_CASES[name])
    N, h, w = c["q_key"].shape[:3]
    g = torch.Generator().manual_seed(100 + BWD_CASES[name][5])
    d_out = torch.randn(N, h, w, c["m_val"].shape[-1], generator=g).to("cuda")
    return bwd_args(c, d_out)


def compare_bwd(name, args) -> float:
    """Backward kernel against its plain version on ``args`` (on the card);
    raises past the tolerance or unless the wrapper counted exactly one
    launch (none for a query of no row, whose dQ must be empty and dK, dV
    zero). Returns the largest max |g - plain| of dQ, dK, dV."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd, flash_read_bwd_reference

    empty = args[2].shape[2] == 0
    before = flash_read_bwd.launches
    got = flash_read_bwd(*args)
    torch.cuda.synchronize()
    if flash_read_bwd.launches != before + (0 if empty else 1):
        raise AssertionError(f"{name}: the wrapper counted "
                             f"{flash_read_bwd.launches - before} launches, want "
                             f"{0 if empty else 1}")
    ref = flash_read_bwd_reference(*args)
    bf16 = args[2].dtype == torch.bfloat16
    rel = BWD_BF16_REL_TOL if bf16 else BWD_F32_REL_TOL
    ok, errs, parts = True, [], []
    for gname, g, r in zip(("dQ", "dK", "dV"), got, ref):
        if g.shape != r.shape:
            raise AssertionError(f"{name}: {gname} of shape {tuple(g.shape)}, the plain "
                                 f"version's {tuple(r.shape)}")
        if g.numel() == 0:
            err = peak = 0.0
        else:
            err, peak = (g.float() - r).abs().max().item(), r.abs().max().item()
        good = bool(torch.isfinite(g).all()) and g.dtype == args[2].dtype and err <= rel * peak
        if empty:
            good &= not g.any()
        ok &= good
        errs.append(err)
        parts.append(f"{gname} {err:.3e}/{peak:.3e}")
    log(f"kernel_bwd {name}: max|g-plain|/max|plain| {', '.join(parts)} "
        f"(<= {rel}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"backward kernel {name} disagrees with its plain version")
    return max(errs)


def check_bwd_deterministic(name) -> None:
    """The backward kernel twice on BWD_CASES[name]: bit-identical dQ, dK and
    dV, or raises."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd

    args = bwd_case(name)
    first = flash_read_bwd(*args)
    second = flash_read_bwd(*args)
    torch.cuda.synchronize()
    same = {g: torch.equal(a, b) for g, a, b in zip(("dQ", "dK", "dV"), first, second)}
    log(f"kernel_bwd {name} twice: bit-identical {same} "
        f"{'ok' if all(same.values()) else 'FAIL'}")
    if not all(same.values()):
        raise AssertionError(f"backward kernel {name} is not deterministic: {same}")


# the backward's determinism cases: the training read's and the width
# meshes' query shards
BWD_DETERMINISM_CASES = ("train_S3_f32", "spatial_S12_f32", "spatial_S12_bf16",
                         "hybrid_N6_S3_f32", "hybrid_N6_S3_bf16")


def phase_kernel_bwd() -> None:
    for name in BWD_CASES:
        compare_bwd(name, bwd_case(name))
    for name in BWD_DETERMINISM_CASES:
        check_bwd_deterministic(name)


# ----------------------------------------------------------------- engine
def make_clip(T, H, W, n_obj, seed=0, appear=0):
    """bench.py's synthetic clip (with the defaults): uniform noise frames,
    boxes drifting down. ``seed`` also shifts the boxes; the last object
    appears at frame ``appear`` (never if >= T), with its masks given there."""
    K = n_obj + 1
    rs = np.random.RandomState(seed)
    frames = rs.rand(T, H, W, 3).astype(np.float32) * 2 - 1
    labels = np.zeros((T, H, W), np.uint8)
    x = 150 + 20 * seed
    for t in range(T):
        y = 100 + 2 * t
        labels[t, y:y + 120, x:x + 150] = 1
        if K > 2 and t >= appear:
            labels[t, y + 40:y + 180, x + 300:x + 470] = 2
    masks = np.zeros((T, K, H, W), np.float32)
    for t in {0, min(appear, T - 1)}:
        masks[t] = np.stack([labels[t] == k for k in range(K)])
    n_objects = np.where(np.arange(T) >= appear, n_obj, n_obj - 1).astype(np.int32)
    return frames, masks, n_objects


def counted(eng, fn, T, passes=1):
    """``fn()`` with the forward's counts set to 0 -> (its result, counts).
    Raises unless the forward launches replayed from the engine's graphs
    equal the chunk steps of ``passes`` runs of a T-frame video (of one
    video of each length, T a sequence), padded steps included, and every
    eager launch was a graph's warm-up."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr

    fmr.launches = fmr.captured = fmr.replayed = 0
    replays = eng.replays
    result = fn()
    lengths = [T] if isinstance(T, int) else T
    steps = passes * sum(sum(eng._chunk_plan(t - 1)) for t in lengths)
    counts = dict(eager=fmr.launches, captured=fmr.captured, replayed=fmr.replayed,
                  chunk_steps=steps, graph_replays=eng.replays - replays)
    if fmr.replayed != steps or fmr.launches != fmr.captured:
        raise AssertionError(f"forward launches {counts}: want replayed == chunk steps "
                             f"and eager (warm-up) == captured")
    return result, counts


class _Record:
    """Replaces the function ``name`` that the step calls (a module-level
    name of rmnet_tpu_torch.models.rmnet) with one that keeps the arguments
    and result of each call (``calls``; ``args`` / ``result`` of the last);
    the call itself is unchanged. With ``grads``, each call also keeps the
    gradient that reaches its first output (``d_out``) in a backward pass."""

    def __init__(self, name, grads=False):
        import rmnet_tpu_torch.models.rmnet as rmnet_mod

        self.mod, self.name, self.grads = rmnet_mod, name, grads
        self.real = getattr(rmnet_mod, name)
        self.calls = []

    @property
    def args(self):
        return self.calls[-1]["args"]

    @property
    def result(self):
        return self.calls[-1]["result"]

    def __enter__(self):
        def record(*args, **kwargs):
            result = self.real(*args, **kwargs)
            call = dict(args=(args, kwargs), result=result)
            if self.grads:
                result[0].register_hook(lambda g: call.__setitem__("d_out", g))
            self.calls.append(call)
            return result

        setattr(self.mod, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


# the f32 step that is run twice, and the fixed capacity it runs at
STEP_T, STEP_CAPACITY = 12, 8


def step_agreement(rm_sd, tfn_sd, frames, masks, n_objects) -> tuple:
    """Run an f32 engine's steps to frame STEP_T, then that step twice from
    one state: kernel read and dense read. Returns max |mem diff| of the
    read itself (N, h, w, Cv), max |mem|, and max |est diff| of the
    (1, K, H, W) probabilities; raises past the tolerances."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    eng = InferenceEngine(Config(), rm_sd, tfn_sd, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.float32)
    dev = eng.device
    K = masks.shape[1]
    ks = torch.arange(K, device=dev)
    obj_valid = ((ks >= 1) & (ks <= int(n_objects.max())))[None]
    any_new, commit = eng._video_flags(n_objects, len(frames))

    def flag(x):
        return torch.tensor([bool(x)], device=dev)

    with torch.inference_mode():
        f = torch.from_numpy(frames[:STEP_T + 1]).to(dev).permute(0, 3, 1, 2)
        m = torch.from_numpy(masks[:STEP_T + 1]).to(dev)
        state = eng.apply.init_state(f[:1], m[:1], STEP_CAPACITY)
        for t in range(1, STEP_T + 1):
            frame = f[t:t + 1]
            flow = eng.tflownet.pair_forward(frame, state.prev_frame)
            if t < STEP_T:
                state, _ = eng.apply.step(state, frame, flow, m[t:t + 1], flag(any_new[t]),
                                          flag(commit[t - 1]), obj_valid)
        ests, mems = {}, {}
        for flash, read in ((True, "flash_memory_read"), (False, "_dense_read")):
            apply = dataclasses.replace(eng.apply, use_flash_attention=flash)
            s = dataclasses.replace(state, keys=state.keys.clone(),
                                    values=state.values.clone(),
                                    bboxes=state.bboxes.clone())
            with _Record(read) as rec:
                _, ests[flash] = apply.step(s, frame, flow, m[STEP_T:STEP_T + 1],
                                            flag(any_new[STEP_T]), flag(commit[STEP_T - 1]),
                                            obj_valid)
            mems[flash] = rec.result[0]
    mem_err = (mems[True] - mems[False]).abs().max().item()
    mem_peak = mems[False].abs().max().item()
    est_err = (ests[True] - ests[False]).abs().max().item()
    ok_mem = torch.allclose(mems[True], mems[False], rtol=F32_TOL, atol=F32_TOL)
    log(f"engine: f32 step {STEP_T}, kernel read vs dense read: max|mem diff|={mem_err:.3e} "
        f"max|mem|={mem_peak:.3e} (allclose {F32_TOL}) {'ok' if ok_mem else 'FAIL'}; "
        f"max|est diff|={est_err:.3e} (1e-3) {'ok' if est_err <= 1e-3 else 'FAIL'}")
    if not (ok_mem and est_err <= 1e-3):
        raise AssertionError("kernel read and dense read disagree in an f32 step")
    return mem_err, mem_peak, est_err


def check_labels(labels, masks, T, H, W, n_obj, what) -> None:
    if labels.shape != (T, H, W) or labels.dtype != np.uint8:
        raise AssertionError(f"{what}: labels {labels.shape} {labels.dtype}, want "
                             f"({T}, {H}, {W}) uint8")
    if int(labels.max()) >= n_obj + 1:
        raise AssertionError(f"{what}: label {int(labels.max())} outside [0, {n_obj + 1})")
    if not np.array_equal(labels[0], masks[0].argmax(0)):
        raise AssertionError(f"{what}: frame 0 labels are not the annotation")


def phase_engine(models) -> dict:
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    rm_sd, tfn_sd = models
    T, H, W, n_obj = T_FRAMES, HEIGHT, WIDTH, N_OBJECTS
    frames, masks, n_objects = make_clip(T, H, W, n_obj)
    eng = InferenceEngine(Config(), rm_sd, tfn_sd, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.bfloat16)
    if not (eng.use_flash_attention and eng.capacity == 0 and eng.chunk == 8):
        raise AssertionError("the engine's defaults are no longer flash read, auto "
                             "capacity and chunks of 8")

    # the first run captures the chunk programs (the recorded reads are the
    # captured ones: their tensors hold what the last replay of the last
    # captured program left)
    with _Record("flash_memory_read") as rec:
        t0 = time.perf_counter()
        labels, launches = counted(eng, lambda: eng.run_video_labels(frames, masks, n_objects),
                                   T)
        first_s = time.perf_counter() - t0
    check_labels(labels, masks, T, H, W, n_obj, "engine")
    fg = [float((labels[t] > 0).mean()) for t in (1, T // 2, T - 1)]
    log(f"engine: {T}x{H}x{W} bf16 flash, capacity {eng._capacity_for(T, eng._video_flags(n_objects, T)[1])}, "
        f"chunk plan {eng._chunk_plan(T - 1)}, first run (captures included) {first_s:.2f} s, "
        f"forward launches {launches}, labels {labels.shape} {labels.dtype} max "
        f"{int(labels.max())}, foreground share at t=1, T/2, T-1: {fg}")

    mem_err, mem_peak, est_err = step_agreement(rm_sd, tfn_sd, frames, masks, n_objects)
    return dict(engine=eng, clip=(frames, masks, n_objects),
                launches=launches["eager"] + launches["replayed"], launch_counts=launches,
                read_args=rec.args, step_mem_err=mem_err, step_mem_peak=mem_peak,
                step_err=est_err)


# ------------------------------------------------------------------ times
# device cycles the card sleeps before each timed launch (about 5 ms on an
# H100): the host enqueues the launch meanwhile, so the time between the
# events is the device's alone and not the wrapper's host work
_HOST_AHEAD_CYCLES = 10_000_000


def _time_ms(fn, iters, flush):
    """Median device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (the engine's convs evict the bank between two reads) and a device
    sleep that keeps the host ahead of the device."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_HOST_AHEAD_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inbox_positions(c) -> int:
    """In-box valid memory positions of read inputs ``c``: the positions
    whose keys and values can be nonzero, the work a read needs."""
    h, w = c["m_key"].shape[2:4]
    ys = torch.arange(h, device=c["q_key"].device) * 16
    xs = torch.arange(w, device=c["q_key"].device) * 16
    b = c["bboxes"][:, :, :, None, None]
    cell = ((ys[:, None] >= b[:, :, 2]) & (ys[:, None] <= b[:, :, 3])
            & (xs[None] >= b[:, :, 0]) & (xs[None] <= b[:, :, 1]))
    return int((cell & c["slot_valid"][:, :, None, None]).sum())


def _bound(flops, nbytes, dtype) -> tuple:
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    op_ms, byte_ms = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")


def read_bound(c) -> tuple:
    """Least time for the read on these inputs: the in-box valid memory
    positions' K/V read once, q read once, out and lse written once; the
    operations 2*Q*(Ck+Cv) per such position, at the inputs' peak rate (Q
    the query's rows, fewer than the bank's h*w for a query shard)."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    Cv = mv.shape[-1]
    Q = q.shape[1] * q.shape[2]
    inbox = _inbox_positions(c)
    es = q.element_size()
    flops = 2.0 * Q * inbox * (Ck + Cv)
    nbytes = (inbox * (Ck + Cv) + N * Q * (Ck + Cv)) * es + N * Q * 4
    return (*_bound(flops, nbytes, q.dtype), inbox, flops)


def read_bwd_bound(c) -> tuple:
    """Least time for the read's backward on these inputs: per in-box valid
    position 2*Q*(3*Ck + 2*Cv) operations (S = q.K, dP = dO.V, dV, dK, dQ);
    the bytes of K, V, dK, dV at those positions, q, dO and dQ, lse and D,
    each read or written once (Q the query's rows, fewer than the bank's
    h*w for a query shard)."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    Cv = mv.shape[-1]
    Q = q.shape[1] * q.shape[2]
    inbox = _inbox_positions(c)
    es = q.element_size()
    flops = 2.0 * Q * inbox * (3 * Ck + 2 * Cv)
    nbytes = (2 * inbox * (Ck + Cv) + N * Q * (2 * Ck + Cv)) * es + 2 * N * Q * 4
    return (*_bound(flops, nbytes, q.dtype), inbox, flops)


def read_bwd_executed_flops(args) -> float:
    """The operations the backward kernels execute on ``args`` (the
    backward's arguments) by the design's count, not measured:
    2*64*64*(3*Ck + 2*Cv) per (64-row query block, listed active tile), s
    and dP once each. chip_bwd_probe.py counts the mma instructions on the
    card and holds them to this."""
    mk, mv, q, counts = args[0], args[1], args[2], args[5]
    Ck, Cv = mk.shape[-1], mv.shape[-1]
    query_blocks = -(-q.shape[1] * q.shape[2] // 64)
    return float(counts.sum()) * query_blocks * 2.0 * 64 * 64 * (3 * Ck + 2 * Cv)


# the forward's executed work against the useful work, at most, in bf16
EXECUTED_LIMIT = 1.3


def read_fwd_executed_flops(args) -> float:
    """The operations the forward's main kernel executes on ``args`` (the
    forward's arguments) by the design's count, not measured: per (64-row
    query block, listed active tile) 2*64*64*(2*Ck + Cv) in bf16 (each of the
    two consumer warpgroups computes the same S for its half of the value
    columns) and 2*64*64*(Ck + Cv) in f32 (S once, through shared memory)."""
    mk, mv, q, counts = args[0], args[1], args[2], args[5]
    Ck, Cv = mk.shape[-1], mv.shape[-1]
    s_passes = 2 if q.dtype == torch.bfloat16 else 1
    query_blocks = -(-q.shape[1] * q.shape[2] // 64)
    return float(counts.sum()) * query_blocks * 2.0 * 64 * 64 * (s_passes * Ck + Cv)


def kernel_ms(fn, args, prefix, calls=5) -> dict:
    """Device ms per call of each CUDA kernel named ``prefix``_<name>_kernel
    that ``fn(*args)`` launches (torch.profiler over ``calls`` calls, L2
    warm), by <name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        m = re.search(prefix + r"_([a-z0-9]+)_kernel", e.key)
        if e.device_type == DeviceType.CUDA and m:
            times[m.group(1)] = times.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / calls
    return times


def fwd_time_row(c, flush, limit=EXECUTED_LIMIT) -> dict:
    """The forward on read inputs ``c``: kernel, plain and SDPA ms, the bound,
    the ms by CUDA kernel, the useful and the executed work, the split count
    and the scratch; raises if the executed work passes ``limit`` times the
    useful work in bf16 (None: reported only; the training read's 30x30
    query grid pads 900 rows to 960 and its boxes cover parts of tiles)."""
    from rmnet_tpu_torch.ops.flash_attention import (
        _QUERY_BLOCK, flash_memory_read_reference, flash_read_fwd, fwd_splits_for)

    kargs = read_args(c)
    mk, q, order, counts = kargs[0], kargs[2], kargs[4], kargs[5]
    N, S, h, w, _ = mk.shape
    bound_ms, bound_by, inbox, flops = read_bound(c)
    executed = read_fwd_executed_flops(kargs)
    splits = fwd_splits_for(mk, q.device, q.shape[2])
    qp = -(-q.shape[1] * q.shape[2] // _QUERY_BLOCK) * _QUERY_BLOCK
    row = dict(
        ms=_time_ms(lambda: flash_read_fwd(*kargs), 20, flush),
        plain_ms=_time_ms(lambda: flash_memory_read_reference(*kargs), 5, flush),
        library_ms=_time_ms(sdpa_read(c), 20, flush),
        bound_ms=bound_ms, bound_by=bound_by, useful_gflop=flops / 1e9,
        executed_gflop_by_design=executed / 1e9, inbox_positions=inbox,
        positions=N * S * h * w, active_tiles=int(counts.sum()), tiles=order.numel(),
        splits=splits, scratch_mb=N * splits * qp * (c["m_val"].shape[-1] + 2) * 4 / 1e6,
        by_kernel=kernel_ms(flash_read_fwd, kargs, "flash_read_fwd"),
        shape=dict(N=N, S=S, h=h, w=w, w_q=q.shape[2], dtype=str(q.dtype)))
    ratio = executed / flops
    if q.dtype == torch.bfloat16 and limit is not None and ratio > limit:
        raise AssertionError(f"the forward executes {ratio:.3f}x the useful work, "
                             f"limit {limit}")
    return row


def log_fwd_times(where, row, smi) -> None:
    log(f"time flash_read_fwd at {where}: kernel {row['ms']:.4f} ms (" + ", ".join(
        f"{k} {v:.4f}" for k, v in row["by_kernel"].items()) + " ms by kernel, profiler, L2 "
        f"warm), plain {row['plain_ms']:.4f} ms, sdpa over the dense bank "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({row['useful_gflop']:.2f} GFLOP useful over {row['inbox_positions']} in-box valid "
        f"positions of {row['positions']}; {row['active_tiles']} active tiles of "
        f"{row['tiles']}), {row['useful_gflop'] / row['ms']:.2f} TFLOP/s useful, executed by "
        f"the design's count {row['executed_gflop_by_design']:.2f} GFLOP "
        f"({row['executed_gflop_by_design'] / row['useful_gflop']:.3f}x useful, limit "
        f"{EXECUTED_LIMIT} in bf16), {row['splits']} splits, scratch "
        f"{row['scratch_mb']:.2f} MB; {row['shape']} [{smi}]")


def sdpa_read(c):
    """One PyTorch call for the same function: scaled_dot_product_attention
    over the whole (dense) bank with the slot bias; a yardstick only."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    M = S * h * w
    bias = torch.zeros(N, M, dtype=q.dtype, device=q.device)
    bias.masked_fill_(~c["slot_valid"].repeat_interleave(h * w, dim=1), -math.inf)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q.reshape(N, 1, -1, Ck), mk.reshape(N, 1, M, Ck),
        mv.reshape(N, 1, M, -1), attn_mask=bias[:, None, None, :])


def sdpa_read_bwd(c, d_out):
    """The backward alone of :func:`sdpa_read` with cotangent ``d_out``:
    one PyTorch call for the same gradients; a yardstick only."""
    leaves = {k: c[k].detach().requires_grad_(True) for k in ("m_key", "m_val", "q_key")}
    out = sdpa_read(dict(c, **leaves))()
    grad = d_out.reshape(out.shape).to(out.dtype)
    return lambda: torch.autograd.grad(out, tuple(leaves.values()), grad, retain_graph=True)


def phase_times(smi, run) -> tuple:
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read, tile_metadata

    eng = run["engine"]
    frames, masks, n_objects = run["clip"]
    T = len(frames)
    replays = eng.replays
    walls = _walls(lambda: eng.run_video_labels(frames, masks, n_objects), 3)
    replays = (eng.replays - replays) // 3
    frame_ms = statistics.median(walls) / (T - 1) * 1e3
    log(f"time engine: {frame_ms:.3f} ms/frame, {1e3 / frame_ms:.2f} FPS "
        f"(median of 3 runs of run_video_labels, wall / {T - 1} frames, "
        f"upload and download included), {replays} graph replays per video [{smi}]")
    frames_u8, labels_u8 = raw_clip(frames, masks)
    counted(eng, lambda: eng.run_video_raw(frames_u8, labels_u8, n_objects), T)
    raw_walls = _walls(lambda: eng.run_video_raw(frames_u8, labels_u8, n_objects), 3)
    raw_ms = statistics.median(raw_walls) / (T - 1) * 1e3
    log(f"time engine raw: {raw_ms:.3f} ms/frame, {1e3 / raw_ms:.2f} FPS (median of 3 runs "
        f"of run_video_raw on the uint8 clip, after one that captures) [{smi}]")

    # the engine's last read, at the main path's shapes and data
    args, kwargs = run["read_args"]
    names = ("m_key", "m_val", "q_key", "slot_valid", "bboxes")
    c = dict(zip(names, args), **kwargs)
    err = compare_read("main_path_last_read", c)
    h, w = c["q_key"].shape[1:3]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd = fwd_time_row(c, flush)
    wrapper_ms = _time_ms(lambda: flash_memory_read(**c), 20, flush)
    meta_ms = _time_ms(lambda: tile_metadata(c["slot_valid"], c["bboxes"], h, w), 20, flush)
    log_fwd_times("the engine's last read", fwd, smi)
    log(f"time flash_read_fwd: wrapper with tile metadata {wrapper_ms:.4f} ms (metadata "
        f"alone {meta_ms:.4f} ms), launches per frame replayed "
        f"{run['launch_counts']['replayed'] / (T - 1):.3f} [{smi}]")
    return dict(
        name="flash_read_fwd", route="cuda",
        source="rmnet_tpu_torch/csrc/flash_read_fwd.cu",
        replaces="rmnet_tpu/ops/flash_attention.py:226",
        launches=run["launches"], max_abs_err=err, ms=fwd["ms"], plain_ms=fwd["plain_ms"],
        bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
    ), dict(frame_ms=frame_ms, fps=1e3 / frame_ms, walls_s=walls, replays_per_video=replays,
            raw_frame_ms=raw_ms, raw_walls_s=raw_walls, launches=run["launch_counts"],
            wrapper_ms=wrapper_ms, metadata_ms=meta_ms, fwd_last_read=fwd)


def _walls(fn, n) -> list:
    """Host seconds of ``n`` calls of ``fn``, each after a synchronize (the
    engine's runs end on the host with their output)."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return walls


def raw_clip(frames, masks, ignore=False):
    """The uint8 counterpart of a clip: frames mapped from [-1, 1] to
    0..255, label maps from the one-hot masks (frame 0's annotation, 0
    elsewhere); with ``ignore``, a 255 (ignore) band in every label map."""
    frames_u8 = np.round((frames + 1) * 127.5).astype(np.uint8)
    labels = masks.argmax(axis=1).astype(np.uint8)
    if ignore:
        labels[:, :, :16] = 255
    return frames_u8, labels


# kernel-name patterns of the profile's buckets, first match wins
_BUCKETS = (
    ("flash read kernel", ("flash_read_fwd",)),
    ("flash read backward kernels", ("flash_read_bwd",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    # before the convolutions: cuDNN's own batch norm kernels (bn_fw_inf_*) say cudnn
    ("batch norm", ("batch_norm", "bn_fw")),
    ("convolutions", ("xmma", "implicit_gemm", "conv", "cudnn", "cutlass", "gemm", "wgrad",
                      "dgrad")),
    ("optimizer (Adam)", ("multi_tensor_apply",)),
    ("host copies", ("Memcpy", "Memset")),
)


def profile_engine(smi, run, frame_ms) -> dict:
    """Device time by kernel over one run_video_labels (torch.profiler),
    per frame; the kernel table goes to build/chip_smoke/profile.txt."""
    eng = run["engine"]
    frames, masks, n_objects = run["clip"]
    return profile_device(smi, lambda: eng.run_video_labels(frames, masks, n_objects),
                          len(frames) - 1, "frame", frame_ms, "profile.txt")


def profile_device(smi, fn, n, unit, wall_ms, out_name) -> dict:
    """Device time by kernel over one call of ``fn`` that does ``n`` units
    of work (torch.profiler). Writes the kernel table to
    build/chip_smoke/``out_name`` and prints the time per unit by bucket;
    the busy share is kernel time per unit over ``wall_ms``, the
    unprofiled wall time per unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    buckets = {name: 0.0 for name, _ in _BUCKETS}
    buckets["elementwise and other"] = 0.0
    for e in kernels:
        name = next((b for b, pats in _BUCKETS if any(p in e.key for p in pats)),
                    "elementwise and other")
        buckets[name] += e.self_device_time_total / 1e3 / n
    busy = sum(buckets.values())
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / out_name).write_text(smi + "\n" + "\n".join(
        f"{e.self_device_time_total / 1e3:10.3f} ms x{e.count:<6d} {e.key}" for e in kernels))
    log(f"profile: device kernels {busy:.3f} ms per {unit}, {busy / wall_ms:.1%} of "
        f"the {wall_ms:.3f} ms wall per {unit}, {sum(e.count for e in kernels) / n:.0f} "
        f"kernels per {unit} [{smi}]")
    for name, v in sorted(buckets.items(), key=lambda kv: -kv[1]):
        if v > 0:
            log(f"  {v:8.3f} ms/{unit}  {v / busy:6.1%}  {name}")
    return dict(buckets_ms=buckets, busy_ms=busy, unit=unit,
                kernels_per_unit=sum(e.count for e in kernels) / n)


# ----------------------------------------------------------------- graphs
GRAPH_T, GRAPH_CAPACITY = 12, 2


def eager_probs(eng, frames, masks, n_objects, capacity) -> np.ndarray:
    """The engine's chunk function run eagerly on the card over the whole
    clip as one chunk (no graph, no padding) -> (T, K, H, W) probabilities,
    frame 0's the annotation."""
    T, K = masks.shape[:2]
    dev = eng.device
    any_new, commit = eng._video_flags(n_objects, T)

    def flags(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None]

    with torch.inference_mode():
        f = torch.from_numpy(frames).to(dev)
        m = torch.from_numpy(masks).to(dev)
        state = eng.apply.init_state(f[:1].permute(0, 3, 1, 2), m[:1], capacity,
                                     dtype=eng.dtype)
        ks = torch.arange(K, device=dev)
        obj_valid = ((ks >= 1) & (ks <= int(n_objects.max())))[None]
        inp = dict(frames=f[1:, None], gt=m[1:, None], any_new=flags(any_new[1:]),
                   commit=flags(commit[:-1]), valid=flags(np.ones(T - 1, bool)))
        probs = eng._chunk_fn(state, obj_valid, False, True, inp)[:, 0]
        return torch.cat([m[:1], probs]).cpu().numpy()


def graphed_vs_eager(eng, clip, what) -> dict:
    """The graphed engine's probabilities and labels against eager_probs on
    ``clip``: bit-identical, or raises."""
    frames, masks, n_objects = clip
    T = len(frames)
    probs, counts = counted(eng, lambda: eng.run_video(frames, masks, n_objects), T)
    labels, _ = counted(eng, lambda: eng.run_video_labels(frames, masks, n_objects), T)
    ref = eager_probs(eng, frames, masks, n_objects, GRAPH_CAPACITY)
    ref_labels = ref.argmax(axis=1).astype(np.uint8)
    same_p, same_l = np.array_equal(probs, ref), np.array_equal(labels, ref_labels)
    log(f"graphs {what}: graphed vs eager, probabilities bit-identical {same_p} (max diff "
        f"{np.abs(probs - ref).max():.3e}), labels equal {same_l}; forward launches {counts} "
        f"{'ok' if same_p and same_l else 'FAIL'}")
    if not (same_p and same_l):
        raise AssertionError(f"graphs {what}: the graphed engine differs from the eager chunk")
    return dict(probs=probs, launches=counts)


def graph_engine(models, dtype):
    """The graphs phase's engine: memorize_every 5, capacity GRAPH_CAPACITY."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    return InferenceEngine(Config(), *models, memorize_every=MEMORIZE_EVERY,
                           capacity=GRAPH_CAPACITY, dtype=dtype)


def check_update_weights(eng, clip, before) -> None:
    """update_weights on ``eng`` (its graphs captured) to the weights of
    seed 1, then a run that only replays: bit-identical to a fresh engine
    with those weights and unlike ``before`` (the old weights' output), or
    raises."""
    from rmnet_tpu_torch.models.weights import build_models

    rmnet1, tfn1 = build_models(seed=1)
    new = (rmnet1.state_dict(), tfn1.state_dict())
    eng.update_weights(*new)
    after, counts = counted(eng, lambda: eng.run_video(*clip), len(clip[0]))
    fresh = graph_engine(new, eng.dtype).run_video(*clip)
    same, changed = np.array_equal(after, fresh), not np.array_equal(after, before)
    ok = same and changed and counts["captured"] == 0
    log(f"graphs: update_weights then a replay (no capture: {counts['captured'] == 0}) "
        f"bit-identical to a fresh engine with those weights {same}, outputs changed "
        f"{changed} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("update_weights under the graphs differs from a fresh engine")


def phase_graphs(models) -> dict:
    clip = make_clip(GRAPH_T, HEIGHT, WIDTH, N_OBJECTS)
    report = {}
    for dtype in (torch.bfloat16, torch.float32):
        eng = graph_engine(models, dtype)
        if int(eng._video_flags(clip[2], GRAPH_T)[1][:-1].sum()) <= GRAPH_CAPACITY:
            raise AssertionError("the graphs clip no longer wraps the ring")
        before = graphed_vs_eager(eng, clip, str(dtype))
        report[str(dtype)] = before["launches"]
    check_update_weights(eng, clip, before["probs"])  # the f32 engine
    return report


# ---------------------------------------------------------------- streams
STREAM_COUNTS = (1, 2, 4, 8)
STREAM_CHECK_T = 16  # the f32 equality checks' depth
RAGGED = ((16, 0), (11, 5), (7, 99))  # (length, frame the second object appears)


def stream_clips(n, T, appear=0):
    """``n`` clips of make_clip with seeds 0..n-1, stacked (N, T, ...)."""
    clips = [make_clip(T, HEIGHT, WIDTH, N_OBJECTS, seed=i, appear=appear) for i in range(n)]
    return tuple(np.stack(parts) for parts in zip(*clips))


def phase_streams(smi, models) -> dict:
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    eng = InferenceEngine(Config(), *models, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.bfloat16)
    T = T_FRAMES
    curve = {}
    for n in STREAM_COUNTS:
        frames, masks, n_objects = stream_clips(n, T)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, counts = counted(eng, lambda: eng.run_videos_labels(frames, masks, n_objects), T)
        peak = torch.cuda.max_memory_allocated()
        walls = _walls(lambda: eng.run_videos_labels(frames, masks, n_objects), 2)
        fps = n * (T - 1) / statistics.median(walls)
        curve[n] = dict(aggregate_fps=fps, walls_s=walls, peak_gb=peak / 1e9,
                        peak_over_base_gb=(peak - base) / 1e9, launches=counts)
        log(f"streams: N={n} lockstep {HEIGHT}x{WIDTH} T={T} bf16: aggregate {fps:.2f} FPS "
            f"({fps / n:.2f} per stream; median of 2 runs after the one that captures), peak "
            f"memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
            f"{base / 1e9:.2f} GB held before), forward launches {counts} [{smi}]")
    from rmnet_tpu_torch.ops.flash_attention import fwd_splits_for

    n = max(STREAM_COUNTS)
    mk = torch.empty((n * N_OBJECTS, 33, 30, 54, 128), device="meta")
    if tuple(mk.shape[:4]) != KERNEL_CASES["streams_N16_S33_bf16"][:4]:
        raise AssertionError("the kernel cases no longer hold the streams phase's largest read")
    splits = fwd_splits_for(mk, torch.device("cuda"))
    curve["fwd_splits_at_largest_n"] = dict(
        rows=n * N_OBJECTS, splits=splits, scratch_mb=n * N_OBJECTS * splits * 1664 * 514 * 4 / 1e6)
    log(f"streams: forward at N={n} ({n * N_OBJECTS} rows, S=33, 30x54): {splits} splits, "
        f"scratch {curve['fwd_splits_at_largest_n']['scratch_mb']:.2f} MB")
    del eng
    gc.collect()  # the bf16 engine's graphs and states

    # f32: batched streams against each stream served alone, as served,
    # then with what depends on the batch made independent of it: one split
    # count for every read and cuDNN off
    curve["f32_agreement"] = f32_agreement(models, "as served", check_streams)
    one_stream = torch.empty((N_OBJECTS,) + KERNEL_CASES["S33_f32"][1:4] + (128,),
                             device="meta")
    splits = fwd_splits_for(one_stream, torch.device("cuda"))
    clips = stream_clips(2, 2)
    curve["batch_variance"] = batch_variance(models, clips, "as served")
    witness = f"{splits} splits for every read, cuDNN off"
    with pinned_splits(splits), without_cudnn():
        curve["batch_variance_witness"] = batch_variance(models, clips, witness)
        curve["f32_agreement_witness"] = f32_agreement(models, witness, check_streams_equal)
    return curve


def f32_agreement(models, splits_text, check) -> dict:
    """A fresh f32 engine (its graphs captured here): lockstep N = 2, 4, 8
    at STREAM_CHECK_T and a ragged run_video_batch of RAGGED against each
    stream served alone; ``check(what, rows)`` raises on disagreement."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    f32 = InferenceEngine(Config(), *models, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.float32)
    T, n = STREAM_CHECK_T, max(STREAM_COUNTS)
    frames, masks, n_objects = stream_clips(n, T)
    alone = [counted(f32, lambda: f32.run_video(frames[i], masks[i], n_objects[i]), T)[0]
             for i in range(n)]
    agreement = {}
    for n in STREAM_COUNTS[1:]:
        got, _ = counted(f32, lambda: f32.run_videos(frames[:n], masks[:n], n_objects[:n]), T)
        agreement[n] = [stream_agreement(got[i], alone[i]) for i in range(n)]
        check(f"N={n} f32 lockstep, {splits_text}", agreement[n])
    # ragged lengths and mixed schedules
    vids = []
    for i, (length, appear) in enumerate(RAGGED):
        vids.append(make_clip(length, HEIGHT, WIDTH, N_OBJECTS, seed=i, appear=appear))
    got, counts = counted(f32, lambda: f32.run_video_batch(vids, return_probs=True),
                          max(n for n, _ in RAGGED))
    agreement["ragged"] = []
    for i, v in enumerate(vids):
        single = counted(f32, lambda: f32.run_video(*v), len(v[0]))[0]
        if got[i].shape != single.shape:
            raise AssertionError(f"ragged video {i}: {got[i].shape}, alone {single.shape}")
        agreement["ragged"].append(stream_agreement(got[i], single))
    check(f"ragged run_video_batch of lengths {[n for n, _ in RAGGED]} with the second "
          f"object at {[a for _, a in RAGGED]}, f32, {splits_text} (forward launches "
          f"{counts})", agreement["ragged"])
    return agreement


class pinned_splits:
    """Every forward read made inside takes ``splits`` memory-tile splits,
    whatever its row count: fwd_splits_for is replaced in the wrapper's
    module (the kernel is unchanged). Engines made inside capture their
    graphs with it."""

    def __init__(self, splits):
        import rmnet_tpu_torch.ops.flash_attention as fa

        self.mod, self.splits, self.real = fa, splits, fa.fwd_splits_for

    def __enter__(self):
        self.mod.fwd_splits_for = lambda *args: self.splits
        return self

    def __exit__(self, *exc):
        self.mod.fwd_splits_for = self.real


# Batched against alone at f32 (phase streams). Two choices depend on the
# batch: cuDNN's algorithm per shape (on an H100 at N = 2: TinyFlowNet's
# deconv4 and the memory encoder's res3.1.conv2 round differently) and, past
# 2 streams, the forward's split count (fwd_splits reads the row count). So
# a stream's sums run in another order in a batch; batch_variance finds
# where. Frame 1, segmented against the same ground-truth box, holds
# tests/test_engine_multistream.py's 1e-4 on the probabilities. Later frames
# pass the rounding through the box op's 0.5 threshold and argmax near-ties
# (one stream of eight at N = 8 moved by 2.9e-2 over 5664 pixels), so over
# the clip the labels hold tests/test_engine_raw.py's budget for two
# computations whose inputs differ in the last bits: a mismatch share below
# 2e-3. The witness run takes both choices away (pinned_splits,
# without_cudnn) and holds every stream bit-identical to itself alone.
STREAM_PROB_TOL, STREAM_LABEL_BUDGET = 1e-4, 2e-3


def stream_agreement(got, ref) -> dict:
    """One stream's (T, K, H, W) probabilities batched (``got``) against
    alone (``ref``)."""
    swapped = got.argmax(axis=1) != ref.argmax(axis=1)
    return dict(frame1_max_diff=float(np.abs(got[1] - ref[1]).max()),
                max_diff=float(np.abs(got - ref).max()), swapped=int(swapped.sum()),
                mismatch_share=float(swapped.mean()))


def check_streams_equal(what, rows) -> None:
    """Probabilities bit-identical to the stream alone over the whole clip,
    so labels equal too."""
    ok = all(r["max_diff"] == 0 and r["swapped"] == 0 for r in rows)
    whole = ", ".join(f"{r['max_diff']:.2e}" for r in rows)
    log(f"streams: {what}, each stream against itself alone: labels equal "
        f"{[r['swapped'] == 0 for r in rows]}; max|prob diff| over the clip [{whole}] (0) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: batched streams differ from the streams alone "
                             f"({[r['swapped'] for r in rows]} labels, max|diff| [{whole}])")


def check_streams(what, rows) -> None:
    ok = all(r["frame1_max_diff"] <= STREAM_PROB_TOL
             and r["mismatch_share"] < STREAM_LABEL_BUDGET for r in rows)
    first = ", ".join(f"{r['frame1_max_diff']:.2e}" for r in rows)
    whole = ", ".join(f"{r['max_diff']:.2e}" for r in rows)
    share = ", ".join(f"{r['mismatch_share']:.2e}" for r in rows)
    log(f"streams: {what}, each stream against itself alone: frame 1 max|prob diff| "
        f"[{first}] (<= {STREAM_PROB_TOL}); label mismatch share [{share}] (< "
        f"{STREAM_LABEL_BUDGET}; {[r['swapped'] for r in rows]} pixels); max|prob diff| over "
        f"the clip [{whole}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: batched streams differ from the streams alone")


def batch_variance(models, clips, what) -> dict:
    """Where the batch enters, at f32: one step (frame 1) of the engine's
    chunk function, run eagerly on the card for stream 0 alone and for
    streams 0 and 1 as a batch. Each leaf module's call and the forward
    read, in call order, compared on stream 0's rows: the calls whose
    inputs agree and whose output differs are where the batch changes the
    arithmetic. Also max |diff| of the read and of the probabilities."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    frames, masks, n_objects = clips
    eng = InferenceEngine(Config(), *models, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.float32)
    dev, K = eng.device, masks.shape[2]
    leaves = [(f"{net}.{name}", mod) for net, root in (("rmnet", eng.rmnet),
                                                      ("tflownet", eng.tflownet))
              for name, mod in root.named_modules() if not list(mod.children())]
    alone, calls = [], []

    def rows_diff(b, a):
        if b.shape[0] != 2 * a.shape[0] or b.shape[1:] != a.shape[1:]:
            return math.nan
        return (b[:a.shape[0]].float() - a.float()).abs().max().item()

    def hook(name, record):
        def fn(mod, args, out):
            ins = [x for x in args if torch.is_tensor(x)]
            if record:  # clone: in-place ops after the call may change them
                alone.append((name, [x.clone() for x in ins], out.clone()))
                return
            a_name, a_ins, a_out = alone[len(calls)]
            in_diff = max([rows_diff(x, y) for x, y in zip(ins, a_ins)], default=0.0)
            calls.append((name, in_diff, rows_diff(out, a_out)))
        return fn

    def one_step(n):
        handles = [m.register_forward_hook(hook(name, n == 1)) for name, m in leaves]
        try:
            with torch.inference_mode(), _Record("flash_memory_read") as rec:
                f = torch.from_numpy(np.ascontiguousarray(frames[:n, :2])).to(dev)
                m = torch.from_numpy(np.ascontiguousarray(masks[:n, :2])).to(dev)
                state = eng.apply.init_state(f[:, 0].permute(0, 3, 1, 2), m[:, 0], 32)
                ks = torch.arange(K, device=dev)
                obj_valid = ((ks >= 1) & (ks <= int(n_objects.max())))[None].expand(n, K)
                flag = functools.partial(torch.full, (1, n), device=dev)
                inp = dict(frames=f[:, 1][None], gt=m[:, 1][None], any_new=flag(False),
                           commit=flag(True), valid=flag(True))
                probs = eng._chunk_fn(state, obj_valid.contiguous(), False, True, inp)[0]
                torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        return probs, rec.result[0]

    probs1, read1 = one_step(1)
    probs2, read2 = one_step(2)
    entry = [(name, d) for name, i, d in calls if i == 0 and d > 0]
    out = dict(leaf_calls=len(calls), differing=sum(d > 0 for _, _, d in calls),
               batch_enters=entry[:8], read_max_diff=rows_diff(read2, read1),
               probs_max_diff=rows_diff(probs2, probs1))
    log(f"streams: f32 batch variance ({what}), frame 1 of stream 0 alone vs in a batch of "
        f"2: {out['differing']} of {out['leaf_calls']} leaf-module calls differ; inputs "
        f"equal, output differs: {[(n, f'{d:.2e}') for n, d in entry[:8]]}; the forward "
        f"read max|diff| {out['read_max_diff']:.3e}; probabilities max|diff| "
        f"{out['probs_max_diff']:.3e}")
    return out


class without_cudnn:
    """cuDNN off inside: PyTorch's own CUDA convolutions run, which compute
    each sample of a batch alone (im2col and one GEMM per sample), so no
    convolution's arithmetic depends on the batch size."""

    def __enter__(self):
        self.was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self.was


def phase_raw(models) -> dict:
    """run_video_raw against run_video_labels on one uint8 clip with an
    ignore band, f32: the mismatch share below tests/test_engine_raw.py's
    2e-3 (host and device normalization may differ by an ulp)."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine

    f32 = InferenceEngine(Config(), *models, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.float32)
    T = STREAM_CHECK_T
    frames, masks, n_objects = make_clip(T, HEIGHT, WIDTH, N_OBJECTS)
    frames_u8, labels = raw_clip(frames, masks, ignore=True)
    cst = Config().CONST
    host = (frames_u8.astype(np.float32) / 255.0 - np.asarray(cst.DATASET_MEAN, np.float32)) \
        / np.asarray(cst.DATASET_STD, np.float32)
    onehot = np.stack([labels == k for k in range(N_OBJECTS + 1)], 1).astype(np.float32)
    ref, _ = counted(f32, lambda: f32.run_video_labels(host, onehot, n_objects), T)
    got, counts = counted(f32, lambda: f32.run_video_raw(frames_u8, labels, n_objects), T)
    share = float(np.mean(got != ref))
    log(f"raw: run_video_raw vs run_video_labels (f32, T={T}, a 255 band): mismatch share "
        f"{share:.3e} (< 2e-3) {'ok' if share < 2e-3 else 'FAIL'}; forward launches {counts}")
    if share >= 2e-3:
        raise AssertionError(f"run_video_raw mismatch share {share}")
    return dict(mismatch_share=share, launches=counts)


TTA_T, TTA_SCALES = 12, (1.0, 0.75)


def phase_tta(smi, run) -> dict:
    eng = run["engine"]
    frames, masks, n_objects = (a[:TTA_T] for a in run["clip"])
    test = eng.cfg.TEST
    saved = (test.FRAME_SCALES, test.FLIP_LR)
    test.FRAME_SCALES, test.FLIP_LR = TTA_SCALES, True
    try:
        t0 = time.perf_counter()
        (flows, probs), counts = counted(
            eng, lambda: eng.multi_scale_inference(frames, masks, n_objects), TTA_T,
            passes=2 * len(TTA_SCALES))
        wall = time.perf_counter() - t0
    finally:
        test.FRAME_SCALES, test.FLIP_LR = saved
    K = masks.shape[1]
    ok = (probs.shape == (TTA_T, K, HEIGHT, WIDTH) and flows.shape == (TTA_T, HEIGHT, WIDTH, 2)
          and np.isfinite(probs).all() and np.isfinite(flows).all()
          and np.allclose(probs[1:].sum(axis=1), 1.0, atol=1e-3))
    log(f"tta: multi_scale_inference, scales {TTA_SCALES} and flip, T={TTA_T} bf16: wall "
        f"{wall:.2f} s (first run: captures included), probabilities {probs.shape} finite and "
        f"summing to 1, flows {flows.shape}: {'ok' if ok else 'FAIL'}; forward launches "
        f"{counts} [{smi}]")
    if not ok:
        raise AssertionError("multi_scale_inference gave a malformed result")
    return dict(wall_s=wall, launches=counts)


# ------------------------------------------------------------------ train
TRAIN_STEPS = 5  # timed, after one warm-up step
GRAD_REL_TOL = 1e-3  # flash against dense gradient, per parameter tensor


def make_train_batch(cfg, seed=0) -> dict:
    """A synthetic batch of the reference's training shape from a numpy
    seed: TRAIN.BATCH_SIZE clips of TRAIN.N_MAX_FRAMES frames at the
    465x465 crop with TRAIN.N_MAX_OBJECTS objects, the last one appearing
    at t=1. Frames are noise (as make_clip), masks drifting rectangles,
    flows smooth random fields within +-3 px (flows[:, 0] = 0)."""
    tr = cfg.TRAIN
    B, T, n_obj = tr.BATCH_SIZE, tr.N_MAX_FRAMES, tr.N_MAX_OBJECTS
    H, W = tr.AUGMENTATION.CROP_HSIZE, tr.AUGMENTATION.CROP_WSIZE
    K = n_obj + 1
    rs = np.random.RandomState(seed)
    frames = rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1
    labels = np.zeros((B, T, H, W), np.uint8)
    for b in range(B):
        for k in range(1, K):
            y0, x0 = rs.randint(0, min(H, W) - 160, 2)
            hh, ww = rs.randint(60, 150, 2)
            dy, dx = rs.randint(-8, 9, 2)
            for t in range(1 if k == n_obj else 0, T):
                y, x = y0 + dy * t, x0 + dx * t
                labels[b, t, max(y, 0):y + hh, max(x, 0):x + ww] = k
    masks = (labels[:, :, None] == np.arange(K)[:, None, None]).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / max(H, W)
    flows = np.zeros((B, T, H, W, 2), np.float32)
    for b in range(B):
        for t in range(1, T):
            for c in range(2):
                amp, ph = rs.uniform(1.0, 3.0), rs.uniform(0.0, 2 * np.pi)
                fy, fx = rs.uniform(0.5, 2.0, 2)
                flows[b, t, :, :, c] = amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
    n_objects = np.tile(np.array([n_obj - 1] + [n_obj] * (T - 1), np.int32), (B, 1))
    return dict(frames=frames, masks=masks, flows=flows, n_objects=n_objects)


def grad_rel(got, want, gmax=None) -> tuple:
    """Gradients ``got`` against ``want`` (name -> tensor) -> (largest
    ||got - want|| / ||want|| over tensors, the (name, ratio) of the tensors
    past GRAD_REL_TOL whose max |got - want| is also past 1e-7 of ``gmax``,
    by default the largest |want|: the escape of
    tests/test_train_grad_parity.py)."""
    if gmax is None:
        gmax = max(g.abs().max().item() for g in want.values())
    worst, bad = 0.0, []
    for name, w in want.items():
        err, ref = (got[name] - w).norm().item(), w.norm().item()
        worst = max(worst, err / ref if ref > 0 else (0.0 if err == 0 else math.inf))
        if err > GRAD_REL_TOL * ref and (got[name] - w).abs().max().item() > 1e-7 * gmax:
            bad.append((name, err / (ref + 1e-30)))
    return worst, bad


def grad_agreement(cfg, trainer, batch, when, check) -> dict:
    """One step's gradient through the flash read against the same step
    through the dense read, per RMNet parameter tensor: ||g_flash - g_dense||
    <= GRAD_REL_TOL ||g_dense||, or max |g_flash - g_dense| <= 1e-7 of the
    largest dense gradient (the escape of tests/test_train_grad_parity.py);
    raises past it when ``check``. Also reports the floor: the flash step
    run twice, which differs by the order of the backward's atomic sums
    (cuDNN, bilinear upsampling, scatter_add) left over where the
    constant-ones gradients cancel. Records the first flash pass's reads and
    the gradients reaching them."""
    from rmnet_tpu_torch.train import make_loss_fn

    params = dict(trainer.rmnet.named_parameters())
    dense = dataclasses.replace(trainer.apply, use_flash_attention=False)
    grads = []
    with _Record("flash_memory_read", grads=True) as rec:
        for apply in (trainer.apply, trainer.apply, dense):
            loss = make_loss_fn(cfg, apply, trainer.tflownet)(batch)
            grads.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    flash, again, dense_g = grads
    gmax = max(g.abs().max().item() for g in dense_g.values())
    worst, bad = grad_rel(flash, dense_g, gmax)
    floor, _ = grad_rel(again, flash, gmax)
    verdict = ("ok" if not bad else "FAIL") if check else "reported only"
    log(f"train ({when}): gradient through the flash read vs the dense read, {len(params)} "
        f"tensors: largest ||diff||/||dense|| {worst:.3e}, {len(bad)} past {GRAD_REL_TOL} "
        f"(escape 1e-7 * {gmax:.3e}); the flash step twice: largest {floor:.3e}; {verdict}")
    if check and bad:
        raise AssertionError(f"flash and dense gradients disagree: {bad[:8]}")
    return dict(reads=rec.calls[:len(rec.calls) // 2], worst_rel=worst, floor_rel=floor)


def phase_train(models) -> dict:
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read, flash_read_bwd
    from rmnet_tpu_torch.train import Trainer

    cfg = Config()
    tr = cfg.TRAIN
    if not (tr.NETWORK == "RMNet" and tr.FLASH_ATTENTION and tr.MEMORIZE_EVERY == 1):
        raise AssertionError("the trainer's defaults are no longer RMNet, flash read, "
                             "memorize_every=1")
    trainer = Trainer(cfg, *models)
    batch = trainer.to_device(make_train_batch(cfg))
    B, T = batch["frames"].shape[:2]
    params = dict(trainer.rmnet.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    # on the first step: the floor grows as training shrinks the gradients
    agree = grad_agreement(cfg, trainer, batch, "first step", check=True)

    losses, walls, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    flash_memory_read.launches = flash_read_bwd.launches = 0
    for _ in range(1 + TRAIN_STEPS):
        f0, b0 = flash_memory_read.launches, flash_read_bwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append((flash_memory_read.launches - f0, flash_read_bwd.launches - b0))
    launches = dict(fwd=flash_memory_read.launches, bwd=flash_read_bwd.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    changed = {k: not torch.equal(p.detach(), before[k]) for k, p in params.items()}
    stuck = [k for k, p in params.items()
             if p.grad is not None and bool(p.grad.abs().max() > 0) and not changed[k]]
    log(f"train: B={B} T={T} {tuple(batch['frames'].shape[2:4])} f32 flash, "
        f"losses {[round(x, 6) for x in losses]}, launches per step (fwd, bwd) {per_step}, "
        f"{sum(changed.values())} of {len(params)} parameter tensors changed, peak memory "
        f"{peak_gb:.2f} GB")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(s != (T - 1, T - 1) for s in per_step):
        raise AssertionError(f"launches per step {per_step}, want ({T - 1}, {T - 1}) each")
    if not any(changed.values()) or stuck:
        raise AssertionError(f"parameters with a gradient did not change: {stuck[:8]}")

    later = grad_agreement(cfg, trainer, batch, f"after {1 + TRAIN_STEPS} steps", check=False)
    names = ("m_key", "m_val", "q_key", "slot_valid", "bboxes")
    errs, last = [], None
    for t, call in enumerate(agree["reads"], start=1):
        (args, kwargs), (out, lse) = call["args"], call["result"]
        c = dict(zip(names, (a.detach() for a in args)), **kwargs)
        last = (c, bwd_args(c, call["d_out"], out.detach(), lse))
        errs.append(compare_bwd(f"first_step_read_t{t}", last[1]))
    grads = {k: {"flash_vs_dense": g["worst_rel"], "flash_twice": g["floor_rel"]}
             for k, g in (("first_step", agree), ("after_steps", later))}
    return dict(trainer=trainer, batch=batch, losses=losses, walls_s=walls,
                launches=launches, peak_gb=peak_gb, grads=grads, last_read=last,
                max_abs_err=max(errs))


def phase_train_times(smi, train) -> tuple:
    B = train["batch"]["frames"].shape[0]
    step_ms = statistics.median(train["walls_s"][1:]) * 1e3
    log(f"time train: {step_ms:.3f} ms per step, {B / step_ms * 1e3:.3f} clips/s (median "
        f"of {TRAIN_STEPS} steps after 1 warm-up, loss.item() included), peak memory "
        f"{train['peak_gb']:.2f} GB [{smi}]")
    c, args = train["last_read"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd = fwd_time_row(c, flush)
    log_fwd_times(f"the first step's t={train['batch']['frames'].shape[1] - 1} read", fwd, smi)
    bwd = bwd_time_row(c, args, flush)
    log_bwd_times(f"the first step's t={train['batch']['frames'].shape[1] - 1} read", bwd,
                  train["launches"]["bwd"] / (1 + TRAIN_STEPS), smi)
    trainer, batch = train["trainer"], train["batch"]
    prof = profile_device(smi, lambda: trainer.train_step(batch), 1, "step", step_ms,
                          "profile_train.txt")
    row = dict(
        name="flash_read_bwd", route="cuda",
        source="rmnet_tpu_torch/csrc/flash_read_bwd.cu",
        replaces="rmnet_tpu/ops/flash_attention.py:335",
        launches=train["launches"]["bwd"], max_abs_err=train["max_abs_err"],
        **{k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    )
    return row, dict(step_ms=step_ms, clips_per_s=B / step_ms * 1e3,
                     walls_s=train["walls_s"], losses=train["losses"],
                     peak_gb=train["peak_gb"], grads=train["grads"], profile=prof,
                     bwd_kernel_ms=bwd["by_kernel"],
                     bwd_executed_gflop_by_design=bwd["executed_gflop_by_design"],
                     fwd_last_read=fwd, bwd_last_read=bwd)


def bwd_time_row(c, args, flush) -> dict:
    """The backward on read inputs ``c`` and kernel arguments ``args``:
    kernel, plain and SDPA-backward ms, the bound, the ms by CUDA kernel, the
    useful and the executed work."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd, flash_read_bwd_reference

    bound_ms, bound_by, inbox, flops = read_bwd_bound(c)
    N, S, h, w = c["m_key"].shape[:4]
    return dict(
        ms=_time_ms(lambda: flash_read_bwd(*args), 20, flush),
        plain_ms=_time_ms(lambda: flash_read_bwd_reference(*args), 5, flush),
        library_ms=_time_ms(sdpa_read_bwd(c, args[6]), 20, flush),
        bound_ms=bound_ms, bound_by=bound_by, useful_gflop=flops / 1e9,
        executed_gflop_by_design=read_bwd_executed_flops(args) / 1e9, inbox_positions=inbox,
        positions=N * S * h * w, active_tiles=int(args[5].sum()), tiles=args[4].numel(),
        by_kernel=kernel_ms(flash_read_bwd, args, "flash_read_bwd"),
        shape=dict(N=N, S=S, h=h, w=w, dtype=str(c["q_key"].dtype)))


def log_bwd_times(where, row, per_step, smi) -> None:
    log(f"time flash_read_bwd at {where}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa backward over the dense bank {row['library_ms']:.4f} "
        f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({row['useful_gflop']:.2f} "
        f"GFLOP over {row['inbox_positions']} in-box valid positions of {row['positions']}; "
        f"{row['active_tiles']} active tiles of {row['tiles']}), "
        f"{row['useful_gflop'] / row['ms']:.2f} TFLOP/s useful, executed by the design's count "
        f"{row['executed_gflop_by_design']:.2f} GFLOP, launches per step {per_step:.0f}; "
        f"{row['shape']} [{smi}]")
    log("time flash_read_bwd by kernel (profiler, L2 warm): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in row["by_kernel"].items()) + f" [{smi}]")


# ------------------------------------------------------------------- eval
# the eval phase's synthetic DAVIS tree: three VAL videos at 480x854; video 1
# gains a third object at EVAL_APPEAR[1], written over its annotations
EVAL_LENGTHS = (24, 17, 9)
EVAL_APPEAR = (1, 8)
EVAL_DIR = OUT_DIR / "eval"


class torch_default_tf32:
    """TF32 as torch leaves it by default inside (cuDNN convolutions may use
    it, matmuls may not): the setting of the CLI's processes."""

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.was


def eval_files(models) -> tuple:
    """Writes the tree (build/chip_smoke/eval/davis), a reference-format
    checkpoint of ``models`` and a config file -> (config path, checkpoint
    path)."""

    from rmnet_tpu_torch.data.io import IO
    from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
    from rmnet_tpu_torch.utils.checkpoint import save_checkpoint
    from rmnet_tpu_torch.utils.seg_viz import get_segmentation

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    index_path, img_dir, ann_dir, flo_dir = make_synthetic_davis(
        str(EVAL_DIR / "davis"), n_videos=len(EVAL_LENGTHS), n_frames=EVAL_LENGTHS,
        hw=(HEIGHT, WIDTH))
    v, appear = EVAL_APPEAR
    for t in range(appear, EVAL_LENGTHS[v]):
        path = os.path.join(ann_dir, f"vid{v:02d}", f"{t:05d}.png")
        labels = np.array(IO.get(path))
        labels[200 + 4 * t:320 + 4 * t, 400:580] = 3
        get_segmentation(None, labels).save(path)
    pth = save_checkpoint(str(EVAL_DIR), "ckpt-seed0", *models)
    cfg_path = EVAL_DIR / "cfg.py"
    cfg_path.write_text(
        "def configure(cfg):\n"
        f"    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = {index_path!r}\n"
        f"    cfg.DATASETS.DAVIS.IMG_FILE_PATH = {img_dir + '/%s/%05d.jpg'!r}\n"
        f"    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = {ann_dir + '/%s/%05d.png'!r}\n"
        f"    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = {flo_dir + '/%s/%05d.flo'!r}\n"
        f"    cfg.DIR.OUTPUT_DIR = {str(EVAL_DIR / 'out')!r}\n"
        "    cfg.CONST.EXP_NAME = 'chip_smoke'\n")
    return str(cfg_path), pth


def run_cli(cfg_path, pth) -> dict:
    """``python -m rmnet_tpu_torch.runner --test`` and ``--inference`` on the
    card, started together; each must exit 0. Returns the test run's
    summary scores and the seconds each took."""
    procs, t0 = {}, time.perf_counter()
    for mode in ("--test", "--inference"):
        procs[mode] = subprocess.Popen(
            [sys.executable, "-m", "rmnet_tpu_torch.runner", "--cfg", cfg_path, mode,
             "--weights", pth], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out, seconds = {}, {}
    for mode, proc in procs.items():
        out[mode] = proc.communicate()[0]
        seconds[mode] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"runner {mode} exited {proc.returncode}:\n{out[mode][-4000:]}")
    (EVAL_DIR / "runner_test.log").write_text(out["--test"])
    (EVAL_DIR / "runner_inference.log").write_text(out["--inference"])
    summary = [line for line in out["--test"].splitlines() if "[Test Summary]" in line]
    skips = [line for line in out["--test"].splitlines() if "Skipped videos = " in line]
    if len(summary) != 1 or len(skips) != 1:
        raise AssertionError(f"runner --test printed no summary:\n{out['--test'][-4000:]}")
    scores = [float(x) for x in re.findall(r"'([0-9.naif+-]+)'", summary[0])]
    if len(scores) != 3 or not all(0.0 <= x <= 1.0 for x in scores):
        raise AssertionError(f"runner --test summary outside [0, 1]: {summary[0]}")
    if not skips[0].rstrip().endswith("Skipped videos = 0, batches served again one video "
                                      "at a time = 0"):
        raise AssertionError(f"runner --test skipped videos: {skips[0]}")
    log(f"eval: runner --test and --inference exited 0 ({seconds['--test']:.1f} s, "
        f"{seconds['--inference']:.1f} s, run together); {summary[0].split('] ', 1)[-1]}")
    return dict(scores=scores, seconds=seconds)


class _TimedDataset:
    """A dataset whose __getitem__ (read, decode, transforms) is timed."""

    def __init__(self, dataset):
        self.dataset, self.seconds = dataset, []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        item = self.dataset[i]
        self.seconds.append(time.perf_counter() - t0)
        return item


class _Captures:
    """Times each CUDA graph the engine captures while inside (the chunk
    programs' construction: warm-up and capture)."""

    def __enter__(self):
        import rmnet_tpu_torch.engine as engine_mod

        self.mod, self.real, self.seconds = engine_mod, engine_mod._ChunkProgram, []
        captures = self

        class Timed(self.real):
            def __init__(self, *args, **kwargs):
                t0 = time.perf_counter()
                super().__init__(*args, **kwargs)
                if self.graph is not None:
                    captures.seconds.append(time.perf_counter() - t0)

        engine_mod._ChunkProgram = Timed
        return self

    def __exit__(self, *exc):
        self.mod._ChunkProgram = self.real


class _Served:
    """An engine wrapper that keeps the inputs and labels of each video that
    run_video_labels or run_video_batch serves; the rest is the engine's."""

    def __init__(self, engine):
        self._engine, self.videos = engine, []

    def run_video_labels(self, frames, masks, n_objects):
        labels = self._engine.run_video_labels(frames, masks, n_objects)
        self.videos.append(((frames, masks, n_objects), labels))
        return labels

    def run_video_batch(self, videos):
        outs = self._engine.run_video_batch(videos)
        self.videos.extend(zip([tuple(v) for v in videos], outs))
        return outs

    def __getattr__(self, name):
        return getattr(self._engine, name)


def eval_sweep(cfg, eng, n_streams=1):
    """One test_net sweep over the tree through a wrapper of ``eng``, its
    loader's dataset timed -> (metrics, EvalStats, wrapper, timed dataset,
    wall seconds). Raises if a video was skipped or a batch served again."""
    from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset
    from rmnet_tpu_torch.test import EvalStats, test_net

    cfg.TEST.N_STREAMS = n_streams
    ds = _TimedDataset(DatasetCollector.get_dataset(cfg, "DAVIS", DatasetSubset.VAL))
    loader = DataLoader(ds, n_workers=cfg.CONST.N_WORKERS)
    served, stats = _Served(eng), EvalStats()
    t0 = time.perf_counter()
    metrics = test_net(cfg, test_data_loader=loader, engine=served, stats=stats)
    wall = time.perf_counter() - t0
    if stats.skipped or stats.batch_fallbacks or stats.scored != len(EVAL_LENGTHS):
        raise AssertionError(f"eval sweep (N_STREAMS={n_streams}): {stats}")
    return metrics, stats, served, ds, wall


def phase_eval(smi, models) -> dict:
    """The evaluation and export entry points on the card: the CLI's --test
    and --inference as processes, then test_net in process against the
    engine, the PNGs against multi_scale_inference, the sweep's times."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.data.io import IO
    from rmnet_tpu_torch.test import engine_from_cfg

    cfg_path, pth = eval_files(models)
    cli = run_cli(cfg_path, pth)
    n_frames = sum(EVAL_LENGTHS)
    with torch_default_tf32():
        cfg = Config.from_file(cfg_path)
        cfg.CONST.WEIGHTS = pth
        eng = engine_from_cfg(cfg)
        # the first sweep captures the chunk programs; its reads are recorded
        with _Captures() as caps, _Record("flash_memory_read") as rec:
            (metrics, _, served, _, cold_s), _ = counted(
                eng, lambda: eval_sweep(cfg, eng), list(EVAL_LENGTHS))
        shapes = {tuple(c["args"][0][0].shape[:4]) for c in rec.calls}
        del rec
        case = KERNEL_CASES["eval_N10_S33_f32"]
        if max(shapes, key=lambda s: s[1]) != case[:4]:
            raise AssertionError(f"the eval reads {shapes} no longer reach the kernel "
                                 f"case eval_N10_S33_f32 {case[:4]}")
        got = metrics.state_dict()
        if any(abs(got[k] - x) > 5e-5 for k, x in zip(("J-Mean", "F-Mean", "JF-Mean"),
                                                        cli["scores"])):
            raise AssertionError(f"test_net in process {got} against the CLI's {cli['scores']}")
        # test_net's labels against the engine's own run of each video
        for (frames, masks, n_objects), labels in served.videos:
            again = eng.run_video_labels(frames, masks, n_objects)
            if not np.array_equal(labels, again):
                raise AssertionError("test_net's labels differ from run_video_labels")
        # the steady sweep: nothing captured
        (_, stats, _, ds, wall), launches = counted(
            eng, lambda: eval_sweep(cfg, eng), list(EVAL_LENGTHS))
        sweep_ms = wall / n_frames * 1e3
        prof = profile_device(smi, lambda: eval_sweep(cfg, eng), n_frames, "frame", sweep_ms,
                              "profile_eval.txt")
        # two streams: the 24- and 17-frame videos as one batch, then the 9;
        # the first sweep captures the batch's programs
        two = [max(EVAL_LENGTHS[:2]), EVAL_LENGTHS[2]]
        with _Captures() as caps2:
            (metrics2, _, served2, _, _), _ = counted(
                eng, lambda: eval_sweep(cfg, eng, n_streams=2), two)
        (_, stats2, _, _, wall2), launches2 = counted(
            eng, lambda: eval_sweep(cfg, eng, n_streams=2), two)
        # the PNGs of --inference against multi_scale_inference on this engine
        out_root = EVAL_DIR / "out" / "benchmark" / "chip_smoke" / "DAVIS"
        pngs = sorted(out_root.glob("*/*.png"))
        if len(pngs) != n_frames:
            raise AssertionError(f"{len(pngs)} PNGs under {out_root}, want {n_frames}")
        for i, ((frames, masks, n_objects), _) in enumerate(served.videos):
            (_, probs), _ = counted(
                eng, lambda: eng.multi_scale_inference(frames, masks, n_objects),
                EVAL_LENGTHS[i])
            png = np.stack([np.array(IO.get(str(out_root / f"vid{i:02d}" / f"{t:05d}.png")))
                            for t in range(EVAL_LENGTHS[i])])
            if not np.array_equal(png, probs.argmax(axis=1)):
                raise AssertionError(f"the PNGs of vid{i:02d} differ from the engine's labels")
        # the first video's last read, from its chunk function run eagerly
        # (a graph's own tensors share the pool with the other graphs')
        frames, masks, n_objects = served.videos[0][0]
        T = len(frames)
        with _Record("flash_memory_read") as rec:
            eager_probs(eng, frames, masks.astype(np.float32), n_objects,
                        eng._capacity_for(T, eng._video_flags(n_objects, T)[1]))
        args, kwargs = rec.args
        del rec
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        fwd = fwd_time_row(dict(zip(("m_key", "m_val", "q_key", "slot_valid", "bboxes"), args),
                                **kwargs), flush)
        log_fwd_times(f"the eval path's read at frame {T - 1} of vid00", fwd, smi)
    # the batch against one stream again with TF32 off in the convolutions
    # (the other phases' setting), on an engine captured that way
    eng_off = engine_from_cfg(cfg)
    one_off = eval_sweep(cfg, eng_off)
    two_off = eval_sweep(cfg, eng_off, n_streams=2)
    batch = {}
    for name, a, b in (("tf32_default", (metrics, served), (metrics2, served2)),
                       ("tf32_off", one_off[::2], two_off[::2])):
        batch[name] = dict(label_mismatch=float(np.mean(np.concatenate([
            (x != y).ravel() for (_, x), (_, y) in zip(a[1].videos, b[1].videos)]))),
            jf_one=a[0].state_dict()["JF-Mean"], jf_two=b[0].state_dict()["JF-Mean"])
    del eng_off
    report = dict(
        card=smi, tf32="torch defaults: cuDNN convolutions TF32 on, matmuls off",
        lengths=EVAL_LENGTHS, frames=n_frames, cli=cli, scores=got, read_shapes=sorted(shapes),
        cold_sweep_s=cold_s, captures_cold=len(caps.seconds), capture_s_cold=caps.seconds,
        sweep_ms_per_frame=sweep_ms, engine_ms_per_frame=stats.engine_s / n_frames * 1e3,
        decode_ms_per_frame=sum(ds.seconds) / n_frames * 1e3,
        metrics_ms_per_frame=stats.metrics_s / n_frames * 1e3, busy=prof["busy_ms"] / sweep_ms,
        profile=prof, launches=launches, fwd_last_read=fwd, n_streams_2=dict(
            sweep_ms_per_frame=wall2 / n_frames * 1e3,
            engine_ms_per_frame=stats2.engine_s / n_frames * 1e3, launches=launches2,
            captures=len(caps2.seconds), capture_s=caps2.seconds, against_one_stream=batch))
    log(f"eval: {len(EVAL_LENGTHS)} videos of {EVAL_LENGTHS} frames at {HEIGHT}x{WIDTH}, "
        f"f32, K = {KERNEL_CASES['eval_N10_S33_f32'][0] + 1} slots, {report['tf32']}: "
        f"test_net in process {got} (the CLI's within 5e-5), labels bit-identical to "
        f"run_video_labels, {n_frames} PNGs equal to multi_scale_inference's labels, reads "
        f"{sorted(shapes)}; 0 videos skipped, 0 batches served again (1 and 2 streams)")
    log(f"eval: sweep {sweep_ms:.3f} ms/frame (loader, engine and metrics, steady), engine "
        f"{report['engine_ms_per_frame']:.3f} ms/frame, loader decode "
        f"{report['decode_ms_per_frame']:.3f} ms/frame ({cfg.CONST.N_WORKERS} threads, "
        f"beside the engine), Metrics.get {report['metrics_ms_per_frame']:.3f} ms/frame; "
        f"first sweep {cold_s:.2f} s with {len(caps.seconds)} graph captures taking "
        f"{sum(caps.seconds):.2f} s; busy {report['busy']:.1%}; forward launches {launches} "
        f"[{smi}]")
    log(f"eval: N_STREAMS=2 sweep {report['n_streams_2']['sweep_ms_per_frame']:.3f} ms/frame, "
        f"engine {report['n_streams_2']['engine_ms_per_frame']:.3f} ms/frame (steady; the "
        f"sweep before it made {len(caps2.seconds)} captures, {sum(caps2.seconds):.2f} s), "
        f"forward launches {launches2}; against one stream: " + "; ".join(
            f"{k}: label mismatch share {v['label_mismatch']:.3e}, JF-Mean {v['jf_two']:.6f} "
            f"against {v['jf_one']:.6f}" for k, v in batch.items()) + f" [{smi}]")
    return report


# -------------------------------------------------------------- train_net
# the train_net phase's synthetic DAVIS tree: three 480x854 videos; 4 repeats
# make 12 training clips, 3 batches of TRAIN.BATCH_SIZE = 4 per epoch
TN_VIDEOS, TN_FRAMES, TN_REPEAT, TN_EPOCHS = 3, 12, 4, 2
TN_DIR = OUT_DIR / "train_net"
REMAT_GRAD_TOL = GRAD_REL_TOL  # each REMAT mode's gradient against "none", per tensor


def train_net_files() -> Path:
    """Writes the tree (build/chip_smoke/train_net/davis) and a config file
    of the reference's TRAIN at full width over it -> the config's path."""

    from rmnet_tpu_torch.data.synthetic import make_synthetic_davis

    shutil.rmtree(TN_DIR, ignore_errors=True)
    index_path, img_dir, ann_dir, flo_dir = make_synthetic_davis(
        str(TN_DIR / "davis"), n_videos=TN_VIDEOS, n_frames=TN_FRAMES, hw=(HEIGHT, WIDTH))
    cfg_path = TN_DIR / "cfg.py"
    cfg_path.write_text(
        "def configure(cfg):\n"
        f"    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = {index_path!r}\n"
        f"    cfg.DATASETS.DAVIS.IMG_FILE_PATH = {img_dir + '/%s/%05d.jpg'!r}\n"
        f"    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = {ann_dir + '/%s/%05d.png'!r}\n"
        f"    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = {flo_dir + '/%s/%05d.flo'!r}\n"
        f"    cfg.DATASET.TRAIN_DATASET = ['DAVISx{TN_REPEAT}']\n"
        f"    cfg.TRAIN.N_EPOCHS = {TN_EPOCHS}\n"
        "    cfg.TRAIN.CKPT_SAVE_THRESHOLD = -1.0\n"
        f"    cfg.TEST.TESTING_VIDEOS_INDEXES = {tuple(range(TN_VIDEOS))!r}\n"
        "    cfg.CONST.N_WORKERS = 4\n"
        f"    cfg.DIR.OUTPUT_DIR = {str(TN_DIR / 'out')!r}\n")
    return cfg_path


class _TrainLoop:
    """Replaces train_net's DataLoader and Trainer with ones that keep, on
    the training loader, the flash read's launches of each step (the
    counts between two batches handed out), the bytes of each batch and
    each epoch's loop wall (from the first batch asked for to the end of
    the last step), and the Trainer that train_net built; and its
    InferenceEngine with an account of update_weights, so that its
    validation engine can be checked once train_net has returned."""

    def __init__(self):
        self.per_step, self.batch_bytes, self.loop_s, self.trainer = [], [], [], None
        self.val_engine, self.weight_updates = None, 0

    def __enter__(self):
        import rmnet_tpu_torch.train as train_mod
        from rmnet_tpu_torch.ops.flash_attention import flash_memory_read, flash_read_bwd

        loop = self
        self.mod = train_mod
        self.real = (train_mod.DataLoader, train_mod.Trainer, train_mod.InferenceEngine)

        def counts():
            return flash_memory_read.launches, flash_read_bwd.launches

        class Loader(train_mod.DataLoader):
            def __iter__(self):
                if not self.shuffle:  # the validation loader
                    yield from super().__iter__()
                    return
                t0, before = time.perf_counter(), None
                for batch in super().__iter__():
                    if before is not None:
                        now = counts()
                        loop.per_step.append((now[0] - before[0], now[1] - before[1]))
                    loop.batch_bytes.append(sum(a.nbytes for a in batch[2:]))
                    before = counts()
                    yield batch
                if before is not None:  # the last step ran before the loader was asked again
                    now = counts()
                    loop.per_step.append((now[0] - before[0], now[1] - before[1]))
                torch.cuda.synchronize()
                loop.loop_s.append(time.perf_counter() - t0)

        class Trainer(train_mod.Trainer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                loop.trainer = self

        class Engine(train_mod.InferenceEngine):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                loop.val_engine = self

            def update_weights(self, *args, **kwargs):
                loop.weight_updates += 1
                return super().update_weights(*args, **kwargs)

        train_mod.DataLoader, train_mod.Trainer, train_mod.InferenceEngine = Loader, Trainer, Engine
        return self

    def __exit__(self, *exc):
        self.mod.DataLoader, self.mod.Trainer, self.mod.InferenceEngine = self.real


def check_val_engine(cfg, loop, ckpt_dir) -> dict:
    """train_net's validation engine, which took the last epoch's weights
    through update_weights under its captured graphs, against fresh engines
    from that epoch's checkpoint (the same weights) and from epoch 1's (the
    weights it was built with), on one clip at the validation's 480x854,
    TF32 as torch defaults it as in train_net: probabilities bit-identical
    to the first and unlike the second, or raises. Also reads the epoch of
    ckpt-best.pth."""
    from rmnet_tpu_torch.engine import InferenceEngine
    from rmnet_tpu_torch.utils.checkpoint import load_weights_auto

    if loop.val_engine is None or loop.weight_updates != TN_EPOCHS - 1:
        raise AssertionError(f"train_net's validation engine took {loop.weight_updates} "
                             f"update_weights, want {TN_EPOCHS - 1} (one engine for the run)")
    clip = make_clip(TN_FRAMES, HEIGHT, WIDTH, N_OBJECTS)
    fresh = {}
    with torch_default_tf32():
        reused = loop.val_engine.run_video(*clip)
        for epoch in (TN_EPOCHS, 1):
            rm_sd, tfn_sd, _ = load_weights_auto(str(ckpt_dir / f"ckpt-epoch-{epoch:03d}.pth"))
            fresh[epoch] = InferenceEngine(cfg, rm_sd, tfn_sd).run_video(*clip)
    loop.val_engine = None
    best_epoch = load_weights_auto(str(ckpt_dir / "ckpt-best.pth"))[2]["epoch"]
    same = np.array_equal(reused, fresh[TN_EPOCHS])
    same_labels = np.array_equal(reused.argmax(1), fresh[TN_EPOCHS].argmax(1))
    changed = not np.array_equal(reused, fresh[1])
    ok = same and same_labels and changed
    log(f"train_net: the validation engine after update_weights to epoch {TN_EPOCHS}'s weights "
        f"against a fresh engine from ckpt-epoch-{TN_EPOCHS:03d}.pth: probabilities "
        f"bit-identical {same} (max diff {np.abs(reused - fresh[TN_EPOCHS]).max():.3e}), labels "
        f"equal {same_labels}; unlike epoch 1's {changed} (max diff "
        f"{np.abs(reused - fresh[1]).max():.3e}); ckpt-best.pth is epoch {best_epoch} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_net's validation engine after update_weights differs from "
                             "a fresh engine with those weights")
    return dict(bit_identical=same, labels_equal=same_labels, best_epoch=best_epoch)


def loader_stages(cfg, n_clips) -> dict:
    """Host seconds per training clip by stage, on one thread: each
    transform of the TRAIN pipeline, and reading and decoding (the rest of
    the dataset's __getitem__), over ``n_clips`` clips."""
    from rmnet_tpu_torch.data import DatasetCollector, DatasetSubset

    video = DatasetCollector.get_dataset(cfg, cfg.DATASET.TRAIN_DATASET,
                                         DatasetSubset.TRAIN).datasets[0][0]
    stages = {}

    def timed(tr):
        def call(*args):
            t0 = time.perf_counter()
            out = tr(*args)
            name = type(tr).__name__
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    video.transforms.transformers = [timed(tr) for tr in video.transforms.transformers]
    t0 = time.perf_counter()
    for i in range(n_clips):
        video[i % len(video)]
    stages["read and decode"] = time.perf_counter() - t0 - sum(stages.values())
    return {k: v / n_clips for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}


def loader_throughput(cfg, n_batches=12) -> dict:
    """The TRAIN loader alone, CONST.N_WORKERS threads and nothing else
    working, over one epoch of ``n_batches`` batches of the config's tree
    (DAVIS repeated to that length): seconds until the first batch, then
    per batch after it (the steady rate a training loop could draw)."""
    from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset

    B = cfg.TRAIN.BATCH_SIZE
    loader = DataLoader(
        DatasetCollector.get_dataset(cfg, [f"DAVISx{n_batches * B // TN_VIDEOS}"],
                                     DatasetSubset.TRAIN),
        batch_size=B, shuffle=True, drop_last=True, seed=cfg.CONST.RNG_SEED,
        n_workers=cfg.CONST.N_WORKERS)
    t = [time.perf_counter()]
    for _ in loader:
        t.append(time.perf_counter())
    if len(t) != n_batches + 1:
        raise AssertionError(f"the loader gave {len(t) - 1} batches, want {n_batches}")
    return dict(n_batches=n_batches, workers=cfg.CONST.N_WORKERS, first_s=t[1] - t[0],
                per_batch_s=(t[-1] - t[1]) / (n_batches - 1))


def profile_train_steps(smi, cfg, trainer, wall_ms) -> dict:
    """Device time by kernel over the steps of one epoch of the training
    loader (decoded first, so only the steps are profiled) on ``trainer``,
    with TF32 as torch defaults it; the busy share against ``wall_ms``, the
    unprofiled loop's wall per step."""
    from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset

    loader = DataLoader(
        DatasetCollector.get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, DatasetSubset.TRAIN),
        batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=True, drop_last=True,
        seed=cfg.CONST.RNG_SEED, n_workers=cfg.CONST.N_WORKERS)
    batches = [dict(n_objects=n, frames=f, masks=m, flows=fl) for _, n, f, m, fl in loader]

    def steps():
        for b in batches:
            trainer.train_step(b)

    with torch_default_tf32():
        return profile_device(smi, steps, len(batches), "step", wall_ms,
                              "profile_train_net.txt")


def remat_steps(smi, models) -> dict:
    """One timed step each of TRAIN.REMAT "none", "encoders" and "step" on
    the same batch (the train phase's), with the peak memory; each mode's
    gradient against "none" per tensor, and "none" run twice (the floor:
    cuDNN's backward and scatter_add sum in an order that varies); then one
    step with GRAD_ACCUM_STEPS = 2 at B = 4. TF32 off (parity checks)."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.train import Trainer, make_loss_fn, make_train_step

    cfg = Config()
    trainer = Trainer(cfg, *models)
    batch = trainer.to_device(make_train_batch(cfg))
    params = dict(trainer.rmnet.named_parameters())
    grads = {}
    for mode in ("none", "none_again", "encoders", "step"):
        loss = make_loss_fn(cfg, trainer.apply, trainer.tflownet, mode.split("_")[0])(batch)
        grads[mode] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del loss
    gmax = max(g.abs().max().item() for g in grads["none"].values())
    agree = {}
    for mode in ("none_again", "encoders", "step"):
        agree[mode], bad = grad_rel(grads[mode], grads["none"], gmax)
        if bad:
            raise AssertionError(f"REMAT={mode} gradient against 'none': {bad[:8]}")
    del grads
    rows = {}
    for mode, accum in (("none", 1), ("encoders", 1), ("step", 1), ("encoders", 2)):
        c = Config()
        c.TRAIN.REMAT, c.TRAIN.GRAD_ACCUM_STEPS = mode, accum
        step = make_train_step(c, trainer.apply, trainer.tflownet, trainer.optimizer)
        step(batch, c.TRAIN.LEARNING_RATE)  # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = step(batch, c.TRAIN.LEARNING_RATE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not math.isfinite(loss):
            raise AssertionError(f"REMAT={mode}, GRAD_ACCUM_STEPS={accum}: loss {loss}")
        name = mode if accum == 1 else f"{mode}, GRAD_ACCUM_STEPS=2"
        peak = torch.cuda.max_memory_allocated()
        rows[name] = dict(ms=ms, peak_gb=peak / 1e9, step_gb=(peak - base) / 1e9)
    log(f"train_net: REMAT gradients against 'none' per tensor (tolerance {REMAT_GRAD_TOL}, "
        f"escape 1e-7 * {gmax:.3e}): largest ||diff||/||none|| " + ", ".join(
            f"{k} {v:.3e}" for k, v in agree.items()) + " ('none_again': the floor)")
    for name, r in rows.items():
        log(f"train_net: one step at B=4, T=3, 465x465, f32, TF32 off, REMAT={name}: "
            f"{r['ms']:.3f} ms, peak memory {r['peak_gb']:.2f} GB, {r['step_gb']:.2f} GB of it "
            f"above what was held before the step [{smi}]")
    return dict(grad_rel_vs_none=agree, steps=rows)


def _wait_for(proc, text, limit_s) -> str:
    """Lines of ``proc``'s output until one holds ``text`` -> what was read;
    raises if the process ends first (it is killed after ``limit_s``)."""

    watchdog = threading.Timer(limit_s, proc.kill)
    watchdog.start()
    out = []
    try:
        for line in proc.stdout:
            out.append(line)
            if text in line:
                return "".join(out)
    finally:
        watchdog.cancel()
    raise AssertionError(f"no {text!r} from the runner (exit {proc.wait()}, killed after "
                         f"{limit_s} s):\n{''.join(out)[-4000:]}")


def interrupt_and_resume(cfg_path) -> dict:
    """The CLI trains one epoch; SIGTERM after its first batch: exit 0 with
    ckpt-interrupt.pth at the interrupted epoch - 1; then --weights on that
    file: it starts at the interrupted epoch with the saved Adam state
    (the 'Recover completed' line against the file) and exits 0."""
    import signal

    from rmnet_tpu_torch.train import adam_summary

    cmd = [sys.executable, "-m", "rmnet_tpu_torch.runner", "--cfg", str(cfg_path), "--exp",
           "interrupt", "--set", "TRAIN.N_EPOCHS=1"]
    ckpt = TN_DIR / "out" / "checkpoints" / "interrupt" / "ckpt-interrupt.pth"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    head = _wait_for(proc, "[Batch 1/", 300)
    t_signal = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        tail = proc.communicate(timeout=120)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("the runner did not exit within 120 s of SIGTERM")
    first = head + tail
    (TN_DIR / "runner_interrupt.log").write_text(first)
    if proc.returncode != 0:
        raise AssertionError(f"runner exited {proc.returncode} after SIGTERM:\n{first[-4000:]}")
    stopped = int(re.search(r"Stopped in epoch (\d+)", first).group(1))
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    if saved["epoch_index"] != stopped - 1:
        raise AssertionError(f"ckpt-interrupt.pth holds epoch {saved['epoch_index']}, "
                             f"stopped in {stopped}")
    summary = adam_summary(saved["optimizer"])
    exit_s = time.perf_counter() - t_signal
    proc = subprocess.run(cmd + ["--weights", str(ckpt)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    second = proc.stdout + proc.stderr
    (TN_DIR / "runner_resume.log").write_text(second)
    if proc.returncode != 0:
        raise AssertionError(f"resumed runner exited {proc.returncode}:\n{second[-4000:]}")
    start = re.search(r"\[Epoch (\d+)/\d+\]\[Batch 1/", second)
    if (f"Current epoch = #{stopped - 1};" not in second or summary not in second
            or start is None or int(start.group(1)) != stopped):
        raise AssertionError(f"the resumed run did not start at epoch {stopped} with the "
                             f"saved {summary}:\n{second[-4000:]}")
    log(f"train_net: CLI stopped by SIGTERM in epoch {stopped} and exited 0 {exit_s:.1f} s "
        f"after the signal, ckpt-interrupt.pth at epoch {stopped - 1}; --weights on it resumed "
        f"at epoch {stopped} with the saved {summary}, exit 0 ({time.perf_counter() - t0:.1f} "
        f"s for both runs)")
    return dict(stopped_epoch=stopped, exit_s=exit_s, adam=summary,
                seconds=time.perf_counter() - t0)


def phase_train_net(smi, models) -> tuple:
    """train_net in process on the synthetic tree (TF32 as torch defaults
    it, as the CLI runs), the CLI's --test on its ckpt-best.pth, the REMAT
    modes and accumulation, SIGTERM and resume through the CLI -> (report,
    forward launches, backward launches of the train_net run)."""

    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd
    from rmnet_tpu_torch.train import TrainStats, train_net

    t_phase = time.perf_counter()
    cfg_path = train_net_files()
    cfg = Config.from_file(str(cfg_path))
    tr = cfg.TRAIN
    T = tr.N_MAX_FRAMES
    stats = TrainStats()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    fmr.launches = fmr.captured = fmr.replayed = flash_read_bwd.launches = 0
    t0 = time.perf_counter()
    with torch_default_tf32(), _TrainLoop() as loop:
        best = train_net(cfg, stats=stats)
    wall = time.perf_counter() - t0
    fwd, bwd = fmr.launches + fmr.replayed, flash_read_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = _losses(cfg)
    ckpt_dir = TN_DIR / "out" / "checkpoints" / cfg.CONST.EXP_NAME
    written = sorted(p.name for p in ckpt_dir.glob("*.pth"))
    n_batches = TN_VIDEOS * TN_REPEAT // tr.BATCH_SIZE
    if stats.skipped or stats.non_finite or stats.batches != n_batches * TN_EPOCHS:
        raise AssertionError(f"train_net: {stats}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != n_batches * TN_EPOCHS:
        raise AssertionError(f"train_net losses {losses}")
    if any(s != (T - 1, T - 1) for s in loop.per_step):
        raise AssertionError(f"read launches per step {loop.per_step}, want ({T - 1}, {T - 1})")
    want = {"ckpt-epoch-001.pth", "ckpt-epoch-002.pth", "ckpt-best.pth"}
    if not want <= set(written):
        raise AssertionError(f"checkpoints {written}, want {sorted(want)}")
    val_engine = check_val_engine(cfg, loop, ckpt_dir)
    times = {e: [(b, d) for e_, b, d in stats.batch_times if e_ == e] for e in (1, TN_EPOCHS)}
    batch_s = statistics.median(b for b, _ in times[TN_EPOCHS])
    data_s = statistics.median(d for _, d in times[TN_EPOCHS])
    loop_ms = loop.loop_s[TN_EPOCHS - 1] / n_batches * 1e3
    prof = profile_train_steps(smi, cfg, loop.trainer, loop_ms)
    busy = prof["busy_ms"] / loop_ms
    loop.trainer = None
    stages = loader_stages(cfg, tr.BATCH_SIZE)
    rate = loader_throughput(cfg)
    log(f"train_net: {TN_EPOCHS} epochs of {n_batches} batches (B={tr.BATCH_SIZE}, T={T}, "
        f"{tr.N_MAX_OBJECTS} objects max, {tr.AUGMENTATION.CROP_HSIZE}x"
        f"{tr.AUGMENTATION.CROP_WSIZE} crops of 480x854 clips, REMAT={tr.REMAT}, f32, TF32 as "
        f"torch defaults it) in {wall:.1f} s; losses {[round(x, 5) for x in losses]}; read "
        f"launches per step (fwd, bwd) {loop.per_step}; 0 batches skipped; wrote {written}")
    log(f"train_net: epoch {TN_EPOCHS}: BatchTime median {batch_s * 1e3:.3f} ms, DataTime "
        f"median {data_s * 1e3:.3f} ms; per batch (BatchTime, DataTime) ms: " + "; ".join(
            f"epoch {e} " + str([(round(b * 1e3, 3), round(d * 1e3, 3)) for b, d in t])
            for e, t in times.items()) + f"; the training loop {loop.loop_s[TN_EPOCHS - 1]:.3f} "
        f"s for {n_batches} steps ({loop_ms:.3f} ms per step), the card busy {busy:.1%} of it "
        f"(device time per step from the profiled steps); validation "
        f"{[round(x, 3) for x in stats.val_s]} s per epoch ({TN_VIDEOS} videos of {TN_FRAMES} "
        f"frames); peak memory {peak_gb:.2f} GB ({base_gb:.2f} GB before); upload "
        f"{statistics.median(loop.batch_bytes) / 1e6:.1f} MB per batch (frames, uint8 masks, "
        f"flows; pageable) [{smi}]")
    log(f"train_net: the TRAIN pipeline on one thread, ms per clip of {T} frames: "
        f"{sum(stages.values()) * 1e3:.1f} in all; " + ", ".join(
            f"{k} {v * 1e3:.1f}" for k, v in stages.items()) + f"; the loader alone with "
        f"{rate['workers']} threads over {rate['n_batches']} batches: first after "
        f"{rate['first_s']:.3f} s, then {rate['per_batch_s'] * 1e3:.3f} ms per batch against "
        f"the {batch_s * 1e3:.3f} ms BatchTime")
    # the CLI's --test on ckpt-best.pth against the best in-training validation
    t1 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rmnet_tpu_torch.runner", "--cfg", str(cfg_path), "--test",
         "--weights", str(ckpt_dir / "ckpt-best.pth")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    resume = interrupt_and_resume(cfg_path)
    out = proc.communicate()[0]
    (TN_DIR / "runner_test.log").write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"runner --test on ckpt-best.pth exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    summary = [line for line in out.splitlines() if "[Test Summary]" in line]
    scores = [float(x) for x in re.findall(r"'([0-9.naif+-]+)'", summary[-1])]
    got = best.state_dict()
    if any(abs(got[k] - x) > 5e-5 for k, x in zip(("J-Mean", "F-Mean", "JF-Mean"), scores)):
        raise AssertionError(f"runner --test on ckpt-best.pth {scores} against the best "
                             f"in-training validation {got}")
    log(f"train_net: runner --test on ckpt-best.pth {scores}, within 5e-5 of the best "
        f"in-training validation {got} ({time.perf_counter() - t1:.1f} s with the "
        f"interrupt runs beside it)")
    t2 = time.perf_counter()
    remat = remat_steps(smi, models)
    log(f"train_net: the REMAT and accumulation steps took {time.perf_counter() - t2:.1f} s; "
        f"the phase {time.perf_counter() - t_phase:.1f} s")
    report = dict(card=smi, tf32="torch defaults in train_net; off in the REMAT steps",
                  wall_s=wall, losses=losses, launches_per_step=loop.per_step,
                  launches=dict(fwd=fwd, bwd=bwd), checkpoints=written, best=got,
                  cli_scores=scores, batch_s_median_epoch2=batch_s,
                  data_s_median_epoch2=data_s, batch_times=stats.batch_times,
                  loop_s=loop.loop_s, busy=busy,
                  profile=prof, val_s=stats.val_s, peak_gb=peak_gb,
                  upload_bytes_per_batch=statistics.median(loop.batch_bytes),
                  loader_s_per_clip=stages, loader_alone=rate,
                  val_engine=val_engine, resume=resume, remat=remat)
    return report, fwd, bwd


# ------------------------------------------------------------- eval_server
def _hardlink_copy(src: Path, dst: Path) -> Path:
    """``dst`` as a copy of directory ``src`` made of hard links (a
    checkpoint is about 0.5 GB), so that pruning it leaves ``src`` whole."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, copy_function=os.link)
    return dst


def _cli_eval_server(cfg_path, ckpt_dir, names, limit_s=300) -> dict:
    """``python -m rmnet_tpu_torch.runner --eval-server --ckpt-dir`` as a
    process until its log shows every checkpoint of ``names`` evaluated,
    then SIGTERM: it must exit 0. Returns each checkpoint's logged scores
    and the seconds."""
    import ast
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rmnet_tpu_torch.runner", "--cfg", str(cfg_path),
         "--eval-server", "--ckpt-dir", str(ckpt_dir), "--poll-seconds", "1"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(limit_s, proc.kill)
    watchdog.start()
    out, scores = [], {}
    try:
        for line in proc.stdout:
            out.append(line)
            m = re.search(r"Evaluated (\S+): (\{.*\})", line)
            if m:
                scores[m.group(1)] = ast.literal_eval(m.group(2))
            if set(scores) >= set(names):
                break
        seen_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out.append(proc.communicate(timeout=120)[0])
    finally:
        watchdog.cancel()
    text = "".join(out)
    (TN_DIR / "runner_eval_server.log").write_text(text)
    if set(scores) < set(names) or proc.returncode != 0:
        raise AssertionError(f"runner --eval-server evaluated {sorted(scores)} of {names}, exit "
                             f"{proc.returncode}:\n{text[-4000:]}")
    return dict(scores=scores, seconds_to_all=seen_s, seconds=time.perf_counter() - t0)


def phase_eval_server(smi) -> tuple:
    """The eval server on train_net's checkpoints (TF32 as torch defaults it,
    as the CLI runs): in process over a copy, two polls, every checkpoint
    scored within 5e-5 of test_net on it by one engine that took the later
    ones through update_weights, the best kept and the rest pruned, the
    forward launches replayed = the chunk steps of every sweep; then the CLI
    until it has logged each checkpoint, stopped by SIGTERM -> (report,
    forward launches)."""
    import rmnet_tpu_torch.eval_server as es
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.test import engine_from_cfg, test_net

    t_phase = time.perf_counter()
    cfg_path = TN_DIR / "cfg.py"
    cfg = Config.from_file(str(cfg_path))
    src = TN_DIR / "out" / "checkpoints" / cfg.CONST.EXP_NAME
    names = sorted(p.name for p in src.glob("ckpt-*.pth"))
    engines, per_ckpt = [], []
    real_engine, real_worker = es.InferenceEngine, es._make_eval_worker

    class Engine(real_engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    def timed_worker(*args):
        work = real_worker(*args)

        def timed(device, path):
            t0 = time.perf_counter()
            result = work(device, path)
            per_ckpt.append((os.path.basename(path), time.perf_counter() - t0))
            return result
        return timed

    ckpt_dir = _hardlink_copy(src, TN_DIR / "eval_server_in_process")
    es.InferenceEngine, es._make_eval_worker = Engine, timed_worker
    try:
        with torch_default_tf32():
            fmr.launches = fmr.captured = fmr.replayed = 0
            t0 = time.perf_counter()
            best, scores = es.eval_server(cfg, str(ckpt_dir), poll_seconds=0.5, max_iterations=2,
                                          stop_event=threading.Event())
            wall = time.perf_counter() - t0
            counts = dict(eager=fmr.launches, captured=fmr.captured, replayed=fmr.replayed)
    finally:
        es.InferenceEngine, es._make_eval_worker = real_engine, real_worker
    got = {os.path.basename(p): m.state_dict() for p, m in scores.items()}
    if sorted(got) != names or len(engines) != 1:
        raise AssertionError(f"eval_server scored {sorted(got)} of {names} on {len(engines)} "
                             f"engines, want one engine")
    steps = len(names) * TN_VIDEOS * sum(engines[0]._chunk_plan(TN_FRAMES - 1))
    if counts["replayed"] != steps or counts["eager"] != counts["captured"]:
        raise AssertionError(f"eval_server forward launches {counts}: want replayed == "
                             f"{steps} chunk steps and eager (warm-up) == captured")
    kept = sorted(os.listdir(ckpt_dir))
    if kept != [os.path.basename(best)]:
        raise AssertionError(f"eval_server kept {kept}, want the best {best} only")
    engines.clear()
    # test_net on each checkpoint with a fresh engine
    worst = 0.0
    with torch_default_tf32():
        for name in names:
            c = Config.from_file(str(cfg_path))
            c.CONST.WEIGHTS = str(src / name)
            ref = test_net(c, engine=engine_from_cfg(c)).state_dict()
            worst = max([worst] + [abs(got[name][k] - v) for k, v in ref.items()])
    if worst > 5e-5:
        raise AssertionError(f"eval_server scores against test_net: {worst:.3e} > 5e-5")
    cli = _cli_eval_server(cfg_path, _hardlink_copy(src, TN_DIR / "eval_server_cli"), names)
    cli_worst = max(abs(cli["scores"][n][k] - v) for n in names for k, v in got[n].items())
    if cli_worst > 5e-5:
        raise AssertionError(f"runner --eval-server scores against in process: {cli_worst:.3e}")
    order = [n for n, _ in per_ckpt]
    log(f"eval_server: {len(names)} checkpoints of train_net ({TN_VIDEOS} VAL videos of "
        f"{TN_FRAMES} frames at {HEIGHT}x{WIDTH}, f32, K = {cfg.TEST.N_MAX_OBJECTS + 1}, TF32 as "
        f"torch defaults it) in {wall:.2f} s on one engine: seconds per checkpoint in the order "
        f"scored {[(n, round(t, 3)) for n, t in per_ckpt]} (the first {order[0]} builds the "
        f"engine and captures its graphs, the others through update_weights); scores within "
        f"{worst:.3e} of test_net on each (tolerance 5e-5); best {os.path.basename(best)} kept, "
        f"the rest pruned; forward launches {counts} = {steps} chunk steps; the CLI logged all "
        f"{len(names)} after {cli['seconds_to_all']:.1f} s, within {cli_worst:.3e} of these, and "
        f"exited 0 on SIGTERM ({cli['seconds']:.1f} s in all); the phase "
        f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    report = dict(card=smi, checkpoints=names, seconds_per_checkpoint=per_ckpt, wall_s=wall,
                  scores=got, best=os.path.basename(best), test_net_worst=worst,
                  launches=counts, chunk_steps=steps, cli=cli, cli_worst=cli_worst)
    return report, counts["eager"] + counts["replayed"]


# -------------------------------------------------------------- train_bf16
# the bf16 step against the f32 step (TF32 off) on one batch and one set of
# weights, measured on the H100 at 9e-5 (loss), a median of 1.6% and at worst
# 3.6% of a tensor's largest gradient: the two differ by bf16's rounding
BF16_LOSS_REL, BF16_GRAD_REL, BF16_GRAD_MEDIAN = 2e-3, 0.1, 0.04


def _loss_grads(trainer, batch) -> tuple:
    """One forward and backward of the trainer's loss, nothing updated ->
    (loss, {RMNet parameter name: gradient})."""
    from rmnet_tpu_torch.train import make_loss_fn

    params = dict(trainer.rmnet.named_parameters())
    loss = make_loss_fn(trainer.cfg, trainer.apply, trainer.tflownet)(batch)
    loss = loss[0] if isinstance(loss, tuple) else loss
    return loss.item(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _time_steps(trainer, batch) -> dict:
    """1 warm-up and TRAIN_STEPS timed steps: median ms, clips/s, peak GB
    (absolute, and the steps' own above what was held before them)."""
    gc.collect()
    losses = [trainer.train_step(batch)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    ms = statistics.median(walls) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return dict(ms=ms, clips_per_s=batch["frames"].shape[0] / ms * 1e3, peak_gb=peak / 1e9,
                step_gb=(peak - base) / 1e9, walls_s=walls)


class _ConvDtypes:
    """The operand dtypes of every convolution, forward and backward, that
    runs inside (a torch dispatch mode)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = {}
        kinds = {torch.ops.aten.convolution.default: "forward",
                 torch.ops.aten.convolution_backward.default: "backward"}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in kinds:
                    key = (kinds[func],) + tuple(str(a.dtype).replace("torch.", "")
                                                 for a in args[:3] if torch.is_tensor(a))
                    seen[key] = seen.get(key, 0) + 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def conv_kernels_by_dtype(out_name) -> dict:
    """Device ms of the convolution bucket's kernels in the profile
    build/chip_smoke/``out_name`` (bucketed as profile_device buckets them)
    by the element type their name carries."""
    by = {}
    for line in (OUT_DIR / out_name).read_text().splitlines()[1:]:
        ms, _, _, name = line.split(None, 3)
        bucket = next((b for b, pats in _BUCKETS if any(p in name for p in pats)), None)
        if bucket != "convolutions":
            continue
        low = name.lower()
        tag = ("bf16" if "bf16" in low or "bfloat16" in low else "tf32" if "tf32" in low
               else "f16" if "f16" in low or "half" in low
               else "f32" if any(t in low for t in ("f32", "float", "sgemm")) else "untagged")
        by[tag] = by.get(tag, 0.0) + float(ms)
    return by


def bn_steps(smi, models, batch) -> dict:
    """Trainable BatchNorm at bf16 on the train phase's batch: one step from
    the same weights at REMAT "none" (twice), "encoders" and "step", whose
    running statistics must be bit-identical and all moved; the "encoders"
    step timed and profiled, then a NaN batch that must leave parameters,
    statistics and Adam's moments as they were; and the step at f32."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.train import Trainer

    stats, losses, timed = {}, {}, {}
    for mode in ("none", "none_again", "encoders", "step"):
        cfg = Config()
        cfg.TRAIN.BF16 = cfg.TRAIN.USE_BATCH_NORM = True
        cfg.TRAIN.REMAT = mode.split("_")[0]
        trainer = Trainer(cfg, *models)
        losses[mode] = trainer.train_step(batch)
        stats[mode] = {k: v.clone() for k, v in trainer.apply.running_stats().items()}
        if mode == "encoders":
            timed["bf16"] = _time_steps(trainer, batch)
            prof = profile_device(smi, lambda: trainer.train_step(batch), 1, "step",
                                  timed["bf16"]["ms"], "profile_train_bn.txt")
            before = {k: v.clone() for k, v in trainer.rmnet.state_dict().items()}
            moments = [v.clone() for st in trainer.optimizer.state.values() for v in st.values()]
            bad = dict(batch, frames=batch["frames"].clone())
            bad["frames"][0, 1, 3, 3, 0] = float("nan")
            nan_loss = trainer.train_step(bad)
            after = trainer.rmnet.state_dict()
            kept = (not math.isfinite(nan_loss) and all(torch.equal(after[k], v)
                                                        for k, v in before.items())
                    and all(torch.equal(a, b) for a, b in zip(
                        (v for st in trainer.optimizer.state.values() for v in st.values()),
                        moments)))
            if not kept:
                raise AssertionError(f"a NaN batch (loss {nan_loss}) changed the parameters, "
                                     f"the running statistics or Adam's moments")
        del trainer
        gc.collect()
    ref = stats["none"]
    diff = {m: max((stats[m][k] - v).abs().max().item() for k, v in ref.items())
            for m in ("none_again", "encoders", "step")}
    moved = sum(not torch.equal(v, models[0][k]) for k, v in ref.items())
    if any(diff.values()) or len({*losses.values()}) != 1 or moved != len(ref):
        raise AssertionError(f"trainable BN: statistics against REMAT 'none' {diff}, losses "
                             f"{losses}, {moved} of {len(ref)} statistics moved")
    cfg = Config()
    cfg.TRAIN.USE_BATCH_NORM = True
    trainer = Trainer(cfg, *models)
    timed["f32, TF32 off"] = _time_steps(trainer, batch)
    del trainer
    gc.collect()
    bn_share = prof["buckets_ms"]["batch norm"] / prof["busy_ms"]
    log(f"train_bf16: trainable BN (bf16): {len(ref)} running statistics, all moved, "
        f"bit-identical across REMAT 'none' (twice), 'encoders' and 'step' (max diff {diff}), "
        f"losses {losses}; a NaN batch left parameters, statistics and moments as they were; "
        f"step (REMAT 'encoders') {timed['bf16']['ms']:.3f} ms at bf16, batch norm "
        f"{bn_share:.1%} of its device time, {timed['f32, TF32 off']['ms']:.3f} ms at f32 TF32 "
        f"off; peak {timed['bf16']['peak_gb']:.2f} / {timed['f32, TF32 off']['peak_gb']:.2f} GB "
        f"[{smi}]")
    return dict(times=timed, remat_stat_diff=diff, losses=losses, profile=prof,
                bn_share=bn_share)


def train_net_bf16_bn(smi) -> tuple:
    """One train_net epoch with TRAIN.BF16 and TRAIN.USE_BATCH_NORM on the
    train_net phase's tree: finite losses, no batch skipped, and an f32
    ckpt-epoch-001.pth whose running statistics moved -> (report, forward
    launches, backward launches)."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd
    from rmnet_tpu_torch.train import TrainStats, train_net
    from rmnet_tpu_torch.utils.checkpoint import load_weights_auto

    cfg = Config.from_file(str(TN_DIR / "cfg.py"))
    cfg.TRAIN.BF16 = cfg.TRAIN.USE_BATCH_NORM = True
    cfg.TRAIN.N_EPOCHS, cfg.CONST.EXP_NAME = 1, "bf16_bn"
    stats = TrainStats()
    fmr.launches = fmr.captured = fmr.replayed = flash_read_bwd.launches = 0
    t0 = time.perf_counter()
    with torch_default_tf32():
        train_net(cfg, stats=stats)
    wall = time.perf_counter() - t0
    fwd, bwd = fmr.launches + fmr.replayed, flash_read_bwd.launches
    losses = _losses(cfg)
    n_batches = TN_VIDEOS * TN_REPEAT // cfg.TRAIN.BATCH_SIZE
    if (stats.skipped or stats.non_finite or stats.batches != n_batches
            or bwd != n_batches * (cfg.TRAIN.N_MAX_FRAMES - 1)):
        raise AssertionError(f"train_net with BF16 and USE_BATCH_NORM: {stats}, losses "
                             f"{losses}, backward launches {bwd}")
    ckpt = TN_DIR / "out" / "checkpoints" / cfg.CONST.EXP_NAME / "ckpt-epoch-001.pth"
    rm_sd = load_weights_auto(str(ckpt))[0]
    init = build_models(cfg, cfg.CONST.RNG_SEED, device="cpu")[0].state_dict()
    names = [k for k in rm_sd if ".running_" in k]
    moved = sum(rm_sd[k].dtype == torch.float32 and not torch.equal(rm_sd[k], init[k])
                for k in names)
    floats = {str(v.dtype) for v in rm_sd.values() if v.is_floating_point()}
    if moved != len(names) or floats != {"torch.float32"}:
        raise AssertionError(f"ckpt-epoch-001.pth: {moved} of {len(names)} running statistics "
                             f"moved, floating dtypes {floats}")
    batch_ms = [round(b * 1e3, 3) for _, b, _ in stats.batch_times]
    log(f"train_bf16: train_net, one epoch of {n_batches} batches with TRAIN.BF16 and "
        f"TRAIN.USE_BATCH_NORM on the train_net tree in {wall:.1f} s: losses "
        f"{[round(x, 5) for x in losses]}, BatchTime {batch_ms} ms, validation "
        f"{[round(x, 3) for x in stats.val_s]} s; ckpt-epoch-001.pth float32 with all "
        f"{len(names)} running statistics moved; read launches (fwd, bwd) ({fwd}, {bwd}) [{smi}]")
    return dict(wall_s=wall, losses=losses, batch_ms=batch_ms, val_s=stats.val_s,
                launches=dict(fwd=fwd, bwd=bwd)), fwd, bwd


def phase_train_bf16(smi, models) -> tuple:
    """TRAIN.BF16 at the reference TRAIN shape: the bf16 step against the
    f32 step (TF32 off) on one batch and the same weights; one step counted
    (T-1 forward and T-1 backward read launches, bf16 operands, every
    convolution bf16 x bf16); ms, clips/s and peak memory at bf16, f32 TF32
    off and f32 TF32 on; the step profiled (convolution kernels by type);
    both kernels timed at its last read; then trainable BN (bn_steps) and a
    train_net epoch with both flags -> (report, forward launches, backward
    launches)."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd
    from rmnet_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    cfg = Config()
    trainer = Trainer(cfg, *models)
    batch = trainer.to_device(make_train_batch(cfg))
    T = batch["frames"].shape[1]
    loss32, g32 = _loss_grads(trainer, batch)
    times = {"f32, TF32 off": _time_steps(trainer, batch)}
    with torch_default_tf32():
        times["f32, TF32 on"] = _time_steps(trainer, batch)
    del trainer
    gc.collect()
    cfg.TRAIN.BF16 = True
    trainer = Trainer(cfg, *models)
    loss16, g16 = _loss_grads(trainer, batch)
    rel = {k: ((g16[k] - g.float()).abs().max() / g.abs().max()).item()
           for k, g in g32.items() if g.abs().max() > 0}
    median, worst = statistics.median(rel.values()), max(rel, key=rel.get)
    loss_rel = abs(loss16 - loss32) / abs(loss32)
    dtypes = {str(g.dtype) for g in g16.values()} | {str(p.dtype) for p in
                                                     trainer.rmnet.parameters()}
    del g32, g16
    log(f"train_bf16: the bf16 step against the f32 step (TF32 off), same batch and weights: "
        f"loss {loss16:.6f} against {loss32:.6f} ({loss_rel:.3e}, bound {BF16_LOSS_REL}); "
        f"gradients per tensor max|bf16 - f32| / max|f32|: median {median:.3e} (bound "
        f"{BF16_GRAD_MEDIAN}), worst {rel[worst]:.3e} at {worst} (bound {BF16_GRAD_REL}); "
        f"parameters and gradients {sorted(dtypes)}")
    if (loss_rel > BF16_LOSS_REL or median > BF16_GRAD_MEDIAN or rel[worst] > BF16_GRAD_REL
            or dtypes != {"torch.float32"}):
        raise AssertionError("the bf16 step disagrees with the f32 step")
    # one step with the counts at 0: reads, their operands, the convolutions
    fmr.launches = fmr.captured = fmr.replayed = flash_read_bwd.launches = 0
    with _Record("flash_memory_read", grads=True) as rec, _ConvDtypes() as convs:
        trainer.train_step(batch)
    launches = (fmr.launches, flash_read_bwd.launches)
    read_types = [tuple(str(a.dtype) for a in call["args"][0][:3])
                  + (str(call["result"][0].dtype), str(call["d_out"].dtype)) for call in rec.calls]
    conv_types = {k: v for k, v in convs.seen.items()}
    if (launches != (T - 1, T - 1) or any(set(t) != {"torch.bfloat16"} for t in read_types)
            or any(set(k[1:]) != {"bfloat16"} for k in conv_types)):
        raise AssertionError(f"the bf16 step: launches {launches} (want {(T - 1, T - 1)}), "
                             f"reads {read_types}, convolutions {conv_types}")
    # both kernels at the step's last read, timed before the step is
    # profiled (as phases times and train_times order them)
    names = ("m_key", "m_val", "q_key", "slot_valid", "bboxes")
    call = rec.calls[-1]
    (args, kwargs), (out, lse) = call["args"], call["result"]
    c = dict(zip(names, (a.detach() for a in args)), **kwargs)
    bargs = bwd_args(c, call["d_out"], out.detach(), lse)
    del rec
    errs = (compare_read("train_bf16_step_read", c), compare_bwd("train_bf16_step_read", bargs))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd = fwd_time_row(c, flush, limit=None)
    log_fwd_times(f"the bf16 step's t={T - 1} read", fwd, smi)
    bwd = bwd_time_row(c, bargs, flush)
    log_bwd_times(f"the bf16 step's t={T - 1} read", bwd, T - 1, smi)
    times["bf16"] = _time_steps(trainer, batch)
    prof = profile_device(smi, lambda: trainer.train_step(batch), 1, "step",
                          times["bf16"]["ms"], "profile_train_bf16.txt")
    conv_ms = conv_kernels_by_dtype("profile_train_bf16.txt")
    for name, t in times.items():
        log(f"time train {name}: {t['ms']:.3f} ms per step, {t['clips_per_s']:.3f} clips/s "
            f"(median of {TRAIN_STEPS} steps after 1 warm-up), peak memory {t['peak_gb']:.2f} "
            f"GB, {t['step_gb']:.2f} GB above what was held [{smi}]")
    log(f"train_bf16: one step counted: read launches (fwd, bwd) {launches}, read operands "
        f"(keys, values, queries, out, d_out) {sorted(set(read_types))}; convolutions by "
        f"(pass, operand types): {conv_types}; convolution kernels' device ms by the type in "
        f"their name {conv_ms}")
    del trainer, flush, c, bargs
    gc.collect()
    bn = bn_steps(smi, models, batch)
    del batch
    gc.collect()
    tn, tn_fwd, tn_bwd = train_net_bf16_bn(smi)
    log(f"train_bf16: the phase {time.perf_counter() - t_phase:.1f} s")
    report = dict(card=smi, tf32="off unless named", loss=dict(bf16=loss16, f32=loss32),
                  grad_rel_median=median, grad_rel_worst=(worst, rel[worst]), times=times,
                  launches_per_step=launches, read_types=sorted(set(read_types)),
                  conv_types={" ".join(k): v for k, v in conv_types.items()},
                  conv_kernel_ms=conv_ms, profile=prof, fwd_read=fwd, bwd_read=bwd,
                  kernel_vs_plain=errs, bn=bn, train_net=tn)
    return report, launches[0] + tn_fwd, launches[1] + tn_bwd


def _losses(cfg) -> list:
    """The per-batch losses of a train_net run, from its train summary."""
    path = Path(cfg.DIR.OUTPUT_DIR) / "logs" / cfg.CONST.EXP_NAME / "train" / "scalars.jsonl"
    return [r["value"] for r in map(json.loads, path.read_text().splitlines())
            if r["tag"] == "Loss/Batch"]


# --------------------------------------------------------------------- dp
# TRAIN.DATA_PARALLEL on the one card: two gloo ranks on cuda:0 (NCCL takes
# one rank per device), each holding half of the reference TRAIN batch
DP_DEVICES = ("cuda:0", "cuda:0")
DP_TIMEOUT_S, DP_DEADLINE_S = 120, 360
DP_LOSS_REL = 5e-5       # the DP step's loss against the single-process step's
# Trainable BN over the mesh takes the JAX layer's statistics, E[x^2] - mean^2
# from float32 sums, which lose digits to cancellation; the single step's are
# cuDNN's. Measured on the H100 at f32: statistics 2.4e-4 of a tensor's
# largest value apart, the loss 5.2e-5: held to 1e-3 and 1e-4. With bf16
# convolutions each rank's cuDNN algorithms also round elsewhere than the
# single step's: the loss is held to phase train_bf16's bf16-against-f32 bar,
# the statistics to 2e-2 (6.3e-3 measured).
DP_BN_LOSS_REL, DP_BN_STATS_REL, DP_BF16_STATS_REL = 1e-4, 1e-3, 2e-2
DP_TRAIN_NET_REL = 1e-3  # train_net's logged losses, DP against single-process
DP_TIMED_STEPS = 2
DP_SEED = 5              # the random state of both train_net runs (frame-step curriculum)
DP_VARIANTS = {          # TRAIN fields on top of the reference's (REMAT "encoders", flash)
    "f32": dict(),
    "accum2": dict(GRAD_ACCUM_STEPS=2),
    "bn_f32": dict(USE_BATCH_NORM=True),
    "bn_bf16": dict(USE_BATCH_NORM=True, BF16=True),
}
DP_DIR = OUT_DIR / "dp"


def _dp_cfg(n, train):
    from rmnet_tpu_torch.config import Config

    cfg = Config()
    cfg.TRAIN.DATA_PARALLEL = n
    for k, v in train.items():
        setattr(cfg.TRAIN, k, v)
    return cfg


def _state_digest(module) -> str:
    """A hash of ``module``'s parameters and statistics, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode() + v.detach().cpu().reshape(-1).numpy().tobytes())
    return h.hexdigest()


def _grad_median(got, want) -> float:
    """The median over tensors of ||got - want|| / ||want||."""
    return statistics.median((got[n] - w).norm().item() / max(w.norm().item(), 1e-30)
                             for n, w in want.items())


def _stats_rel(got, want) -> float:
    """max over statistics tensors of max |got - want| / max |want|."""
    return max(((got[k] - v).abs().max() / v.abs().max()).item() for k, v in want.items())


def _sync_ms(mesh, fn, reps=3) -> float:
    """Median ms of ``fn`` over ``reps`` runs, every rank starting together."""
    from rmnet_tpu_torch.parallel import barrier

    walls = []
    for _ in range(reps):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def dp_collective_times(mesh, cfg, n_params) -> dict:
    """ms and bytes of each collective of the DP step alone, at the step's
    sizes: the gradient bucket, the loss gather (a rank's estimates and
    labels), one BatchNorm all-reduce (256 channels) and the batch
    broadcast (the global batch, as train_net sends it)."""
    from rmnet_tpu_torch.parallel import all_gather_rows, broadcast_tensors

    tr = cfg.TRAIN
    B, T, K = tr.BATCH_SIZE // mesh.size, tr.N_MAX_FRAMES, tr.N_MAX_OBJECTS + 1
    H, W = tr.AUGMENTATION.CROP_HSIZE, tr.AUGMENTATION.CROP_WSIZE
    dev = mesh.device
    grads = torch.zeros(n_params, device=dev)
    probs = torch.zeros(B, T - 1, H, W, K, device=dev)
    labels = torch.zeros(B, T - 1, H, W, dtype=torch.int32, device=dev)
    bn = torch.zeros(2, 256, device=dev)
    batch = [torch.zeros(tr.BATCH_SIZE, T, H, W, 3), torch.zeros(tr.BATCH_SIZE, T, K, H, W,
                                                                  dtype=torch.uint8),
             torch.zeros(tr.BATCH_SIZE, T, H, W, 2), torch.zeros(tr.BATCH_SIZE, T,
                                                                 dtype=torch.int64)]
    batch = [t.to(mesh.comm_device) for t in batch]
    rows = {
        "gradients": (lambda: mesh.all_reduce_(grads, "timing"), grads.numel() * 4),
        "loss gather": (lambda: (all_gather_rows(probs, mesh, "timing"),
                                 all_gather_rows(labels, mesh, "timing")),
                        (probs.numel() + labels.numel()) * 4 * mesh.size),
        "batch norm (256 channels)": (lambda: mesh.all_reduce_(bn, "timing"), bn.numel() * 4),
        "batch broadcast": (lambda: broadcast_tensors(batch, mesh, "timing"),
                            sum(t.numel() * t.element_size() for t in batch)),
    }
    return {k: dict(ms=_sync_ms(mesh, fn), bytes=nbytes) for k, (fn, nbytes) in rows.items()}


def dp_worker(mesh) -> dict:
    """One rank of phase dp: for each DP_VARIANTS entry, rank 0 takes the
    Trainer's single-process step on the reference TRAIN batch (twice with
    trainable BN, for its floor), then every rank takes the DP step on it
    from the same weights (the kernels' launches and the collectives
    counted), compared with it on rank 0 (loss, gradients, statistics), and
    timed over DP_TIMED_STEPS steps; then the collectives alone
    (dp_collective_times)."""
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd
    from rmnet_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rmnet, tfn = build_models(seed=0)  # the weights of main()'s models
    models = (rmnet.state_dict(), tfn.state_dict())
    n_params = sum(p.numel() for p in rmnet.parameters())
    del rmnet, tfn
    out = {}
    for name, train in DP_VARIANTS.items():
        cfg = _dp_cfg(mesh.size, train)
        batch = make_train_batch(cfg)
        ref = floor = None
        if mesh.rank == 0:
            refs = []
            # with trainable BN the single-process step twice: its own floor
            for _ in range(2 if train.get("USE_BATCH_NORM") else 1):
                single = Trainer(_dp_cfg(1, train), *models)
                refs.append(dict(
                    loss=single.train_step(batch),
                    grads={n: p.grad.clone() for n, p in single.rmnet.named_parameters()
                           if p.grad is not None},
                    stats={k: v.clone() for k, v in single.apply.running_stats().items()}))
                del single
            ref = refs[0]
            if len(refs) == 2:
                again = refs[1]
                floor = dict(loss_rel=abs(again["loss"] - ref["loss"]) / abs(ref["loss"]),
                             grad_worst_rel=grad_rel(again["grads"], ref["grads"])[0],
                             grad_median_rel=_grad_median(again["grads"], ref["grads"]),
                             stats_rel=_stats_rel(again["stats"], ref["stats"]))
            del refs
        trainer = Trainer(cfg, *models, mesh=mesh)
        mesh.counts.clear()
        fmr.launches = fmr.captured = fmr.replayed = flash_read_bwd.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        row = dict(loss=loss, launches=(fmr.launches, flash_read_bwd.launches),
                   counts={k: list(v) for k, v in mesh.counts.items()},
                   digest=_state_digest(trainer.rmnet),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if ref is not None:
            got = {n: p.grad for n, p in trainer.rmnet.named_parameters() if p.grad is not None}
            worst, bad = grad_rel(got, ref["grads"])
            stats = trainer.apply.running_stats()
            row.update(
                loss_single=ref["loss"], loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                grad_worst_rel=worst, grad_median_rel=_grad_median(got, ref["grads"]),
                grad_bad=bad[:8], n_grad_bad=len(bad),
                stats_rel=_stats_rel(stats, ref["stats"]) if cfg.TRAIN.USE_BATCH_NORM else None,
                floor=floor)
            del ref, got
        row["step_ms"] = statistics.median(
            _sync_ms(mesh, lambda: trainer.train_step(batch), 1) for _ in range(DP_TIMED_STEPS))
        out[name] = row
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    out["collectives"] = dp_collective_times(mesh, _dp_cfg(mesh.size, {}), n_params)
    return out


def dp_group_of_one(models) -> dict:
    """An NCCL group of one, in this process, through the DP code (the
    gather, the gradient all-reduce), against the Trainer's step on the
    reference TRAIN batch: the same loss bit for bit, the gradients within
    GRAD_REL_TOL per tensor, and the parameters bit-identical in every
    tensor whose gradient is (the single-process step itself is not
    bit-reproducible: the backward's atomic sums)."""
    from rmnet_tpu_torch.parallel import init_mesh
    from rmnet_tpu_torch.train import Trainer

    store = DP_DIR / "store_one"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    cfg = _dp_cfg(1, {})
    batch = make_train_batch(cfg)
    mesh = init_mesh(0, 1, f"file://{store}", "nccl", "cuda:0", DP_TIMEOUT_S)
    try:
        runs = []
        for m in (None, mesh):
            trainer = Trainer(cfg, *models, mesh=m)
            loss = trainer.train_step(batch)
            runs.append((loss, {n: p.grad.clone() for n, p in trainer.rmnet.named_parameters()
                                if p.grad is not None},
                         {k: v.clone() for k, v in trainer.rmnet.state_dict().items()}))
            del trainer
        counts = {k: list(v) for k, v in mesh.counts.items()}
    finally:
        mesh.close()
    (loss_a, grads_a, state_a), (loss_b, grads_b, state_b) = runs
    worst, bad = grad_rel(grads_b, grads_a)
    same_grad = {n for n in grads_a if torch.equal(grads_a[n], grads_b[n])}
    same_param = {n for n in grads_a if torch.equal(state_a[n], state_b[n])}
    report = dict(loss=loss_a, loss_one=loss_b, grad_worst_rel=worst, n_grad_bad=len(bad),
                  tensors=len(grads_a), same_grads=len(same_grad), same_params=len(same_param),
                  counts=counts)
    report["ok"] = loss_a == loss_b and not bad and same_grad <= same_param
    log(f"dp: an NCCL group of one against the Trainer's step: loss {loss_b!r} against "
        f"{loss_a!r}; gradients largest ||diff||/||single|| {worst:.3e}, {len(bad)} past "
        f"{GRAD_REL_TOL}; {len(same_grad)} of {len(grads_a)} gradients and {len(same_param)} "
        f"parameter tensors bit-identical; collectives {counts}")
    return report


def dp_train_net_main(cfg_path) -> int:
    """The parent of ``train_net`` at TRAIN.DATA_PARALLEL = 2 (two gloo
    ranks on cuda:0, TF32 off, DP_SEED's random state), in a process of its
    own (chip_smoke.py --dp-train-net CFG); prints rank 0's TrainStats as
    its last line."""
    import logging
    import random

    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.train import TrainStats, train_net

    logging.basicConfig(format="[%(levelname)s] %(asctime)s %(message)s", level=logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_file(cfg_path)
    random.seed(DP_SEED)
    stats = TrainStats()
    train_net(cfg, stats=stats, devices=DP_DEVICES, backend="gloo", timeout_s=DP_TIMEOUT_S)
    log(json.dumps(dataclasses.asdict(stats)))
    return 0


def _dp_train_net_cfg(n, epochs) -> Path:
    """A config file over phase train_net's tree: the reference TRAIN, no
    epoch checkpoint (ckpt-best.pth only), one video validated, its own
    output directory."""
    path = DP_DIR / f"cfg_{n}.py"
    path.write_text(
        (TN_DIR / "cfg.py").read_text()
        + f"    cfg.TRAIN.DATA_PARALLEL = {n}\n"
        + f"    cfg.TRAIN.N_EPOCHS = {epochs}\n"
        + "    cfg.TRAIN.CKPT_SAVE_THRESHOLD = 2.0\n"
        + "    cfg.TEST.TESTING_VIDEOS_INDEXES = (0,)\n"
        + f"    cfg.DIR.OUTPUT_DIR = {str(DP_DIR / f'out_{n}')!r}\n")
    return path


def dp_train_net(meanwhile) -> tuple:
    """train_net at DATA_PARALLEL = 2 (dp_train_net_main, a process) for 2
    epochs, stopped by SIGTERM after epoch 2's first batch, beside
    single-process train_net for 1 epoch in this process (TF32 off both,
    the same random state), then ``meanwhile()``: epoch 1's logged losses
    within DP_TRAIN_NET_REL, validation once, ckpt-best.pth of epoch 1, exit
    0 with ckpt-interrupt.pth at epoch 1 -> (report, what meanwhile
    returned)."""
    import random
    import signal

    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.train import TrainStats, train_net

    shutil.rmtree(DP_DIR / "out_1", ignore_errors=True)
    shutil.rmtree(DP_DIR / "out_2", ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-train-net",
                             str(_dp_train_net_cfg(2, 2))], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, signalled = [], []

    def read():  # the ranks' logs come through the parent's output
        for line in proc.stdout:
            lines.append(line)
            if "[Epoch 2/2][Batch 1/" in line and not signalled:
                signalled.append(time.perf_counter())
                proc.send_signal(signal.SIGTERM)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    cfg1 = Config.from_file(str(_dp_train_net_cfg(1, 1)))
    random.seed(DP_SEED)
    stats1 = TrainStats()
    train_net(cfg1, stats=stats1)
    beside = meanwhile()
    try:
        rc = proc.wait(timeout=DP_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("train_net at DATA_PARALLEL = 2 did not end in time")
    reader.join(10)
    wall = time.perf_counter() - t0
    text = "".join(lines)
    (DP_DIR / "train_net_dp.log").write_text(text)
    cfg2 = Config.from_file(str(_dp_train_net_cfg(2, 2)))
    losses1, losses2 = _losses(cfg1), _losses(cfg2)
    stats2 = json.loads(text.strip().splitlines()[-1]) if rc == 0 else {}
    ckpts = sorted(p.name for p in (DP_DIR / "out_2" / "checkpoints" / cfg2.CONST.EXP_NAME)
                   .glob("*.pth"))
    n = len(losses1)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses2[:n], losses1)]
    report = dict(wall_s=wall, rc=rc, losses_single=losses1, losses_dp=losses2, loss_rel=rel,
                  checkpoints=ckpts, val_s=stats2.get("val_s"), batches=stats2.get("batches"),
                  batch_times=stats2.get("batch_times"),
                  exit_s=None if not signalled else time.perf_counter() - signalled[0])
    log(f"dp: train_net at DATA_PARALLEL = 2 (gloo, cuda:0 twice, TF32 off) stopped by "
        f"SIGTERM in epoch 2: exit {rc}, losses {[round(x, 6) for x in losses2]} against "
        f"single-process {[round(x, 6) for x in losses1]} (relative {[f'{x:.2e}' for x in rel]}, "
        f"bound {DP_TRAIN_NET_REL}), validation {report['val_s']} s, {report['batches']} "
        f"batches on rank 0, checkpoints {ckpts}; {wall:.1f} s")
    stopped = "Stopped in epoch 2" in text
    if (rc != 0 or not stopped or len(losses1) != len(losses2[:n]) or n == 0
            or max(rel) > DP_TRAIN_NET_REL or len(report["val_s"] or ()) != 1
            or ckpts != ["ckpt-best.pth", "ckpt-interrupt.pth"]):
        raise AssertionError(f"train_net at DATA_PARALLEL = 2: {report}\n{text[-4000:]}")
    saved = torch.load(DP_DIR / "out_2" / "checkpoints" / cfg2.CONST.EXP_NAME
                       / "ckpt-interrupt.pth", map_location="cpu", weights_only=True)
    if saved["epoch_index"] != 1:
        raise AssertionError(f"ckpt-interrupt.pth holds epoch {saved['epoch_index']}, want 1")
    return report, beside


def phase_dp(smi, models) -> tuple:
    """TRAIN.DATA_PARALLEL on the card: train_net end to end with SIGTERM
    (dp_train_net), an NCCL group of one while its process runs
    (dp_group_of_one), the DP step on two gloo ranks against the
    single-process step (dp_worker) -> (report, forward launches, backward
    launches of the counted DP steps)."""
    from rmnet_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    DP_DIR.mkdir(parents=True, exist_ok=True)
    tn, one = dp_train_net(lambda: dp_group_of_one(models))
    ranks = launch(dp_worker, (), DP_DEVICES, "gloo", DP_TIMEOUT_S, DP_DEADLINE_S)
    rank0 = ranks[0]
    T = _dp_cfg(2, {}).TRAIN.N_MAX_FRAMES
    fwd = bwd = 0
    bad = []
    for name in DP_VARIANTS:
        rows = [r[name] for r in ranks]
        r0 = rows[0]
        accum = DP_VARIANTS[name].get("GRAD_ACCUM_STEPS", 1)
        fwd += sum(r["launches"][0] for r in rows)
        bwd += sum(r["launches"][1] for r in rows)
        counts = {k: v[0] for k, v in r0["counts"].items()}
        log(f"dp {name}: 2 gloo ranks on cuda:0, the reference TRAIN batch (B=4, 2 rows a rank): "
            f"loss {r0['loss']!r} against single-process {r0['loss_single']!r} "
            f"({r0['loss_rel']:.3e}); gradients largest ||dp - single||/||single|| "
            f"{r0['grad_worst_rel']:.3e} (median {r0['grad_median_rel']:.3e}), "
            f"{r0['n_grad_bad']} past {GRAD_REL_TOL} {r0['grad_bad'][:3]}; statistics "
            f"{r0['stats_rel']}; the single-process step against itself {r0['floor']}; "
            f"replicas bit-identical "
            f"{rows[0]['digest'] == rows[1]['digest']}; read launches per rank "
            f"{[r['launches'] for r in rows]}; {r0['step_ms']:.3f} ms per DP step (median of "
            f"{DP_TIMED_STEPS}), peak memory per rank {[round(r['peak_gb'], 2) for r in rows]} "
            f"GB; collectives per step (calls) {counts}, bytes "
            f"{ {k: v[1] for k, v in r0['counts'].items()} } [{smi}]")
        if rows[0]["digest"] != rows[1]["digest"]:
            bad.append(f"{name}: replicas differ after the step")
        if any(r["launches"] != (accum * (T - 1), accum * (T - 1)) for r in rows):
            bad.append(f"{name}: read launches {[r['launches'] for r in rows]}")
        bf16, bn = (DP_VARIANTS[name].get(k, False) for k in ("BF16", "USE_BATCH_NORM"))
        loss_bar = BF16_LOSS_REL if bf16 else DP_BN_LOSS_REL if bn else DP_LOSS_REL
        if r0["loss_rel"] > loss_bar:
            bad.append(f"{name}: loss {r0['loss_rel']:.3e} past {loss_bar}")
        if not bn and r0["n_grad_bad"]:
            bad.append(f"{name}: gradients {r0['grad_bad']}")
        if bn and r0["stats_rel"] > (DP_BF16_STATS_REL if bf16 else DP_BN_STATS_REL):
            bad.append(f"{name}: statistics {r0['stats_rel']:.3e}")
    for k, v in rank0["collectives"].items():
        log(f"time dp collective {k}: {v['ms']:.3f} ms, {v['bytes'] / 1e6:.3f} MB (2 gloo "
            f"ranks on cuda:0, staged through pinned host memory) [{smi}]")
    if not one["ok"]:
        bad.append(f"the group of one differs from the Trainer's step: {one}")
    for name in ("out_1", "out_2"):  # checkpoints of about 0.5 GB each
        shutil.rmtree(DP_DIR / name / "checkpoints", ignore_errors=True)
    log(f"dp: the phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError("phase dp: " + "; ".join(bad))
    report = dict(card=smi, tf32="off", variants={n: [r[n] for r in ranks] for n in DP_VARIANTS},
                  collectives=rank0["collectives"], group_of_one=one, train_net=tn)
    return report, fwd, bwd


# ---------------------------------------------------------------- spatial
# spatial_forward_video on the one card: two gloo ranks on cuda:0 (NCCL takes
# one rank per device), each holding 27 of the 54 columns of the /16 grid of
# the 480x854 clip padded to 480x864
SPATIAL_DEVICES = ("cuda:0", "cuda:0")
SPATIAL_T, SPATIAL_APPEAR = 12, 4  # the second object appears at frame 4
SPATIAL_TOL = 1e-4  # the probabilities, against the single forward (f32, TF32 off)
SPATIAL_TIMEOUT_S, SPATIAL_DEADLINE_S = 120, 480
SPATIAL_DIR = OUT_DIR / "spatial"


def spatial_clip() -> tuple:
    """The phase's clip in forward_video's layout (B=1): make_clip's frames
    and masks (2 objects, the second appearing at frame SPATIAL_APPEAR) and
    seeded flows of up to 24 columns and 6 rows, so that a vector may point
    into the other rank's columns; on the card."""
    frames, masks, n_objects = make_clip(SPATIAL_T, HEIGHT, WIDTH, N_OBJECTS,
                                         appear=SPATIAL_APPEAR)
    rs = np.random.RandomState(7)
    shape = (SPATIAL_T, HEIGHT, WIDTH)
    flows = np.stack([rs.uniform(-24, 24, shape), rs.uniform(-6, 6, shape)], -1)
    cuda = [torch.from_numpy(x[None]).cuda() for x in (frames, masks, flows.astype(np.float32))]
    return (*cuda, n_objects[None])


def _spatial_settings() -> None:
    """f32 with TF32 off and cuDNN deterministic, in every process of the phase."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


class recorded_boxes:
    """Every box RMNetApply._att computes in the block (memorize's of the
    previous estimate, then the warped mask's, per frame), in call order,
    as int32 tensors on the host."""

    def __enter__(self):
        from rmnet_tpu_torch.models.rmnet import RMNetApply

        self.real, self.boxes = RMNetApply._att, []

        def att(apply, *args, **kwargs):
            out = self.real(apply, *args, **kwargs)
            self.boxes.append(out[1].cpu())
            return out

        RMNetApply._att = att
        return self.boxes

    def __exit__(self, *exc):
        from rmnet_tpu_torch.models.rmnet import RMNetApply

        RMNetApply._att = self.real


def _peak_gb(fn) -> tuple:
    """``fn()`` -> (its result, the peak device memory it allocated above
    what was held before it, GB)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - held) / 1e9


def spatial_single() -> dict:
    """The single forward_video on the phase's clip (the weights of seed 0,
    memorize_every 5, flash read): the estimate and boxes of a first run
    with the read's launches counted, then a timed run -> a report; the
    estimate and boxes go to SPATIAL_DIR/single.pt for the ranks."""
    from rmnet_tpu_torch.models.rmnet import RMNetApply
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr

    rmnet, _ = build_models(seed=0)
    apply = RMNetApply(rmnet, memorize_every=MEMORIZE_EVERY)
    clip = spatial_clip()
    fmr.launches = 0
    with torch.no_grad(), recorded_boxes() as boxes:
        est, peak = _peak_gb(lambda: apply.forward_video(*clip))
    launches = fmr.launches
    with torch.no_grad():
        wall = _walls(lambda: apply.forward_video(*clip), 1)[0]
    SPATIAL_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(dict(est=est.cpu(), boxes=boxes), SPATIAL_DIR / "single.pt")
    return dict(frame_ms=wall / (SPATIAL_T - 1) * 1e3, peak_gb=peak, launches=launches)


def spatial_worker(mesh) -> dict:
    """One rank of phase spatial: spatial_forward_video on the phase's clip
    (the weights of seed 0, as in main()) with the read's launches counted
    and the boxes recorded, held against the single forward's estimate and
    boxes; then a second call, timed from a barrier, with its collectives
    counted by kind, the plans cached before and after, and its estimate
    against the first."""
    from rmnet_tpu_torch.models.rmnet import RMNetApply
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.parallel import barrier, space

    _spatial_settings()
    rmnet, _ = build_models(seed=0)
    apply = RMNetApply(rmnet, memorize_every=MEMORIZE_EVERY)
    clip = spatial_clip()
    fmr.launches = fmr.captured = fmr.replayed = 0
    with recorded_boxes() as boxes:
        est, peak = _peak_gb(lambda: space.spatial_forward_video(apply, *clip, mesh))
    launches = fmr.launches
    plans = [len(space._SPATIAL_PLANS)]
    barrier(mesh)
    mesh.counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = space.spatial_forward_video(apply, *clip, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plans.append(len(space._SPATIAL_PLANS))
    single = torch.load(SPATIAL_DIR / "single.pt", weights_only=True)
    err = (est.cpu() - single["est"]).abs().max().item()
    same_boxes = len(boxes) == len(single["boxes"]) and all(
        torch.equal(a, b) for a, b in zip(boxes, single["boxes"]))
    return dict(err=err, same_boxes=same_boxes, n_boxes=len(boxes),
                repeat_identical=torch.equal(est, again), plans=plans, launches=launches,
                frame_ms=wall / (SPATIAL_T - 1) * 1e3, peak_gb=peak,
                counts={k: list(v) for k, v in mesh.counts.items()},
                shape=list(est.shape), finite=bool(torch.isfinite(est).all()))


def spatial_read_times(smi) -> dict:
    """The forward at phase spatial's read (KERNEL_CASES spatial_S12_f32):
    kernel, plain and SDPA ms and the bound (fwd_time_row)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    read = fwd_time_row(bank_case(*KERNEL_CASES["spatial_S12_f32"]), flush, None)
    log_fwd_times("phase spatial's read (a 30x27 query shard, S=12, f32)", read, smi)
    return read


def phase_spatial(smi) -> tuple:
    """spatial_forward_video on the card: the single forward first
    (spatial_single), then two gloo ranks on cuda:0 (spatial_worker): every
    rank's estimate of the whole clip within SPATIAL_TOL of the single
    forward's, every frame's boxes equal, a repeated call bit-identical with
    no new plan, T-1 read launches per rank; the read at its query shard
    timed (spatial_read_times) -> (report, forward launches of the
    counted runs)."""
    from rmnet_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    _spatial_settings()
    try:
        single = spatial_single()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch(spatial_worker, (), SPATIAL_DEVICES, "gloo", SPATIAL_TIMEOUT_S,
                   SPATIAL_DEADLINE_S)
    frames = SPATIAL_T - 1
    per_frame = {k: dict(calls=v[0] / frames, bytes=v[1] / frames, ms=v[2] / frames * 1e3)
                 for k, v in ranks[0]["counts"].items()}
    for rank, r in enumerate(ranks):
        log(f"spatial rank {rank} of 2 (gloo, cuda:0 twice, f32, TF32 off, cuDNN deterministic):"
            f" {HEIGHT}x{WIDTH}, T={SPATIAL_T}, {N_OBJECTS} objects, memorize_every "
            f"{MEMORIZE_EVERY}: "
            f"max|est - single| {r['err']:.3e} (bound {SPATIAL_TOL}), {r['n_boxes']} boxes "
            f"equal {r['same_boxes']}, repeated call bit-identical {r['repeat_identical']}, "
            f"plans {r['plans']}, read launches {r['launches']}; {r['frame_ms']:.3f} ms per "
            f"frame against the single forward's {single['frame_ms']:.3f}; peak memory "
            f"{r['peak_gb']:.3f} GB against {single['peak_gb']:.3f} [{smi}]")
    for k, v in per_frame.items():
        log(f"spatial collective {k}: {v['calls']:.2f} calls, {v['bytes'] / 1e6:.4f} MB, "
            f"{v['ms']:.3f} ms per frame on rank 0 (staged through pinned host memory) [{smi}]")
    read = spatial_read_times(smi)
    log(f"spatial: the phase {time.perf_counter() - t_phase:.1f} s")
    bad = [f"rank {i}: {r}" for i, r in enumerate(ranks)
           if not (r["err"] <= SPATIAL_TOL and r["same_boxes"] and r["repeat_identical"]
                   and r["finite"] and r["plans"] == [1, 1] and r["launches"] == frames
                   and r["n_boxes"] == 2 * frames
                   and r["shape"] == [1, SPATIAL_T, N_OBJECTS + 1, HEIGHT, WIDTH])]
    if single["launches"] != frames:
        bad.append(f"the single forward launched the read {single['launches']} times")
    if bad:
        raise AssertionError("phase spatial: " + "; ".join(bad))
    report = dict(card=smi, single=single, ranks=ranks, collectives_per_frame=per_frame,
                  read=read)
    return report, sum(r["launches"] for r in ranks)


# ----------------------------------------------------------------- hybrid
# hybrid batch x width training on the one card: a 2 x 2 grid of gloo ranks on
# cuda:0 (NCCL takes one rank per device), world rank r at (r // 2, r % 2),
# each holding 2 rows of the reference TRAIN batch and its columns of the crop:
# for RMNet 15 of the 30 columns of the /16 grid of the 465x465 crop padded to
# 480x480, or in variant columnless the one /16 column of a 465x16 crop, held
# by the first space rank of each row (the second holds none); for TinyFlowNet
# (phase hybrid_tfn) 4 of the 8 columns of the /64 grid of the crop padded to
# 512x512
HYBRID_GRID = (2, 2)
HYBRID_DEVICES = ("cuda:0",) * 4
HYBRID_TIMED_STEPS = 3  # after the counted step, which warms up
# tests/test_parallel.py:99-167's bars: the loss relative, each gradient
# tensor's ||diff|| / ||single||, or max |diff| against the largest gradient
HYBRID_LOSS_REL, HYBRID_GRAD_REL, HYBRID_ESCAPE = 5e-5, 5e-4, 1e-6
HYBRID_TIMEOUT_S, HYBRID_DEADLINE_S = 120, 480
# name -> (TRAIN fields on top of the reference's, the columns of the reference
# crop that the batch keeps, or None for all of them)
HYBRID_VARIANTS = {"f32": ({}, None), "bn": (dict(USE_BATCH_NORM=True), None),
                   "columnless": ({}, (200, 216))}
HYBRID_TFN_VARIANTS = {"tfn": (dict(NETWORK="TinyFlowNet"), None)}
HYBRID_DIR = OUT_DIR / "hybrid"


def _jax_bar(got, want) -> tuple:
    """(largest ||got - want|| / ||want||, the tensors past HYBRID_GRAD_REL
    whose max |got - want| is past HYBRID_ESCAPE of the largest |want|)."""
    gmax = max(w.abs().max().item() for w in want.values())
    worst, bad = 0.0, []
    for name, w in want.items():
        err, ref = (got[name] - w).norm().item(), w.norm().item()
        worst = max(worst, err / ref if ref > 0 else (0.0 if err == 0 else math.inf))
        if err > HYBRID_GRAD_REL * ref and (got[name] - w).abs().max().item() > \
                HYBRID_ESCAPE * gmax:
            bad.append((name, err / (ref + 1e-30)))
    return worst, bad


def hybrid_batch(cfg, columns=None) -> dict:
    """The reference TRAIN batch (make_train_batch), or its ``columns``
    [start, end) of the 465x465 crop."""
    batch = make_train_batch(cfg)
    if columns is None:
        return batch
    lo, hi = columns
    return dict(frames=np.ascontiguousarray(batch["frames"][:, :, :, lo:hi]),
                masks=np.ascontiguousarray(batch["masks"][..., lo:hi]),
                flows=np.ascontiguousarray(batch["flows"][:, :, :, lo:hi]),
                n_objects=batch["n_objects"])


def _trained(trainer):
    """The network that the trainer's TRAIN.NETWORK trains."""
    return trainer.rmnet if trainer.cfg.TRAIN.NETWORK == "RMNet" else trainer.tflownet


def hybrid_single(models, variants, path) -> dict:
    """The Trainer's single-process step on each variant's batch, f32 with
    TF32 off and cuDNN deterministic: the loss, gradients and statistics of
    the first step (to ``path``), its peak memory, and the ms of 2 more
    steps."""
    from rmnet_tpu_torch.train import Trainer

    out, ref = {}, {}
    for name, (train, columns) in variants.items():
        cfg = _dp_cfg(1, train)
        trainer = Trainer(cfg, *models)
        batch = hybrid_batch(cfg, columns)
        loss, peak = _peak_gb(lambda: trainer.train_step(batch))
        # trainable BN is held by its loss and statistics (phase dp's bars)
        ref[name] = dict(loss=loss,
                         grads={} if train.get("USE_BATCH_NORM") else {
                             n: p.grad.cpu() for n, p in _trained(trainer).named_parameters()
                             if p.grad is not None},
                         stats={k: v.cpu() for k, v in trainer.apply.running_stats().items()})
        walls = _walls(lambda: trainer.train_step(batch), 2)
        out[name] = dict(loss=loss, peak_gb=peak, step_ms=statistics.median(walls) * 1e3)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    HYBRID_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(ref, path)
    return out


def hybrid_worker(world, variants, path, timed) -> dict:
    """One rank of phase hybrid or hybrid_tfn: for each of ``variants``, the
    Trainer's step on the 2 x 2 grid (DATA_PARALLEL = 2 rows of it) from the
    weights of seed 0 on the variant's batch, with the reads' launches and
    the collectives counted, held against the single step of ``path`` on
    world rank 0; for each variant of ``timed`` HYBRID_TIMED_STEPS more,
    timed from a barrier, with their collectives; the rank's columns, the parameters with
    a gradient, a digest of the trained network after the steps."""
    from rmnet_tpu_torch.models.tiny_flownet import CELL
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd
    from rmnet_tpu_torch.parallel import make_hybrid_mesh
    from rmnet_tpu_torch.parallel.space import width_mesh
    from rmnet_tpu_torch.train import Trainer

    _spatial_settings()
    grid = make_hybrid_mesh(*HYBRID_GRID, world, HYBRID_TIMEOUT_S)
    rmnet, tfn = build_models(seed=0)
    models = (rmnet.state_dict(), tfn.state_dict())
    del rmnet, tfn
    single = torch.load(path, weights_only=True) if world.rank == 0 else {}

    def counts():
        return {f"{mn}: {k}": list(v) for mn, m in grid.meshes().items()
                for k, v in m.counts.items()}

    out = dict(place=(grid.data.rank, grid.space.rank))
    for name, (train, columns) in variants.items():
        cfg = _dp_cfg(HYBRID_GRID[0], train)
        batch = hybrid_batch(cfg, columns)
        trainer = Trainer(cfg, *models, mesh=grid)
        net = _trained(trainer)
        cell = 16 if cfg.TRAIN.NETWORK == "RMNet" else CELL
        width = width_mesh(grid.space, *batch["masks"].shape[-2:], cell)
        for m in grid.meshes().values():
            m.counts.clear()
        fmr.launches = fmr.captured = fmr.replayed = flash_read_bwd.launches = 0
        loss, peak = _peak_gb(lambda: trainer.train_step(batch))
        row = dict(loss=loss, launches=(fmr.launches, flash_read_bwd.launches),
                   counts=counts(), peak_gb=peak, cell=cell,
                   columns=width.grid[grid.space.rank], holds=width.rank < width.holders,
                   with_grad=sorted(n for n, p in net.named_parameters() if p.grad is not None))
        if name in single:
            ref = single[name]
            row.update(loss_single=ref["loss"],
                       loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       stats_rel=_stats_rel({k: v.cpu() for k, v in
                                             trainer.apply.running_stats().items()},
                                            ref["stats"]) if train.get("USE_BATCH_NORM")
                       else None)
            if ref["grads"]:
                got = {n: p.grad.cpu() for n, p in net.named_parameters() if p.grad is not None}
                row["grad_set_single"] = sorted(got) == sorted(ref["grads"])
                worst, bad = _jax_bar(got, ref["grads"])
                row.update(grad_worst_rel=worst, grad_bad=bad[:8], n_grad_bad=len(bad),
                           grad_median_rel=_grad_median(got, ref["grads"]))
                del got
        if name in timed:
            for m in grid.meshes().values():
                m.counts.clear()
            losses = []
            walls = [_sync_ms(grid.world, lambda: losses.append(trainer.train_step(batch)), 1)
                     for _ in range(HYBRID_TIMED_STEPS)]
            row.update(step_ms=statistics.median(walls), walls_ms=walls, losses=losses,
                       timed_counts=counts())
        row["digest"] = _state_digest(net)
        out[name] = row
        del trainer, net
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hybrid_read_times(smi) -> tuple:
    """The forward and the backward at phase hybrid's read (KERNEL_CASES
    hybrid_N6_S3_f32): kernel, plain and SDPA ms and the bounds."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    c = bank_case(*KERNEL_CASES["hybrid_N6_S3_f32"])
    fwd = fwd_time_row(c, flush, None)
    where = "phase hybrid's read (a 30x15 query shard, N=6, S=3, f32)"
    log_fwd_times(where, fwd, smi)
    N, h, w = c["q_key"].shape[:3]
    g = torch.Generator().manual_seed(122)
    args = bwd_args(c, torch.randn(N, h, w, c["m_val"].shape[-1], generator=g).to("cuda"))
    bwd = bwd_time_row(c, args, flush)
    log_bwd_times(where, bwd, KERNEL_CASES["hybrid_N6_S3_f32"][1] - 1, smi)
    return fwd, bwd


def run_hybrid(smi, models, phase, variants, timed) -> tuple:
    """The single steps of ``variants`` (hybrid_single), then the 2 x 2 grid
    of gloo ranks on cuda:0 (hybrid_worker): each frozen-BN step within
    tests/test_parallel.py's bars of the single step, every rank giving the
    single step's parameters a gradient; T-1 forward and T-1 backward read
    launches per step on a rank that holds columns of RMNet's frame, none on
    the others or for TinyFlowNet; finite losses and bit-identical replicas
    after the timed steps; the trainable-BN step within phase dp's bars (loss,
    statistics) -> (the ranks' rows, the single steps', each timed
    variant's collectives per step, the failures)."""
    from rmnet_tpu_torch.parallel import launch

    path = HYBRID_DIR / f"single_{phase}.pt"
    deterministic = torch.backends.cudnn.deterministic
    _spatial_settings()
    try:
        single = hybrid_single(models, variants, path)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    ranks = launch(hybrid_worker, (variants, path, timed), HYBRID_DEVICES, "gloo",
                   HYBRID_TIMEOUT_S, HYBRID_DEADLINE_S)
    T = _dp_cfg(1, {}).TRAIN.N_MAX_FRAMES
    bad = []
    for name, (train, columns) in variants.items():
        rows = [r[name] for r in ranks]
        row = rows[0]
        network = train.get("NETWORK", "RMNet")
        want = [(T - 1, T - 1) if network == "RMNet" and r["holds"] else (0, 0) for r in rows]
        H = 465
        W = 465 if columns is None else columns[1] - columns[0]
        grads = ("not compared" if "n_grad_bad" not in row else
                 f"largest ||grid - single||/||single|| {row['grad_worst_rel']:.3e} (median "
                 f"{row['grad_median_rel']:.3e}), {row['n_grad_bad']} past {HYBRID_GRAD_REL} "
                 f"(escape {HYBRID_ESCAPE} of the largest) {row['grad_bad'][:3]}")
        log(f"{phase} {name}: {network} on a 2 x 2 grid of gloo ranks on cuda:0 (TF32 off, "
            f"cuDNN deterministic), the reference TRAIN batch (B=4, T={T}) at {H}x{W}; 2 rows "
            f"and the /{row['cell']} grid's columns {[r['columns'] for r in rows]} by rank: "
            f"loss {row['loss']!r} against single-process {row['loss_single']!r} "
            f"({row['loss_rel']:.3e}); gradients {grads}; statistics {row['stats_rel']}; read "
            f"launches per rank {[r['launches'] for r in rows]} (want {want}); parameters with "
            f"a gradient per rank {[len(r['with_grad']) for r in rows]}; peak memory per rank "
            f"{[round(r['peak_gb'], 3) for r in rows]} GB against the single step's "
            f"{single[name]['peak_gb']:.3f}; replicas bit-identical "
            f"{len({r['digest'] for r in rows}) == 1} [{smi}]")
        if len({r["digest"] for r in rows}) != 1:
            bad.append(f"{name}: replicas differ after the steps")
        if [r["launches"] for r in rows] != want:
            bad.append(f"{name}: read launches {[r['launches'] for r in rows]}, want {want}")
        if len({tuple(r["with_grad"]) for r in rows}) != 1:
            bad.append(f"{name}: the ranks give different parameters a gradient")
        if train.get("USE_BATCH_NORM"):
            if row["loss_rel"] > DP_BN_LOSS_REL:
                bad.append(f"{name}: loss {row['loss_rel']:.3e} past {DP_BN_LOSS_REL}")
            if row["stats_rel"] > DP_BN_STATS_REL:
                bad.append(f"{name}: statistics {row['stats_rel']:.3e} past {DP_BN_STATS_REL}")
        else:
            if row["loss_rel"] > HYBRID_LOSS_REL:
                bad.append(f"{name}: loss {row['loss_rel']:.3e} past {HYBRID_LOSS_REL}")
            if not row["grad_set_single"]:
                bad.append(f"{name}: the parameters with a gradient differ from the single "
                           f"step's")
            if row["n_grad_bad"]:
                bad.append(f"{name}: gradients {row['grad_bad']}")
    n = HYBRID_TIMED_STEPS
    per_step = {}
    for name in timed:
        row = ranks[0][name]
        per_step[name] = {k: dict(calls=v[0] / n, mb=v[1] / n / 1e6, ms=v[2] / n * 1e3)
                          for k, v in row["timed_counts"].items()}
        log(f"time {phase} {name}: {row['step_ms']:.3f} ms per step on world rank 0 (median "
            f"of {n} after the counted step; walls {[round(x, 3) for x in row['walls_ms']]}), "
            f"losses {[round(x, 6) for x in row['losses']]}, against the single step's "
            f"{single[name]['step_ms']:.3f} ms [{smi}]")
        for k, v in per_step[name].items():
            log(f"{phase} {name} collective {k}: {v['calls']:.1f} calls, {v['mb']:.3f} MB, "
                f"{v['ms']:.3f} ms per step on world rank 0 (staged through pinned host memory) "
                f"[{smi}]")
        if not all(math.isfinite(x) for r in ranks for x in r[name]["losses"]):
            bad.append(f"{name}: non-finite losses in the timed steps")
    return ranks, single, per_step, bad


def phase_hybrid(smi, models) -> tuple:
    """Hybrid batch x width training of RMNet on the card (run_hybrid over
    HYBRID_VARIANTS: f32, trainable BN, and the columnless 465x16 crop), then
    the read at its query shard timed (hybrid_read_times); f32 and columnless
    timed -> (report, forward
    launches, backward launches of the counted steps)."""
    t_phase = time.perf_counter()
    ranks, single, per_step, bad = run_hybrid(smi, models, "hybrid", HYBRID_VARIANTS,
                                              ("f32", "columnless"))
    fwd, bwd = hybrid_read_times(smi)
    log(f"hybrid: the phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError("phase hybrid: " + "; ".join(bad))
    report = dict(card=smi, tf32="off", single=single, ranks=ranks,
                  collectives_per_step=per_step, read_fwd=fwd, read_bwd=bwd)
    return (report, sum(r[v]["launches"][0] for r in ranks for v in HYBRID_VARIANTS),
            sum(r[v]["launches"][1] for r in ranks for v in HYBRID_VARIANTS))


def phase_hybrid_tfn(smi, models) -> tuple:
    """Hybrid batch x width training of TinyFlowNet on the card (run_hybrid
    over HYBRID_TFN_VARIANTS: the reference TRAIN batch at 465x465, padded
    to 512x512, 4 of the 8 /64 columns a rank) -> (report, forward launches,
    backward launches of the counted step: none, TinyFlowNet reads no
    memory)."""
    t_phase = time.perf_counter()
    ranks, single, per_step, bad = run_hybrid(smi, models, "hybrid_tfn", HYBRID_TFN_VARIANTS,
                                              ("tfn",))
    log(f"hybrid_tfn: the phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError("phase hybrid_tfn: " + "; ".join(bad))
    report = dict(card=smi, tf32="off", single=single, ranks=ranks,
                  collectives_per_step=per_step)
    return (report, sum(r["tfn"]["launches"][0] for r in ranks),
            sum(r["tfn"]["launches"][1] for r in ranks))


# -------------------------------------------------------------------- a/b
def ab_worker(root) -> dict:
    """The main path's engine (480x854, 2 objects, memorize_every 5, T=48,
    bf16, the weights of seed 0) with the package of checkout ``root``,
    measured by this file's code: the first run, the median of 3 runs of
    run_video_labels (as phase times) and one profiled run (as phase
    profile)."""
    smi = phase_device()
    sys.path.insert(0, root)
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine
    from rmnet_tpu_torch.models.weights import build_models

    T = T_FRAMES
    frames, masks, n_objects = make_clip(T, HEIGHT, WIDTH, N_OBJECTS)
    rmnet, tfn = build_models(seed=0)
    eng = InferenceEngine(Config(), rmnet.state_dict(), tfn.state_dict(),
                          memorize_every=MEMORIZE_EVERY, dtype=torch.bfloat16)

    def run():
        return eng.run_video_labels(frames, masks, n_objects)

    first_s = _walls(run, 1)[0]
    walls = _walls(run, 3)
    frame_ms = statistics.median(walls) / (T - 1) * 1e3
    which = "this" if Path(root) == ROOT else "other"
    prof = profile_device(smi, run, T - 1, "frame", frame_ms, f"profile_ab_{which}.txt")
    return dict(root=root, frame_ms=frame_ms, fps=1e3 / frame_ms, walls_s=walls,
                first_run_s=first_s, device_ms_per_frame=prof["busy_ms"],
                busy=prof["busy_ms"] / frame_ms, kernels_per_frame=prof["kernels_per_unit"])


def phase_ab(other, blocks) -> dict:
    """The engine of this checkout and of checkout ``other`` timed in turns,
    ``blocks`` blocks of other, this, this, other; each run is ab_worker in
    a fresh process. Writes build/chip_smoke/engine_ab.json."""
    smi = phase_device()
    other = str(Path(other).resolve())
    if not (Path(other) / "rmnet_tpu_torch" / "engine.py").exists():
        raise SystemExit(f"chip_smoke: {other} is not a checkout of the repository")
    runs = []
    for _ in range(blocks):
        for root in (other, str(ROOT), str(ROOT), other):
            proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--ab-worker",
                                   root], cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                raise AssertionError(f"the engine run in {root} failed:\n{proc.stderr}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            log(json.dumps(runs[-1]))
    summary = {}
    for name, root in (("other", other), ("this", str(ROOT))):
        mine = [r for r in runs if r["root"] == root]
        summary[name] = {k: statistics.median(r[k] for r in mine)
                         for k in ("frame_ms", "device_ms_per_frame", "busy", "kernels_per_frame")}
        summary[name]["frame_ms_runs"] = [r["frame_ms"] for r in mine]
        log(f"ab {name} ({root}): median over {len(mine)} runs {summary[name]} [{smi}]")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    report = dict(card=smi, runs=runs, summary=summary)
    (OUT_DIR / "engine_ab.json").write_text(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--ab", metavar="OTHER_CHECKOUT",
                    help="only time the engine of this checkout and of OTHER_CHECKOUT in turns")
    ap.add_argument("--blocks", type=int, default=2,
                    help="with --ab: blocks of other, this, this, other")
    ap.add_argument("--ab-worker", metavar="CHECKOUT", help=argparse.SUPPRESS)
    ap.add_argument("--dp-train-net", metavar="CFG", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dp_train_net:
        phase_device()
        sys.path.insert(0, str(ROOT))
        return dp_train_net_main(args.dp_train_net)
    if args.ab_worker:
        log(json.dumps(ab_worker(args.ab_worker)))
        return 0
    if args.ab:
        phase_ab(args.ab, args.blocks)
        return 0

    smi = phase_device()
    sys.path.insert(0, str(ROOT))
    from rmnet_tpu_torch.models.weights import build_models

    report = {"card": smi, "build": phase_build()}
    phase_kernel()
    phase_kernel_bwd()
    rmnet, tfn = build_models(seed=0)
    models = (rmnet.state_dict(), tfn.state_dict())
    run = phase_engine(models)
    report["step_f32"] = dict(mem_err=run["step_mem_err"], mem_peak=run["step_mem_peak"],
                              est_err=run["step_err"])
    fwd_row, report["engine"] = phase_times(smi, run)
    report["profile"] = profile_engine(smi, run, report["engine"]["frame_ms"])
    report["graphs"] = phase_graphs(models)
    report["raw"] = phase_raw(models)
    report["tta"] = phase_tta(smi, run)
    del run
    gc.collect()  # the engines' graphs and states (an engine's programs refer back to it)
    train = phase_train(models)
    bwd_row, report["train"] = phase_train_times(smi, train)
    by_path = {"engine": fwd_row["launches"], "train": train["launches"]["fwd"]}
    bwd_by_path = {"engine": 0, "train": bwd_row["launches"]}
    del train
    gc.collect()
    report["train_net"], by_path["train_net"], bwd_by_path["train_net"] = phase_train_net(
        smi, models)
    gc.collect()
    report["eval_server"], by_path["eval_server"] = phase_eval_server(smi)
    bwd_by_path["eval_server"] = 0
    gc.collect()
    report["train_bf16"], by_path["train_bf16"], bwd_by_path["train_bf16"] = phase_train_bf16(
        smi, models)
    gc.collect()
    report["dp"], by_path["dp"], bwd_by_path["dp"] = phase_dp(smi, models)
    shutil.rmtree(TN_DIR / "out" / "checkpoints")  # about 0.5 GB each, weights and Adam state
    gc.collect()
    report["spatial"], by_path["spatial"] = phase_spatial(smi)
    bwd_by_path["spatial"] = 0
    gc.collect()
    report["hybrid"], by_path["hybrid"], bwd_by_path["hybrid"] = phase_hybrid(smi, models)
    gc.collect()
    report["hybrid_tfn"], by_path["hybrid_tfn"], bwd_by_path["hybrid_tfn"] = phase_hybrid_tfn(
        smi, models)
    gc.collect()
    report["eval"] = phase_eval(smi, models)
    by_path["eval"] = report["eval"]["launches"]["eager"] + report["eval"]["launches"]["replayed"]
    gc.collect()  # the eval engine's graphs and states
    report["streams"] = phase_streams(smi, models)
    fwd_row.update(launches=sum(by_path.values()), launches_by_path=by_path)
    bwd_by_path["eval"] = 0
    bwd_row.update(launches=sum(bwd_by_path.values()), launches_by_path=bwd_by_path)
    rows = [fwd_row, bwd_row]
    report["kernels"] = rows
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
