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
          shared memory of each; the tensor-core (HMMA) instructions of each
          kernel in the built SASS (cuobjdump; fails on 0 in a forward main
          kernel or a backward kernel);
  kernel  hold the flash-read forward (main and merge kernels) against its
          plain PyTorch version and against the plain split and merge at the
          wrapper's split count, at the main-path shapes, the streams
          phase's largest read (16 rows, S=33), the graphs phase's (S=3)
          and the training read (f32 at 2e-4; bf16 within 1e-2 of the plain output's largest
          magnitude; lse at 2e-4); two calls at S33_bf16 and at the f32
          training read give bit-identical out and lse;
  kernel_bwd  hold the backward kernel against its plain version on the same
          cases plus the training read (dQ, dK, dV each within 1e-4 of the
          plain gradient's largest magnitude in f32, 1e-2 in bf16); two calls
          on the f32 training read give bit-identical gradients;
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
import statistics
import subprocess
import sys
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
            log(f"build: {name} {kernel}: {count} HMMA instructions in the SASS")
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
    """HMMA (tensor-core) instructions per kernel in the SASS of ``lib``'s
    build, read with cuobjdump."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _kernel_name(line.split("Function :")[1].strip())
            counts[kernel] = 0
        elif kernel is not None and "HMMA" in line:
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


def bank_case(N, S, h, w, dtype, seed, invalid=(), all_invalid_row=None, loose=64):
    """Bank-like read inputs on the card at /16 grid (h, w): boxes made as
    memorize makes them (dilated box of a thresholded mask, rasterized on
    the /16 grid), k/v zero outside the boxes, some slots invalid."""
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
    return dict(
        m_key=(mk * cell).to("cuda", dtype), m_val=(mv * cell).to("cuda", dtype),
        q_key=qk.to("cuda", dtype), slot_valid=valid.to("cuda"),
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
    # the streams phase's largest read: N = 8 lockstep streams of 2 objects
    # (16 rows), S = 33, where fwd_splits takes 6 splits on an H100
    "streams_N16_S33_bf16": (16, 33, 30, 54, torch.bfloat16, 12, range(11, 32)),
    "streams_N16_S33_f32": (16, 33, 30, 54, torch.float32, 13, range(11, 32)),
    # the graphs phase's read: capacity 2 plus the ephemeral slot, the slot
    # being written this frame invalid
    "graphs_S3_bf16": (2, 3, 30, 54, torch.bfloat16, 14, (1,)),
    "graphs_S3_f32": (2, 3, 30, 54, torch.float32, 15, (1,)),
}
# inference-only reads that the backward never takes (its plain version
# would hold tens of GB at 16 rows of S = 33)
FWD_ONLY_CASES = ("streams_N16_S33_bf16", "streams_N16_S33_f32")


def read_args(c) -> tuple:
    """The forward kernel's arguments for read inputs ``c``: the inputs and
    their tile metadata."""
    from rmnet_tpu_torch.ops.flash_attention import tile_metadata

    h, w = c["q_key"].shape[1:3]
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
    splits = fwd_splits_for(mk, q.device)
    m, l, acc = flash_read_fwd_partials_reference(mk, mv, q, valid, order, counts, splits)
    out, lse = flash_read_fwd_merge_reference(m, l, acc, z, q.dtype)
    return out.reshape(q.shape[:3] + (-1,)), lse, splits


def _read_agreement(out, lse, ref_out, ref_lse) -> tuple:
    """(ok, max |out - ref|, max |ref|, max |lse - ref lse|, tolerance text) at
    the read's tolerances; +inf lse rows must match."""
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
    tolerance or unless the wrapper counted exactly one launch. Returns
    max |out - plain|."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read

    before = flash_memory_read.launches
    out, lse = flash_memory_read(**c)
    torch.cuda.synchronize()
    if flash_memory_read.launches != before + 1:
        raise AssertionError(f"{name}: the wrapper counted "
                             f"{flash_memory_read.launches - before} launches, want 1")
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


# the forward's determinism cases: the engine's type and the training read's
FWD_DETERMINISM_CASES = ("S33_bf16", "train_S3_f32")


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

# the forward's cases (the f32 training read among them) but the
# inference-only ones, plus the training read in bf16
BWD_CASES = {
    **{k: v for k, v in KERNEL_CASES.items() if k not in FWD_ONLY_CASES},
    "train_S3_bf16": (12, 3, 30, 30, torch.bfloat16, 9, (1,)),
}


def bwd_args(c, d_out, out=None, lse=None) -> tuple:
    """The backward kernel's arguments for read inputs ``c`` and cotangent
    ``d_out``, as FlashMemoryRead.backward makes them: the tile metadata,
    the forward's lse (the plain forward's unless given) and D =
    rowsum(dO * O)."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read_reference, tile_metadata

    mk, mv, q, valid = c["m_key"], c["m_val"], c["q_key"], c["slot_valid"]
    h, w = q.shape[1:3]
    _, z, order, counts = tile_metadata(valid, c["bboxes"], h, w)
    if out is None:
        out, lse = flash_memory_read_reference(mk, mv, q, valid, order, counts, z)
    d_out = d_out.to(q.dtype).contiguous()
    delta = (d_out.float() * out.float()).sum(dim=-1).reshape(q.shape[0], -1)
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
    launch. Returns the largest max |g - plain| of dQ, dK, dV."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd, flash_read_bwd_reference

    before = flash_read_bwd.launches
    got = flash_read_bwd(*args)
    torch.cuda.synchronize()
    if flash_read_bwd.launches != before + 1:
        raise AssertionError(f"{name}: the wrapper counted "
                             f"{flash_read_bwd.launches - before} launches, want 1")
    ref = flash_read_bwd_reference(*args)
    bf16 = args[2].dtype == torch.bfloat16
    rel = BWD_BF16_REL_TOL if bf16 else BWD_F32_REL_TOL
    ok, errs, parts = True, [], []
    for gname, g, r in zip(("dQ", "dK", "dV"), got, ref):
        err, peak = (g.float() - r).abs().max().item(), r.abs().max().item()
        good = bool(torch.isfinite(g).all()) and g.dtype == args[2].dtype and err <= rel * peak
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


def phase_kernel_bwd() -> None:
    for name in BWD_CASES:
        compare_bwd(name, bwd_case(name))
    check_bwd_deterministic("train_S3_f32")


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
    equal the chunk steps of ``passes`` runs of a T-frame video, padded
    steps included, and every eager launch was a graph's warm-up."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read as fmr

    fmr.launches = fmr.captured = fmr.replayed = 0
    replays = eng.replays
    result = fn()
    steps = passes * sum(eng._chunk_plan(T - 1))
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
    h, w = c["q_key"].shape[1:3]
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
    operations 2*Q*(Ck+Cv) per such position, at the inputs' peak rate."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    Cv = mv.shape[-1]
    inbox = _inbox_positions(c)
    es = q.element_size()
    flops = 2.0 * h * w * inbox * (Ck + Cv)
    nbytes = (inbox * (Ck + Cv) + N * h * w * (Ck + Cv)) * es + N * h * w * 4
    return (*_bound(flops, nbytes, q.dtype), inbox, flops)


def read_bwd_bound(c) -> tuple:
    """Least time for the read's backward on these inputs: per in-box valid
    position 2*Q*(3*Ck + 2*Cv) operations (S = q.K, dP = dO.V, dV, dK, dQ);
    the bytes of K, V, dK, dV at those positions, q, dO and dQ, lse and D,
    each read or written once."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    Cv = mv.shape[-1]
    inbox = _inbox_positions(c)
    es = q.element_size()
    flops = 2.0 * h * w * inbox * (3 * Ck + 2 * Cv)
    nbytes = (2 * inbox * (Ck + Cv) + N * h * w * (2 * Ck + Cv)) * es + 2 * N * h * w * 4
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
    query block, listed active tile) 2*64*64*(2*Ck + Cv) in bf16 (each pair
    of warps computes the same S for its half of the value columns) and
    2*64*64*(Ck + Cv) in f32 (S once, through shared memory)."""
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


def fwd_time_row(c, flush) -> dict:
    """The forward on read inputs ``c``: kernel, plain and SDPA ms, the bound,
    the ms by CUDA kernel, the useful and the executed work, the split count
    and the scratch; raises if the executed work passes 1.3x the useful work
    in bf16."""
    from rmnet_tpu_torch.ops.flash_attention import (
        _QUERY_BLOCK, flash_memory_read_reference, flash_read_fwd, fwd_splits_for)

    kargs = read_args(c)
    mk, q, order, counts = kargs[0], kargs[2], kargs[4], kargs[5]
    N, S, h, w, _ = mk.shape
    bound_ms, bound_by, inbox, flops = read_bound(c)
    executed = read_fwd_executed_flops(kargs)
    splits = fwd_splits_for(mk, q.device)
    qp = -(-h * w // _QUERY_BLOCK) * _QUERY_BLOCK
    row = dict(
        ms=_time_ms(lambda: flash_read_fwd(*kargs), 20, flush),
        plain_ms=_time_ms(lambda: flash_memory_read_reference(*kargs), 5, flush),
        library_ms=_time_ms(sdpa_read(c), 20, flush),
        bound_ms=bound_ms, bound_by=bound_by, useful_gflop=flops / 1e9,
        executed_gflop_by_design=executed / 1e9, inbox_positions=inbox,
        positions=N * S * h * w, active_tiles=int(counts.sum()), tiles=order.numel(),
        splits=splits, scratch_mb=N * splits * qp * (c["m_val"].shape[-1] + 2) * 4 / 1e6,
        by_kernel=kernel_ms(flash_read_fwd, kargs, "flash_read_fwd"),
        shape=dict(N=N, S=S, h=h, w=w, dtype=str(q.dtype)))
    ratio = executed / flops
    if q.dtype == torch.bfloat16 and ratio > EXECUTED_LIMIT:
        raise AssertionError(f"the forward executes {ratio:.3f}x the useful work, "
                             f"limit {EXECUTED_LIMIT}")
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
        q.reshape(N, 1, h * w, Ck), mk.reshape(N, 1, M, Ck),
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
    ("convolutions", ("xmma", "implicit_gemm", "conv", "cudnn", "cutlass", "gemm", "wgrad",
                      "dgrad")),
    ("batch norm", ("batch_norm",)),
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
        self.mod.fwd_splits_for = lambda m_key, device: self.splits
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

    def worst_and_bad(a, b):
        worst, bad = 0.0, []
        for name in params:
            err, ref = (a[name] - b[name]).norm().item(), b[name].norm().item()
            worst = max(worst, err / ref if ref > 0 else (0.0 if err == 0 else math.inf))
            if err > GRAD_REL_TOL * ref and (a[name] - b[name]).abs().max().item() > 1e-7 * gmax:
                bad.append((name, err / (ref + 1e-30)))
        return worst, bad

    worst, bad = worst_and_bad(flash, dense_g)
    floor, _ = worst_and_bad(again, flash)
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
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd, flash_read_bwd_reference

    B = train["batch"]["frames"].shape[0]
    step_ms = statistics.median(train["walls_s"][1:]) * 1e3
    log(f"time train: {step_ms:.3f} ms per step, {B / step_ms * 1e3:.3f} clips/s (median "
        f"of {TRAIN_STEPS} steps after 1 warm-up, loss.item() included), peak memory "
        f"{train['peak_gb']:.2f} GB [{smi}]")
    c, args = train["last_read"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd = fwd_time_row(c, flush)
    log_fwd_times(f"the first step's t={train['batch']['frames'].shape[1] - 1} read", fwd, smi)
    ms = _time_ms(lambda: flash_read_bwd(*args), 20, flush)
    plain_ms = _time_ms(lambda: flash_read_bwd_reference(*args), 5, flush)
    library_ms = _time_ms(sdpa_read_bwd(c, args[6]), 20, flush)
    bound_ms, bound_by, inbox, flops = read_bwd_bound(c)
    executed = read_bwd_executed_flops(args)
    N, S, h, w = c["m_key"].shape[:4]
    order, counts = args[4], args[5]
    log(f"time flash_read_bwd: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
        f"over the dense bank {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP over {inbox} in-box valid positions of {N * S * h * w}; "
        f"{int(counts.sum())} active tiles of {order.numel()}), "
        f"{flops / ms / 1e9:.2f} TFLOP/s useful, executed by the design's count "
        f"{executed / 1e9:.2f} GFLOP, launches per step "
        f"{train['launches']['bwd'] / (1 + TRAIN_STEPS):.0f}; N={N} S={S} h={h} w={w} "
        f"{c['q_key'].dtype} [{smi}]")
    by_kernel = kernel_ms(flash_read_bwd, args, "flash_read_bwd")
    log("time flash_read_bwd by kernel (profiler, L2 warm): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in by_kernel.items()) + f" [{smi}]")
    trainer, batch = train["trainer"], train["batch"]
    prof = profile_device(smi, lambda: trainer.train_step(batch), 1, "step", step_ms,
                          "profile_train.txt")
    row = dict(
        name="flash_read_bwd", route="cuda",
        source="rmnet_tpu_torch/csrc/flash_read_bwd.cu",
        replaces="rmnet_tpu/ops/flash_attention.py:335",
        launches=train["launches"]["bwd"], max_abs_err=train["max_abs_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
    )
    return row, dict(step_ms=step_ms, clips_per_s=B / step_ms * 1e3,
                     walls_s=train["walls_s"], losses=train["losses"],
                     peak_gb=train["peak_gb"], grads=train["grads"], profile=prof,
                     bwd_kernel_ms=by_kernel, bwd_executed_gflop_by_design=executed / 1e9,
                     fwd_last_read=fwd)


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
    args = ap.parse_args(argv)
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
    del train
    report["streams"] = phase_streams(smi, models)
    fwd_row.update(launches=sum(by_path.values()), launches_by_path=by_path)
    bwd_row.update(launches_by_path={"engine": 0, "train": bwd_row["launches"]})
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
