"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, check them,
run inference and training through them.

    python3 chip_smoke.py              # one card

Phases, in order (each raises on failure; nothing is caught):
  device  require CUDA, print the card's name and power limit;
  build   build rmnet_tpu_torch/csrc/flash_read_{fwd,bwd}.cu with nvcc for
          sm_90a (one nvcc each, started together); registers, spills and
          shared memory of each; the tensor-core (HMMA) instructions of each
          kernel in the built SASS (cuobjdump; fails on 0 in a forward main
          kernel or a backward kernel);
  kernel  hold the flash-read forward (main and merge kernels) against its
          plain PyTorch version and against the plain split and merge at the
          wrapper's split count, at the main-path shapes and the training
          read (f32 at 2e-4; bf16 within 1e-2 of the plain output's largest
          magnitude; lse at 2e-4); two calls at S33_bf16 and at the f32
          training read give bit-identical out and lse;
  kernel_bwd  hold the backward kernel against its plain version on the same
          cases plus the training read (dQ, dK, dV each within 1e-4 of the
          plain gradient's largest magnitude in f32, 1e-2 in bf16); two calls
          on the f32 training read give bit-identical gradients;
  engine  480x854, 2 objects, memorize_every=5, T=48, bf16, flash read, auto
          capacity, random weights: labels, launch count (T-1), and one f32
          step through the kernel read against the dense read (the read's
          output at 2e-4, the probabilities at 1e-3);
  times   engine per-frame ms / FPS; the kernel, its plain version and
          scaled_dot_product_attention over the dense bank, all on the
          inputs of the engine's last flash read; the kernel's bound; its
          ms by CUDA kernel (main, merge); the work its kernels execute by
          the design's count beside the useful work (fails past 1.3x);
  profile device time per frame by kernel kind (torch.profiler), the
          device's busy share; the kernel table in build/chip_smoke/profile.txt;
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
          (build/chip_smoke/profile_train.txt).

Prints the card's name and power limit, the kernel table as one JSON line
before the last, and as the last line {"ok": true, "device": {...}}. The
numbers also go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
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
}


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

# the forward's cases (the f32 training read among them) plus the training
# read in bf16
BWD_CASES = {
    **KERNEL_CASES,
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
def make_clip(T, H, W, n_obj):
    """bench.py's synthetic clip: uniform noise frames, boxes drifting down."""
    K = n_obj + 1
    rs = np.random.RandomState(0)
    frames = rs.rand(T, H, W, 3).astype(np.float32) * 2 - 1
    labels = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        y = 100 + 2 * t
        labels[t, y:y + 120, 150:300] = 1
        if K > 2:
            labels[t, y + 40:y + 180, 450:620] = 2
    masks = np.zeros((T, K, H, W), np.float32)
    masks[0] = np.stack([labels[0] == k for k in range(K)])
    return frames, masks, np.full((T,), n_obj, np.int32)


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
    """Run an f32 engine's step loop to frame STEP_T, then that step twice
    from one state: kernel read and dense read. Returns max |mem diff| of the
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
    with torch.inference_mode():
        f = torch.from_numpy(frames[:STEP_T + 1]).to(dev).permute(0, 3, 1, 2)
        state = eng.apply.init_state(f[:1], torch.from_numpy(masks[0]).to(dev)[None],
                                     STEP_CAPACITY)
        for t in range(1, STEP_T + 1):
            frame = f[t:t + 1]
            flow = eng.tflownet.pair_forward(frame, state.prev_frame)
            if t < STEP_T:
                state, _ = eng.apply.step(state, frame, flow, None, False,
                                          bool(commit[t - 1]), obj_valid)
        ests, mems = {}, {}
        for flash, read in ((True, "flash_memory_read"), (False, "_dense_read")):
            apply = dataclasses.replace(eng.apply, use_flash_attention=flash)
            s = dataclasses.replace(state, keys=state.keys.clone(),
                                    values=state.values.clone(),
                                    bboxes=state.bboxes.clone())
            with _Record(read) as rec:
                _, ests[flash] = apply.step(s, frame, flow, None, False,
                                            bool(commit[STEP_T - 1]), obj_valid)
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


def phase_engine(models) -> dict:
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.engine import InferenceEngine
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read

    rm_sd, tfn_sd = models
    T, H, W, n_obj = T_FRAMES, HEIGHT, WIDTH, N_OBJECTS
    frames, masks, n_objects = make_clip(T, H, W, n_obj)
    eng = InferenceEngine(Config(), rm_sd, tfn_sd, memorize_every=MEMORIZE_EVERY,
                          dtype=torch.bfloat16)
    if not (eng.use_flash_attention and eng.capacity == 0):
        raise AssertionError("the engine's defaults are no longer flash read and auto capacity")

    with _Record("flash_memory_read") as rec:
        flash_memory_read.launches = 0
        t0 = time.perf_counter()
        labels = eng.run_video_labels(frames, masks, n_objects)
        first_s = time.perf_counter() - t0
        launches = flash_memory_read.launches
    if labels.shape != (T, H, W) or labels.dtype != np.uint8:
        raise AssertionError(f"labels {labels.shape} {labels.dtype}, want ({T}, {H}, {W}) uint8")
    if int(labels.max()) >= n_obj + 1:
        raise AssertionError(f"label {int(labels.max())} outside [0, {n_obj + 1})")
    if not np.array_equal(labels[0], masks[0].argmax(0)):
        raise AssertionError("frame 0 labels are not the annotation")
    if launches != T - 1:
        raise AssertionError(f"flash kernel launched {launches} times, want {T - 1}")
    fg = [float((labels[t] > 0).mean()) for t in (1, T // 2, T - 1)]
    log(f"engine: {T}x{H}x{W} bf16 flash, capacity {eng._capacity_for(T, eng._video_flags(n_objects, T)[1])}, "
        f"first run {first_s:.2f} s, kernel launches {launches} (T-1 = {T - 1}), "
        f"labels {labels.shape} {labels.dtype} max {int(labels.max())}, "
        f"foreground share at t=1, T/2, T-1: {fg}")

    mem_err, mem_peak, est_err = step_agreement(rm_sd, tfn_sd, frames, masks, n_objects)
    return dict(engine=eng, clip=(frames, masks, n_objects), launches=launches,
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
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_video_labels(frames, masks, n_objects)
        walls.append(time.perf_counter() - t0)
    frame_ms = statistics.median(walls) / (T - 1) * 1e3
    log(f"time engine: {frame_ms:.3f} ms/frame, {1e3 / frame_ms:.2f} FPS "
        f"(median of 3 runs of run_video_labels, wall / {T - 1} frames, "
        f"upload and download included) [{smi}]")

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
        f"alone {meta_ms:.4f} ms), launches per frame {run['launches'] / (T - 1):.0f} [{smi}]")
    return dict(
        name="flash_read_fwd", route="cuda",
        source="rmnet_tpu_torch/csrc/flash_read_fwd.cu",
        replaces="rmnet_tpu/ops/flash_attention.py:226",
        launches=run["launches"], max_abs_err=err, ms=fwd["ms"], plain_ms=fwd["plain_ms"],
        bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
    ), dict(frame_ms=frame_ms, fps=1e3 / frame_ms, walls_s=walls,
            wrapper_ms=wrapper_ms, metadata_ms=meta_ms, fwd_last_read=fwd)


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
    return dict(buckets_ms=buckets, busy_ms=busy, unit=unit)


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


def main() -> int:
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
    del run
    train = phase_train(models)
    bwd_row, report["train"] = phase_train_times(smi, train)
    by_path = {"engine": fwd_row["launches"], "train": train["launches"]["fwd"]}
    del train
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
