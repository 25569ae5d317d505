"""Drive the PyTorch port on one NVIDIA GPU: build its kernel, check it, run it.

    python3 chip_smoke.py              # one card

Phases, in order (each raises on failure; nothing is caught):
  device  require CUDA, print the card's name and power limit;
  build   build rmnet_tpu_torch/csrc/flash_read_fwd.cu with nvcc for sm_90a;
  kernel  hold the flash-read kernel against its plain PyTorch version at the
          main-path shapes (f32 at 2e-4; bf16 within 1e-2 of the plain
          output's largest magnitude; lse at 2e-4);
  engine  480x854, 2 objects, memorize_every=5, T=48, bf16, flash read, auto
          capacity, random weights: labels, launch count (T-1), and one f32
          step through the kernel read against the dense read (the read's
          output at 2e-4, the probabilities at 1e-3);
  times   engine per-frame ms / FPS; the kernel, its plain version and
          scaled_dot_product_attention over the dense bank, all on the
          inputs of the engine's last flash read; the kernel's bound;
  profile device time per frame by kernel kind (torch.profiler), the
          device's busy share; the kernel table in build/chip_smoke/profile.txt.

Prints the card's name and power limit, the kernel table as one JSON line
before the last, and as the last line {"ok": true, "device": {...}}. The
numbers also go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
H100_F32_FLOPS = 67e12     # float32 outside the tensor cores
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


def phase_build() -> float:
    from rmnet_tpu_torch.ops.flash_attention import LIBRARY

    lib = LIBRARY.load(force_build=True)
    log(f"build: {LIBRARY.path.name} in {LIBRARY.build_seconds:.2f} s, dynamic shared "
        f"memory {lib.flash_read_fwd_smem_bytes()} bytes per block")
    for line in LIBRARY.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error", "warning")):
            log(f"  ptxas: {line.strip()}")
    return LIBRARY.build_seconds


# ----------------------------------------------------------------- kernel
# Kernel against plain version: f32 out and lse at 2e-4 (the read's tolerance
# in tests/test_flash_attention.py). In bf16 both compute in f32 from the same
# bf16 inputs and round once, so only output rounding (at most an ulp,
# max|plain|/128) separates them: max|out - plain| <= 1e-2 * max|plain|.
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
}


def plain_read(c):
    from rmnet_tpu_torch.ops.flash_attention import (
        flash_memory_read_reference, tile_metadata)

    h, w = c["q_key"].shape[1:3]
    _, z, order, counts = tile_metadata(c["slot_valid"], c["bboxes"], h, w)
    return flash_memory_read_reference(c["m_key"], c["m_val"], c["q_key"],
                                       c["slot_valid"], order, counts, z)


def compare_read(name, c) -> float:
    """Kernel against its plain version on ``c`` (on the card); raises past
    the tolerance or unless the wrapper counted exactly one launch.
    Returns max |out - plain|."""
    from rmnet_tpu_torch.ops.flash_attention import flash_memory_read

    before = flash_memory_read.launches
    out, lse = flash_memory_read(**c)
    torch.cuda.synchronize()
    if flash_memory_read.launches != before + 1:
        raise AssertionError(f"{name}: the wrapper counted "
                             f"{flash_memory_read.launches - before} launches, want 1")
    ref_out, ref_lse = plain_read(c)
    o, r = out.float(), ref_out.float()
    err, peak = (o - r).abs().max().item(), r.abs().max().item()
    fin = torch.isfinite(ref_lse)
    if not (torch.equal(torch.isfinite(lse), fin) and bool((lse[~fin] == math.inf).all())):
        raise AssertionError(f"{name}: lse +inf rows differ from the plain version")
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    if out.dtype == torch.bfloat16:
        tol = f"max|out-plain| <= {BF16_REL_TOL} * max|plain|"
        ok = err <= BF16_REL_TOL * peak
    else:
        tol = f"allclose {F32_TOL}"
        ok = torch.allclose(o, r, rtol=F32_TOL, atol=F32_TOL)
    ok = ok and lse_err <= F32_TOL
    log(f"kernel {name}: max|out-plain|={err:.3e} max|plain|={peak:.3e} "
        f"max|lse-plain|={lse_err:.3e} ({tol}, lse {F32_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain version")
    return err


def phase_kernel() -> None:
    for name, args in KERNEL_CASES.items():
        compare_read(name, bank_case(*args))


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
    and result of its last call; the call itself is unchanged."""

    def __init__(self, name):
        import rmnet_tpu_torch.models.rmnet as rmnet_mod

        self.mod, self.name = rmnet_mod, name
        self.real = getattr(rmnet_mod, name)
        self.args = self.result = None

    def __enter__(self):
        def record(*args, **kwargs):
            self.args = (args, kwargs)
            self.result = self.real(*args, **kwargs)
            return self.result

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
def _time_ms(fn, iters, flush):
    """Median device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (the engine's convs evict the bank between two reads)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def read_bound(c) -> tuple:
    """Least time for the read on these inputs: the in-box valid memory
    positions' K/V read once, q read once, out and lse written once; the
    operations 2*Q*(Ck+Cv) per such position, at the inputs' peak rate."""
    mk, mv, q = c["m_key"], c["m_val"], c["q_key"]
    N, S, h, w, Ck = mk.shape
    Cv = mv.shape[-1]
    ys = torch.arange(h, device=q.device) * 16
    xs = torch.arange(w, device=q.device) * 16
    b = c["bboxes"][:, :, :, None, None]
    cell = ((ys[:, None] >= b[:, :, 2]) & (ys[:, None] <= b[:, :, 3])
            & (xs[None] >= b[:, :, 0]) & (xs[None] <= b[:, :, 1]))
    inbox = int((cell & c["slot_valid"][:, :, None, None]).sum())
    es = q.element_size()
    flops = 2.0 * h * w * inbox * (Ck + Cv)
    nbytes = (inbox * (Ck + Cv) + N * h * w * (Ck + Cv)) * es + N * h * w * 4
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    op_ms, byte_ms = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), inbox, flops


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


def phase_times(smi, run) -> tuple:
    from rmnet_tpu_torch.ops.flash_attention import (
        flash_memory_read, flash_memory_read_reference, flash_read_fwd, tile_metadata)

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
    meta = tile_metadata(c["slot_valid"], c["bboxes"], h, w)
    _, z, order, counts = meta
    kargs = (c["m_key"], c["m_val"], c["q_key"], c["slot_valid"], order, counts, z)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = _time_ms(lambda: flash_read_fwd(*kargs), 20, flush)
    wrapper_ms = _time_ms(lambda: flash_memory_read(**c), 20, flush)
    meta_ms = _time_ms(lambda: tile_metadata(c["slot_valid"], c["bboxes"], h, w), 20, flush)
    plain_ms = _time_ms(lambda: flash_memory_read_reference(*kargs), 5, flush)
    library_ms = _time_ms(sdpa_read(c), 20, flush)
    bound_ms, bound_by, inbox, flops = read_bound(c)
    N, S = c["m_key"].shape[:2]
    active = int(counts.sum())
    log(f"time flash_read_fwd: kernel {ms:.4f} ms, wrapper with tile metadata "
        f"{wrapper_ms:.4f} ms (metadata alone {meta_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"sdpa over the dense bank {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops / 1e9:.2f} GFLOP over {inbox} in-box valid positions of "
        f"{N * S * h * w}; {active} active tiles of {order.numel()}), "
        f"{flops / ms / 1e9:.2f} TFLOP/s, launches per frame "
        f"{run['launches'] / (T - 1):.0f}; N={N} S={S} h={h} w={w} "
        f"{c['q_key'].dtype} [{smi}]")
    return dict(
        name="flash_read_fwd", route="cuda",
        source="rmnet_tpu_torch/csrc/flash_read_fwd.cu",
        replaces="rmnet_tpu/ops/flash_attention.py:226",
        launches=run["launches"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
    ), dict(frame_ms=frame_ms, fps=1e3 / frame_ms, walls_s=walls,
            wrapper_ms=wrapper_ms, metadata_ms=meta_ms)


# kernel-name patterns of the profile's buckets, first match wins
_BUCKETS = (
    ("flash read kernel", ("flash_read_fwd",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("xmma", "implicit_gemm", "conv", "cudnn", "cutlass", "gemm", "wgrad")),
    ("batch norm", ("batch_norm",)),
    ("host copies", ("Memcpy", "Memset")),
)


def profile_engine(smi, run, frame_ms) -> dict:
    """Device time by kernel over one run_video_labels (torch.profiler).
    Writes the kernel table to build/chip_smoke/profile.txt and prints the time
    by bucket; the busy share is kernel time per frame over ``frame_ms``,
    the unprofiled wall time per frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = run["engine"]
    frames, masks, n_objects = run["clip"]
    n = len(frames) - 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run_video_labels(frames, masks, n_objects)
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
    (OUT_DIR / "profile.txt").write_text(smi + "\n" + "\n".join(
        f"{e.self_device_time_total / 1e3:10.3f} ms x{e.count:<6d} {e.key}" for e in kernels))
    log(f"profile: device kernels {busy:.3f} ms per frame, {busy / frame_ms:.1%} of "
        f"the {frame_ms:.3f} ms wall per frame, {sum(e.count for e in kernels) / n:.0f} "
        f"kernels per frame [{smi}]")
    for name, v in sorted(buckets.items(), key=lambda kv: -kv[1]):
        log(f"  {v:8.3f} ms/frame  {v / busy:6.1%}  {name}")
    return dict(buckets_ms_per_frame=buckets, busy_ms_per_frame=busy)


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, str(ROOT))
    from rmnet_tpu_torch.models.weights import build_models

    report = {"card": smi, "build_s": phase_build()}
    phase_kernel()
    rmnet, tfn = build_models(seed=0)
    run = phase_engine((rmnet.state_dict(), tfn.state_dict()))
    del rmnet, tfn
    report["step_f32"] = dict(mem_err=run["step_mem_err"], mem_peak=run["step_mem_peak"],
                              est_err=run["step_err"])
    row, report["engine"] = phase_times(smi, run)
    report["kernels"] = [row]
    report["profile"] = profile_engine(smi, run, report["engine"]["frame_ms"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": [row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
