"""Probe the flash read's backward kernels on one NVIDIA GPU through variants
of their source, each built from a patched copy in a temporary directory
(the checkout is never changed):

  as_is     the source unchanged, plus a host function that asks CUDA's
            occupancy calculator for each kernel's resident blocks per SM;
  count     every mma.sync instruction counted per kernel (an atomic add by
            the warp's first lane), so the products the kernels execute are
            read off the card and held to the design's count
            (chip_smoke.read_bwd_executed_flops: s and dP once per query
            block and active tile);
  tf32_rna  single-pass TF32, the lo pass dropped (hi rounded to nearest);
  tf32_raw  single-pass TF32 from the raw float32 bits, which the tensor
            cores truncate (an operand wrongly taken as exact in TF32).

Each variant runs on chip_smoke.py's float32 backward cases and on the reads
of its first training step (same seeds); the report gives max |g - plain| /
max |plain| over dQ, dK, dV per case beside chip_smoke's float32 tolerance,
which must reject both single-pass controls.

    python3 chip_bwd_probe.py        # one card

Prints the card's name and power limit first and one JSON object last;
writes the same to build/chip_smoke/bwd_probe.json. Exits 1 if a count
differs from the design's or a control passes the tolerance on every case.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as smoke

HEADER, SOURCE = "mma_tf32.cuh", "flash_read_bwd.cu"
KERNELS = ("ds", "dkdv", "dq")
MMA_FLOP = 2 * 16 * 8 * 8  # one m16n8k8 instruction

_SPLIT = "    hi = to_tf32(x);\n    lo = to_tf32(x - __uint_as_float(hi));\n"
_MMA = ("__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], "
        "const uint32_t b[2]) {\n")

_OCCUPANCY = """
namespace {
template <typename T>
int probe_blocks(int kernel) {
  if (set_smem_limits<T>() != cudaSuccess) return -1;
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_read_bwd_ds_kernel<T>,
                                                        NT_DS, SMEM_DS_BYTES);
  if (kernel == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_read_bwd_dkdv_kernel<T>,
                                                        NT_ACC, SMEM_DKDV_BYTES);
  if (kernel == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_read_bwd_dq_kernel<T>,
                                                        NT_ACC, SMEM_DQ_BYTES);
  return err == cudaSuccess ? blocks : -1;
}
}  // namespace
extern "C" int probe_blocks_per_sm(int kernel, int dtype) {
  return dtype == 0 ? probe_blocks<float>(kernel) : probe_blocks<__nv_bfloat16>(kernel);
}
"""

# the kernels are told apart by their launch shapes: ds runs 128 threads, dq
# a grid with z = 1 (dkdv's z is the row count N, so N > 1 in the cases)
_COUNTER = (
    "__device__ unsigned long long probe_mma_count[3];\n" + _MMA
    + "  if ((threadIdx.x & 31) == 0)\n"
      "    atomicAdd(&probe_mma_count[blockDim.x == 128 ? 0 : (gridDim.z == 1 ? 2 : 1)], 1ull);\n")
_COUNT_READ = """
extern "C" int probe_mma_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mma_tf32::probe_mma_count, 3 * sizeof(*out));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[3] = {0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(mma_tf32::probe_mma_count, zero, sizeof(zero)));
}
"""

# variant -> file -> [(text, replacement)]; an empty text appends
VARIANTS = {
    "as_is": {SOURCE: [("", _OCCUPANCY)]},
    "count": {HEADER: [(_MMA, _COUNTER)], SOURCE: [("", _COUNT_READ)]},
    "tf32_rna": {HEADER: [(_SPLIT, "    hi = to_tf32(x);\n    lo = 0u;\n")]},
    "tf32_raw": {HEADER: [(_SPLIT, "    hi = __float_as_uint(x);\n    lo = 0u;\n")]},
}


def write_variant(name: str, dst: Path) -> Path:
    """The backward's source and headers with ``name``'s patches, in
    ``dst``; returns the patched source. Raises unless each patched text
    occurs exactly once."""
    from rmnet_tpu_torch.ops.flash_attention import _CSRC

    dst.mkdir(parents=True, exist_ok=True)
    for path in [_CSRC / SOURCE, *_CSRC.glob("*.cuh")]:
        shutil.copy(path, dst / path.name)
    for file, patches in VARIANTS[name].items():
        text = (dst / file).read_text()
        for old, new in patches:
            if not old:
                text += new
            elif text.count(old) != 1:
                raise AssertionError(f"{name}: {file} holds the patched text "
                                     f"{text.count(old)} times, want 1")
            else:
                text = text.replace(old, new)
        (dst / file).write_text(text)
    return dst / SOURCE


class Built:
    """A variant's library, loaded; stands in for BWD_LIBRARY."""

    def __init__(self, path: Path):
        from rmnet_tpu_torch.ops.flash_attention import BWD_LIBRARY

        self.lib = ctypes.CDLL(str(path))
        self.lib.flash_read_bwd.argtypes = BWD_LIBRARY.argtypes
        self.lib.flash_read_bwd.restype = ctypes.c_int

    def load(self):
        return self.lib


def build(name: str, tmp: Path) -> Built:
    from rmnet_tpu_torch.ops.flash_attention import _NVCC_FLAGS

    source = write_variant(name, tmp / name)
    out = tmp / name / f"lib{name}.so"
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    proc = subprocess.run([str(nvcc), *_NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return Built(out)


@contextlib.contextmanager
def running(built: Built):
    """flash_read_bwd launches ``built``'s kernels inside the block."""
    import rmnet_tpu_torch.ops.flash_attention as fa

    saved, fa.BWD_LIBRARY = fa.BWD_LIBRARY, built
    try:
        yield
    finally:
        fa.BWD_LIBRARY = saved


def first_step_reads() -> dict:
    """The backward's arguments at the reads of chip_smoke.py's first
    training step (same models, batch and seeds), through the real kernels."""
    from rmnet_tpu_torch.config import Config
    from rmnet_tpu_torch.models.weights import build_models
    from rmnet_tpu_torch.train import Trainer, make_loss_fn

    rmnet, tfn = build_models(seed=0)
    cfg = Config()
    trainer = Trainer(cfg, rmnet.state_dict(), tfn.state_dict())
    batch = trainer.to_device(smoke.make_train_batch(cfg))
    with smoke._Record("flash_memory_read", grads=True) as rec:
        loss = make_loss_fn(cfg, trainer.apply, trainer.tflownet)(batch)
        torch.autograd.grad(loss, list(trainer.rmnet.parameters()))
    names = ("m_key", "m_val", "q_key", "slot_valid", "bboxes")
    reads = {}
    for t, call in enumerate(rec.calls, start=1):
        (args, kwargs), (out, lse) = call["args"], call["result"]
        c = dict(zip(names, (a.detach() for a in args)), **kwargs)
        reads[f"first_step_read_t{t}"] = smoke.bwd_args(c, call["d_out"], out.detach(), lse)
    return reads


def design_mma(args) -> tuple:
    """mma instructions per kernel on ``args`` by the design's count, and
    the TF32 passes per product of each kernel."""
    mk, mv, q, counts = args[0], args[1], args[2], args[5]
    Ck, Cv = mk.shape[-1], mv.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    # a widened bf16 operand is exact in TF32; P and dS are split float32
    passes = dict(ds=1 if bf16 else 3, dkdv=2 if bf16 else 3, dq=2 if bf16 else 3)
    pairs = int(counts.sum()) * -(-q.shape[1] * q.shape[2] // 64)
    flops = dict(ds=pairs * 2 * 64 * 64 * (Ck + Cv), dkdv=pairs * 2 * 64 * 64 * (Cv + Ck),
                 dq=pairs * 2 * 64 * 64 * Ck)
    return {k: flops[k] // MMA_FLOP * passes[k] for k in KERNELS}, passes


def measure_mma(built: Built, args) -> dict:
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd

    read = built.lib.probe_mma_counts
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    counts = (ctypes.c_ulonglong * 3)()
    torch.cuda.synchronize()
    if read(counts) != 0:
        raise RuntimeError("probe_mma_counts failed")
    with running(built):
        flash_read_bwd(*args)
    torch.cuda.synchronize()
    if read(counts) != 0:
        raise RuntimeError("probe_mma_counts failed")
    return dict(zip(KERNELS, (int(c) for c in counts)))


def rel_error(built: Built, args, ref) -> float:
    """max over dQ, dK, dV of max |g - plain| / max |plain|."""
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd

    with running(built):
        got = flash_read_bwd(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for g, r in zip(got, ref):
        err, peak = (g.float() - r).abs().max().item(), r.abs().max().item()
        worst = max(worst, err / peak if peak > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def main() -> int:
    smi = smoke.phase_device()
    sys.path.insert(0, str(smoke.ROOT))
    from rmnet_tpu_torch.ops.flash_attention import flash_read_bwd_reference

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build(n, Path(tmp)), VARIANTS)))
        blocks = built["as_is"].lib.probe_blocks_per_sm
        blocks.argtypes, blocks.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        occupancy = {f"{k}<{dtype}>": blocks(i, code) for i, k in enumerate(KERNELS)
                     for code, dtype in enumerate(("float", "bf16"))}
        smoke.log(f"probe: blocks per SM (occupancy calculator) {occupancy}")

        cases = {n: smoke.bwd_case(n) for n, a in smoke.BWD_CASES.items()
                 if a[4] == torch.float32}
        cases.update(first_step_reads())
        counted = ("train_S3_f32", "first_step_read_t1", "first_step_read_t2")
        bf16 = {"train_S3_bf16": smoke.bwd_case("train_S3_bf16")}
        mma, ok = {}, True
        for name, args in [*((n, cases[n]) for n in counted), *bf16.items()]:
            got, (want, passes) = measure_mma(built["count"], args), design_mma(args)
            executed = sum(got[k] * MMA_FLOP / passes[k] for k in KERNELS)
            design = smoke.read_bwd_executed_flops(args)
            same = got == want and math.isclose(executed, design, rel_tol=1e-12)
            ok &= same
            mma[name] = dict(measured=got, design=want, passes=passes,
                             executed_gflop=executed / 1e9, design_gflop=design / 1e9,
                             active_tiles=int(args[5].sum()), equal=same)
            smoke.log(f"probe: {name}: mma per kernel {got} (design {want}), executed "
                      f"{executed / 1e9:.4f} GFLOP (design {design / 1e9:.4f}) "
                      f"{'equal' if same else 'DIFFER'}")

        tol = smoke.BWD_F32_REL_TOL
        accuracy = {v: {} for v in ("as_is", "tf32_rna", "tf32_raw")}
        for name, args in cases.items():
            ref = flash_read_bwd_reference(*args)
            for v in accuracy:
                accuracy[v][name] = rel_error(built[v], args, ref)
            smoke.log(f"probe: {name}: max|g-plain|/max|plain| " + ", ".join(
                f"{v} {accuracy[v][name]:.3e}" for v in accuracy) + f" (tolerance {tol})")
    caught = {v: any(e > tol for e in accuracy[v].values()) for v in ("tf32_rna", "tf32_raw")}
    passed = all(e <= tol for e in accuracy["as_is"].values())
    smoke.log(f"probe: the f32 tolerance {tol} rejects {caught}; the kernel as it is "
              f"passes: {passed} [{smi}]")
    report = dict(card=smi, blocks_per_sm=occupancy, mma=mma, accuracy=accuracy,
                  f32_rel_tol=tol, controls_caught=caught)
    smoke.OUT_DIR.mkdir(parents=True, exist_ok=True)
    (smoke.OUT_DIR / "bwd_probe.json").write_text(json.dumps(report, indent=1))
    smoke.log(json.dumps(report))
    return 0 if ok and passed and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
