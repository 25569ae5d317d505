"""What every driver shares: the run's record, the window's statistics, the
seeded sample of served requests, the checks on the process, and the
result line."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from vosbench import inputs
from vosbench.manifest import ROOT, Cell

# modules that no process of the benchmark may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rmnet_tpu")


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0  # perf_counter() at the process's start


@dataclasses.dataclass
class Run:
    """What a driver measured; the metric readers take their numbers from it."""

    kind: str                        # the driver: "stream" or "train"
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    counts: Dict[str, float]         # videos, frames, steps, clips, replays, ...
    walls: List[float]               # seconds of each request or step in the window
    peak_bytes_window: int
    peak_bytes_process: int
    checks: Dict[str, Tuple[float, Optional[float]]]  # name -> (value, limit)
    correct: bool
    device: Dict[str, Any]
    trace: Any = None                # trace.Summary of the traced part, or None
    read_work: Dict[str, float] = dataclasses.field(default_factory=dict)
    # model FLOPs of the window's untraced part, its seconds, the peak rate
    flops_untraced: float = 0.0
    untraced_s: float = 0.0
    peak_flops: float = 0.0


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, interpolated linearly
    between the closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port's nvcc builds go to its own build/kernels/)."""
    base = ROOT / "build" / "vosbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def synchronizer(device) -> Callable[[], None]:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def memory(device) -> Tuple[Callable[[], None], Callable[[], int]]:
    """(reset the peak, read the peak in bytes) of ``device``; 0 off the card.
    The peak of memory reserved, not allocated: the private pools of CUDA
    graphs hold their tensors' memory outside the allocator's count of
    allocated bytes, and what the process reserves is what other streams or
    clips cannot have."""
    import torch

    if torch.device(device).type == "cuda":
        return (lambda: torch.cuda.reset_peak_memory_stats(device),
                lambda: int(torch.cuda.max_memory_reserved(device)))
    return (lambda: None), (lambda: 0)


@contextlib.contextmanager
def tf32(cudnn: bool, matmul: bool):
    """cuDNN's and matmul's TF32 flags set for the block."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def no_tf32():
    """Float32 products in float32: the reference's precision."""
    return tf32(False, False)


def device_info(device, count: int = 1) -> Dict[str, Any]:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=count)
    return dict(platform="cpu", kind="cpu", count=count)


class Reservoir:
    """A uniform sample of ``k`` of the requests served, drawn from the seed
    as they finish (Algorithm R): the same seed and count give the same
    picks."""

    def __init__(self, seed: int, k: int):
        self.k, self.rng = k, inputs.rng(seed, 9)
        self.items: Dict[int, Any] = {}
        self.seen = 0

    def offer(self, value: Any) -> None:
        i, self.seen = self.seen, self.seen + 1
        if len(self.items) < self.k:
            self.items[i] = value
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                del self.items[sorted(self.items)[j]]
                self.items[i] = value


def judge(checks: Dict[str, Tuple[float, Optional[float]]]) -> bool:
    """Every compared number within its limit; a number without a limit, or
    not finite, fails."""
    return all(limit is not None and math.isfinite(v) and v <= limit
               for v, limit in checks.values())


def result(cell: Cell, run: Run, trace: bool) -> Dict[str, Any]:
    """The result line: the cell's end-to-end metrics (``trace`` off) or its
    per-layer metrics (``trace`` on), each a reader's number; a reader with
    nothing to read is left out."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device = dict(run.device, memory_peak_bytes=run.peak_bytes_process)
    out: Dict[str, Any] = dict(correct=bool(run.correct), attempted=int(run.attempted),
                               failed=int(run.failed), metrics=metrics, device=device)
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.span_s
        out["breakdown"] = dict(device_ops=[[n, s] for n, s in run.trace.buckets()[:10]],
                                idle_gaps=[[n, s] for n, s in run.trace.gaps[:10]])
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, (v, limit) in run.checks.items()}
    return out


def spread_note(walls: List[float]) -> Dict[str, Any]:
    """Where a window's time went, for the note of a run: the quartiles and
    ends of its requests' or steps' seconds in ms, and the mean of each
    third of them (a drift inside the window shows there)."""
    ms = np.asarray(walls, np.float64) * 1e3
    thirds = [float(part.mean()) for part in np.array_split(ms, 3) if len(part)]
    return dict(n=len(ms), min_ms=float(ms.min()), q1_ms=percentile(ms, 25),
                median_ms=percentile(ms, 50), q3_ms=percentile(ms, 75), max_ms=float(ms.max()),
                thirds_mean_ms=thirds)


def note(what: str, numbers: Dict[str, Any]) -> None:
    """A line of diagnostics on standard error."""
    print(f"vosbench: {what}: {json.dumps(numbers)}", file=sys.stderr, flush=True)


def emit(line: Dict[str, Any]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error; the result as the last line of standard output."""
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
