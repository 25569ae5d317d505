"""The traced window: torch.profiler over a bounded steady part of a run,
reduced to device busy time, kernel time by name, buckets and idle gaps.

Busy time is the union of the device's kernel, copy and set intervals inside
the traced span, so two overlapping operations count once. The span is the
host's interval of the ``vosbench.traced`` range, on the profiler's own
clock, so busy and span come from one timeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

ROOT_RANGE = "vosbench.traced"

# kernel-name patterns of the breakdown's buckets, first match wins (the
# repository's smoke test, chip_smoke.py _BUCKETS)
BUCKETS = (
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
OTHER = "elementwise and other"


def bucket(name: str) -> str:
    return next((b for b, pats in BUCKETS if any(p in name for p in pats)), OTHER)


@dataclasses.dataclass
class Summary:
    """What the traced span shows. Seconds throughout."""

    span_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # summed duration by device op name
    gaps: List[Tuple[str, float]]       # the longest idle gaps, by host op under them
    units: int = 0                      # frames or steps in the span (set by the driver)

    def sum_matching(self, pattern: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if pattern in name)

    def buckets(self) -> List[Tuple[str, float]]:
        out: Dict[str, float] = {}
        for name, s in self.kernel_s.items():
            b = bucket(name)
            out[b] = out.get(b, 0.0) + s
        return sorted(out.items(), key=lambda kv: -kv[1])


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def summarize(device: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float]], n_gaps: int = 10) -> Optional[Summary]:
    """Reduce events (name, start, end), microseconds on one clock, to a
    Summary. ``host`` holds the CPU-side ranges and ops, one of them the
    ``vosbench.traced`` root. None without the root."""
    root = [(a, b) for name, a, b in host if name == ROOT_RANGE]
    if not root:
        return None
    lo, hi = root[0]
    clipped = [(name, max(a, lo), min(b, hi)) for name, a, b in device
               if b > lo and a < hi and not name.startswith("vosbench.")]
    busy = _union([(a, b) for _, a, b in clipped])
    kernel_s: Dict[str, float] = {}
    for name, a, b in clipped:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    idle, at = [], lo
    for a, b in busy:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if hi > at:
        idle.append((at, hi))
    idle.sort(key=lambda g: g[0] - g[1])
    inner = [(name, a, b) for name, a, b in host if name != ROOT_RANGE]
    gaps = []
    for a, b in idle[:n_gaps]:
        # the innermost host op running when the device went idle
        under = [(s, -(e - s), name) for name, s, e in inner if s <= a < e]
        gaps.append((max(under)[2] if under else "host (no op recorded)", (b - a) * 1e-6))
    return Summary(span_s=(hi - lo) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                   kernel_s=kernel_s, gaps=gaps)


class Tracer:
    """torch.profiler (CPU and CUDA activity) around a part of the window,
    under the ``vosbench.traced`` range; ``summary()`` once stopped."""

    def __init__(self, sync):
        self.sync = sync
        self.prof = self.root = None
        self.active = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.root = record_function(ROOT_RANGE)
        self.root.__enter__()
        self.active = True

    def stop(self) -> None:
        self.sync()
        self.root.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False

    def summary(self) -> Optional[Summary]:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            (device if e.device_type == DeviceType.CUDA else host).append(item)
        return summarize(device, host)
