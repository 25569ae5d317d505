"""Profiling hooks (counterpart of rmnet_tpu/utils/profiling.py):
torch.profiler traces and wall-clock scopes.

    with trace_if("/tmp/trace"):
        engine.run_video_labels(...)
    # then open /tmp/trace/rmnet_trace.json in chrome://tracing or Perfetto

Or from the environment: RMNET_TRACE_DIR=/tmp/trace python -m
rmnet_tpu_torch.runner --test ...
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional


@contextlib.contextmanager
def trace_if(log_dir: Optional[str] = None, enabled: bool = True):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written as a Chrome trace to ``<log_dir>/rmnet_trace.json``;
    ``log_dir`` defaults to RMNET_TRACE_DIR, and without either, or with
    ``enabled=False``, nothing is traced. A profiler that fails raises:
    a trace that was asked for is never dropped in silence."""
    log_dir = log_dir or os.environ.get("RMNET_TRACE_DIR")
    if not (enabled and log_dir):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "rmnet_trace.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


class Stopwatch:
    """Accumulating wall-clock scopes (host side: synchronize the device
    inside a scope to time its work)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot*1e3:.1f} ms over {n} calls "
                         f"({tot/n*1e3:.2f} ms/call)")
        return "\n".join(lines)
