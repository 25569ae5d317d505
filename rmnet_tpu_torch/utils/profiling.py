"""Profiling hooks (counterpart of rmnet_tpu/utils/profiling.py): the port's
span and counter recorder, its device phase stamps, and torch.profiler
traces.

Host spans, at the layer boundaries of the engine and the trainer:

    with span("engine.video", new_request()):
        with span("engine.stage"):
            ...

A span is stamped with ``time.time_ns()``, the clock torch.profiler stamps
its host events with, so :func:`trace_start_offset` puts spans on a trace's
timeline with no calibration. Device phases, inside the chunk graphs and
the eager training step: ``phase(name, device)`` charges the device time
since the previous stamp to ``name`` (``phase(None, device)`` only sets the
clock). On the card each stamp is a one-thread kernel that reads the
global timer and adds to an int64 accumulator on the device, so a stamp
recorded into a CUDA graph counts at every replay; on the CPU, whose ops
run synchronously, a stamp reads the host clock.

Everything records only while the recorder is on (:func:`enable`); off, a
span is one shared no-op context and a stamp returns at once, so a graph
captured with the recorder off holds no stamp. An operator's use:

    with trace_if("/tmp/trace"):
        engine.run_video_labels(...)
    # then open /tmp/trace/rmnet_trace.json in chrome://tracing or Perfetto:
    # the kernels, and the block's spans beside them

Or from the environment: RMNET_TRACE_DIR=/tmp/trace python -m
rmnet_tpu_torch.runner --test ...
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from rmnet_tpu_torch.ops.flash_attention import _Library

# phases a device accumulator holds; a name past them raises
MAX_PHASES = 16
STAMP_LIBRARY = _Library("phase_stamp", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


class Span(NamedTuple):
    name: str
    start_ns: int             # time.time_ns() at entry
    end_ns: int
    parent: Optional[str]     # the enclosing span on the thread
    req: Optional[int]        # the request (video, step) it belongs to


_OFF = contextlib.nullcontext()


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class _Open:
    """One span while it runs."""

    __slots__ = ("rec", "name", "req", "parent", "start")

    def __init__(self, rec: "Recorder", name: str, req: Optional[int]):
        self.rec, self.name, self.req = rec, name, req

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1].name if stack else None
        if self.req is None and stack:
            self.req = stack[-1].req
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec._stack().pop()
        self.rec._record(Span(self.name, self.start, end, self.parent, self.req))
        return False


class Recorder:
    """Host spans in a bounded buffer with per-name totals beside it, and
    device phase accumulators. Off until :meth:`enable`."""

    def __init__(self, max_spans: int = 1 << 16):
        self.on = False
        self.max_spans = max_spans
        self.dropped = 0  # spans past the bound: in the totals, not in the buffer
        self._spans: List[Span] = []
        self._totals: Dict[str, List[int]] = {}   # name -> [ns, count]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count()
        self._slots: Dict[str, int] = {}          # phase name -> accumulator slot
        self._host_phases: List[int] = [0] * (1 + 2 * MAX_PHASES)
        self._device_phases: Dict[torch.device, torch.Tensor] = {}

    # ---------------------------------------------------------------- spans
    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def new_request(self) -> Optional[int]:
        """A fresh request id for a video or a step (None while off)."""
        return next(self._requests) if self.on else None

    def span(self, name: str, req: Optional[int] = None):
        """Context that records ``name`` over its block; ``req`` defaults to
        the enclosing span's. Off, or inside a CUDA graph capture, the shared
        no-op context."""
        if not self.on or _capturing():
            return _OFF
        return _Open(self, name, req)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, s: Span) -> None:
        with self._lock:
            total = self._totals.setdefault(s.name, [0, 0])
            total[0] += s.end_ns - s.start_ns
            total[1] += 1
            if len(self._spans) < self.max_spans:
                self._spans.append(s)
            else:
                self.dropped += 1

    def drain(self) -> List[Span]:
        """The buffered spans, in the order they ended; the buffer is emptied."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """Seconds and count of every span name since :meth:`clear`."""
        with self._lock:
            return {name: (ns * 1e-9, n) for name, (ns, n) in self._totals.items()}

    def clear(self) -> None:
        """Forget spans, totals, the dropped count and every phase total
        (device accumulators are zeroed in place: graphs hold them)."""
        with self._lock:
            self._spans, self._totals, self.dropped = [], {}, 0
            self._host_phases = [0] * len(self._host_phases)
        for acc in self._device_phases.values():
            acc.zero_()

    # --------------------------------------------------------------- phases
    def _slot(self, name: str) -> int:
        slot = self._slots.get(name)
        if slot is None:
            if len(self._slots) == MAX_PHASES:
                raise ValueError(f"more than {MAX_PHASES} phase names: {name!r}")
            slot = self._slots[name] = len(self._slots)
        return slot

    def _accumulator(self, device: torch.device) -> torch.Tensor:
        acc = self._device_phases.get(device)
        if acc is None:
            if _capturing():
                raise RuntimeError("phase: the device's accumulator must exist before a "
                                   "CUDA graph capture (stamp once outside it)")
            STAMP_LIBRARY.load()
            with torch.inference_mode(False):  # a normal tensor, which clear() may zero
                acc = self._device_phases[device] = torch.zeros(
                    1 + 2 * MAX_PHASES, dtype=torch.int64, device=device)
        return acc

    def phase(self, name: Optional[str], device) -> None:
        """Charge the time since the previous stamp on ``device`` to phase
        ``name`` and restart the clock; ``None`` only restarts it. On the
        card a kernel on the current stream (recorded when captured)."""
        if not self.on:
            return
        slot = -1 if name is None else self._slot(name)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            acc = self._accumulator(device)
            err = STAMP_LIBRARY.lib.phase_stamp(
                acc.data_ptr(), slot, torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"phase_stamp launch failed: CUDA error {err}")
            return
        now, acc = time.perf_counter_ns(), self._host_phases
        if slot >= 0:
            acc[1 + 2 * slot] += now - acc[0]
            acc[2 + 2 * slot] += 1
        acc[0] = now

    def phase_totals(self) -> Dict[str, Tuple[float, int]]:
        """Seconds and count of every phase since :meth:`clear`, the host's
        and every device's together (one copy from each device)."""
        accs = [self._host_phases] + [a.tolist() for a in self._device_phases.values()]
        out = {}
        for name, slot in self._slots.items():
            ns = sum(a[1 + 2 * slot] for a in accs)
            n = sum(a[2 + 2 * slot] for a in accs)
            if n:
                out[name] = (ns * 1e-9, n)
        return out


RECORDER = Recorder()
enable, disable, clear = RECORDER.enable, RECORDER.disable, RECORDER.clear
span, new_request, phase = RECORDER.span, RECORDER.new_request, RECORDER.phase
drain, totals, phase_totals = RECORDER.drain, RECORDER.totals, RECORDER.phase_totals


def trace_start_offset(prof) -> int:
    """The ``time.time_ns()`` of a finished torch.profiler ``prof``'s zero:
    a span's (start_ns - offset) / 1e3 is its place in microseconds on the
    timeline of ``prof.events()``."""
    return int(prof.profiler.kineto_results.trace_start_ns())


def _add_spans(path: str, spans: List[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` on its own clock
    (``ts`` in microseconds after ``baseTimeNanoseconds``), one row for the
    recorder."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"].extend(
        dict(ph="X", cat="rmnet_span", name=s.name, pid=pid, tid="rmnet spans",
             ts=(s.start_ns - base) / 1e3, dur=(s.end_ns - s.start_ns) / 1e3,
             args=dict(parent=s.parent, req=s.req))
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_if(log_dir: Optional[str] = None, enabled: bool = True):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written as a Chrome trace to ``<log_dir>/rmnet_trace.json`` with
    the block's spans beside the kernels (the recorder is on for the
    block); ``log_dir`` defaults to RMNET_TRACE_DIR, and without either, or
    with ``enabled=False``, nothing is traced. A profiler that fails raises:
    a trace that was asked for is never dropped in silence."""
    log_dir = log_dir or os.environ.get("RMNET_TRACE_DIR")
    if not (enabled and log_dir):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "rmnet_trace.json")
    was_on = RECORDER.on
    RECORDER.enable()
    t0 = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            RECORDER.disable()
    with RECORDER._lock:
        spans = [s for s in RECORDER._spans if s.start_ns >= t0]
    prof.export_chrome_trace(path)
    _add_spans(path, spans)
    logging.info("profiler trace written to %s (%d spans)", path, len(spans))
