"""Per-device work farm (counterpart of rmnet_tpu/parallel/eval_farm.py;
reference utils/eval_server.py:78-127).

One host thread per device takes work items off a shared queue and runs
``work_fn(device, item)``, with the device made current for the thread
first (``torch.cuda.set_device``), so that whatever the work builds or
replays (an InferenceEngine and its CUDA graphs) lives on that device. The
devices default to every CUDA device; the tests pass CPU devices.

Unlike the JAX farm, a failing item is not turned into None: its exception
reaches the caller (``DeviceFarm.map`` raises the first one once every
worker has stopped; ``AsyncDeviceFarm.submit``'s future holds it). Which
failures may be skipped is the work function's decision.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import torch


def cuda_devices() -> List[torch.device]:
    """Every CUDA device; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass devices=[torch.device('cpu')] to run on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _on(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


class DeviceFarm:
    """``map`` over devices: one thread per device, results in input order."""

    def __init__(self, work_fn: Callable[[torch.device, Any], Any],
                 devices: Optional[Sequence[torch.device]] = None):
        self.devices = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
        self.work_fn = work_fn

    def map(self, items: Sequence[Any]) -> List[Any]:
        """``work_fn`` on every item -> the results in input order; raises the
        first exception of a worker after all of them have stopped (a worker
        that fails takes no further item)."""
        in_q: "queue.Queue" = queue.Queue()
        for i, item in enumerate(items):
            in_q.put((i, item))
        results: List[Any] = [None] * len(items)
        errors: List[BaseException] = []

        def worker(device):
            _on(device)
            while not errors:
                try:
                    i, item = in_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    results[i] = self.work_fn(device, item)
                except BaseException as ex:  # noqa: B902  (re-raised by map)
                    errors.append(ex)

        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in self.devices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


class AsyncDeviceFarm:
    """Persistent per-device worker threads behind ``submit`` -> Future, so
    that a slow item on one device never delays a fast one on another (the
    reference harvests its worker threads while polling,
    utils/eval_server.py:216-263). A cancelled future's item is never run."""

    def __init__(self, work_fn: Callable[[torch.device, Any], Any],
                 devices: Optional[Sequence[torch.device]] = None):
        self.devices = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
        self.work_fn = work_fn
        self._in_q: "queue.Queue" = queue.Queue()
        self._stopped = False
        self._threads = [threading.Thread(target=self._worker, args=(d,), daemon=True)
                         for d in self.devices]
        for t in self._threads:
            t.start()

    def _worker(self, device):
        _on(device)
        while True:
            task = self._in_q.get()
            if task is None:  # shutdown sentinel
                return
            future, item = task
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(self.work_fn(device, item))
            except BaseException as ex:  # noqa: B902  (the future holds it)
                future.set_exception(ex)
                if isinstance(ex, (KeyboardInterrupt, SystemExit)):
                    raise

    def submit(self, item: Any) -> Future:
        """Queue an item -> its Future, at once."""
        if self._stopped:
            raise RuntimeError("farm is shut down")
        future: Future = Future()
        self._in_q.put((future, item))
        return future

    def shutdown(self, wait: bool = True) -> None:
        """Stop the workers once the queue ahead of the sentinels is done;
        idempotent."""
        if self._stopped:
            return
        self._stopped = True
        for _ in self._threads:
            self._in_q.put(None)
        if wait:
            for t in self._threads:
                t.join()
