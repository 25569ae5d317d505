"""SIGTERM and SIGINT as a stop request for a loop that finishes its unit
of work first (a training batch, the eval server's in-flight checkpoints)."""

from __future__ import annotations

import contextlib
import logging
import signal
import threading


@contextlib.contextmanager
def stop_on_signals(then: str):
    """An Event that SIGTERM or SIGINT sets, logging ``then`` (what the loop
    does next). The handlers are installed only on the main thread, where
    Python runs them; the previous ones come back on exit."""
    stop = threading.Event()

    def request(signum, frame):
        logging.warning("signal %s received: %s", signum, then)
        stop.set()

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, request)
    try:
        yield stop
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
