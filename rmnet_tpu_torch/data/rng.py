"""Thread-local RNG streams for the data pipeline (counterpart of
rmnet_tpu/data/rng.py).

The loader's workers are threads of one process, so draws from the global
``random`` / ``np.random`` would interleave with the scheduling. Every draw
in datasets and transforms goes through ``pyrand()`` / ``nprand()``:

* by default they return the global modules;
* ``DataLoader`` calls ``seed_stream(seed)`` in the decoding thread before
  each batch, giving that batch its own seeded pair of RNGs, so decoded data
  depends only on (loader seed, epoch, batch index), not on the worker count
  or the scheduling.
"""

import random
import threading

import numpy as np

_TLS = threading.local()


def seed_stream(seed: int) -> None:
    """Give the calling thread its own RNGs seeded with ``seed``."""
    _TLS.py = random.Random(seed)
    _TLS.np = np.random.RandomState(int(seed) % (2**32))


def clear_stream() -> None:
    """Revert the calling thread to the process-global RNGs."""
    _TLS.py = None
    _TLS.np = None


def pyrand():
    """This thread's ``random``-compatible RNG (the global module by default)."""
    return getattr(_TLS, "py", None) or random


def nprand():
    """This thread's ``np.random``-compatible RNG (the global one by default)."""
    return getattr(_TLS, "np", None) or np.random
