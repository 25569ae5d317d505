"""Tests of the benchmark itself (not of the program): run from the root of a
checkout with ``python -m pytest vosbench/tests -q``; the ``gpu`` tests run on
the card with ``-m gpu`` and skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")
