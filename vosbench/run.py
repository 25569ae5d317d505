"""Run one cell of the benchmark once.

    python3 -m vosbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the cell's configuration and traffic,
makes the weights and inputs from the seed, warms up (set-up), measures for
``--seconds`` (the window ends with the first request or step that finishes
after it), checks what the window produced against the plain reference, and
prints one JSON line last: the end-to-end metrics, or with ``--trace 1`` the
per-layer metrics of a traced part of the window. Exits non-zero with no
result when the card or the cell's chips are missing, or when the process
holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from vosbench import harness, manifest

    cell = manifest.cell(args.workload)
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vosbench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    opt = harness.Options(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device="cuda", t0=_T0)
    run = manifest.driver(cell.driver).run(cell, opt)
    bad = harness.forbidden_modules()
    if bad:
        print(f"vosbench: the process holds {bad}", file=sys.stderr)
        return 4
    harness.emit(harness.result(cell, run, opt.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
