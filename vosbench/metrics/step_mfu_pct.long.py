"""step_mfu_pct.long: step_mfu_pct.stream in the long-video cells, a metric of
its own beside frames_per_s.long (vosbench/metrics/step_mfu_pct.stream.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "step_mfu_pct.stream.py",
                   "vosbench_metric_step_mfu_pct_stream_base").read
