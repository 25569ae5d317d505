"""read_fwd_ms_per_frame.long: read_fwd_ms_per_frame in the long-video cells, a metric of
its own so that its bound follows those cells' spread (metrics/read_fwd_ms_per_frame.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "read_fwd_ms_per_frame.py",
                   "vosbench_metric_read_fwd_ms_per_frame_base").read
