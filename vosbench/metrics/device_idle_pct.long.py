"""device_idle_pct.long: device_idle_pct.stream in the long-video cells, a
metric of its own beside frames_per_s.long
(vosbench/metrics/device_idle_pct.stream.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "device_idle_pct.stream.py",
                   "vosbench_metric_device_idle_pct_stream_base").read
