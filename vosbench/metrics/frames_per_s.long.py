"""frames_per_s.long: frames_per_s in the long-video cells, a metric of
its own so that its bound follows those cells' spread (metrics/frames_per_s.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "frames_per_s.py",
                   "vosbench_metric_frames_per_s_base").read
