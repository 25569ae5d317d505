"""read_fwd_roofline_pct.long: read_fwd_roofline_pct in the long-video cells, a metric of
its own so that its bound follows those cells' spread (metrics/read_fwd_roofline_pct.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "read_fwd_roofline_pct.py",
                   "vosbench_metric_read_fwd_roofline_pct_base").read
