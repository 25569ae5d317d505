"""graph_replays_per_video.long: graph_replays_per_video in the long-video cells, a metric of
its own so that its bound follows those cells' spread (metrics/graph_replays_per_video.py)."""

from vosbench.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "graph_replays_per_video.py",
                   "vosbench_metric_graph_replays_per_video_base").read
