"""video_ms_p90: the 90th percentile of every video's wall time in the
window, from handing over its frames to holding its probabilities, host
clock."""

from vosbench.harness import percentile


def read(run):
    if run.kind != "stream" or not run.walls:
        return None
    return percentile(run.walls, 90) * 1e3
