"""frames_per_s: frames segmented in the window over the window's seconds
(frames 1..T-1 of every video; frame 0 is given), host clock."""


def read(run):
    if run.kind != "stream" or run.window_s <= 0:
        return None
    return run.counts["frames"] / run.window_s
