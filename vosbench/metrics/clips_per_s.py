"""clips_per_s: clips stepped in the window (batch size x steps, the loss
read back every step) over the window's seconds, host clock."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.counts["clips"] / run.window_s
