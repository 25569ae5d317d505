"""device_ms_per_step: the device's busy time (the union of its kernel and
copy intervals) in the traced steps, per step."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.busy_s <= 0 or not t.units:
        return None
    return t.busy_s / t.units * 1e3
