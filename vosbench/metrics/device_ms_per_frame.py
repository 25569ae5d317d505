"""device_ms_per_frame: the device's busy time (the union of its kernel and
copy intervals) in the traced videos, per frame segmented."""


def read(run):
    t = run.trace
    if run.kind != "stream" or t is None or t.busy_s <= 0 or not t.units:
        return None
    return t.busy_s / t.units * 1e3
