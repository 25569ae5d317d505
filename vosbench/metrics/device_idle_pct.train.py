"""device_idle_pct.train: the share of the traced span in which no kernel or
copy ran on the device, percent."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.span_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
