"""read_fwd_ms_per_frame: time of the kernels named flash_read_fwd in the
traced videos, per frame segmented."""


def read(run):
    t = run.trace
    if run.kind != "stream" or t is None or not t.units:
        return None
    kernel_s = t.sum_matching("flash_read_fwd")
    return kernel_s / t.units * 1e3 if kernel_s > 0 else None
