"""read_bwd_roofline_pct: the read's backward least time on its inputs
(work.read_terms, counted on the device at each forward call) over the time
of the kernels named flash_read_bwd in the traced steps, percent."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not run.read_work:
        return None
    kernel_s = t.sum_matching("flash_read_bwd")
    if kernel_s <= 0 or run.read_work["bwd_bound_s"] <= 0:
        return None
    return 100.0 * run.read_work["bwd_bound_s"] / kernel_s
