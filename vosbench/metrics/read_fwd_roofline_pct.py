"""read_fwd_roofline_pct: the memory read's least time on its inputs (work.
read_terms: in-box valid positions, counted on the device as the window runs)
over the time of the kernels named flash_read_fwd in the traced part,
percent."""


def read(run):
    t = run.trace
    if run.kind != "stream" or t is None or not run.read_work:
        return None
    kernel_s = t.sum_matching("flash_read_fwd")
    if kernel_s <= 0 or run.read_work["fwd_bound_s"] <= 0:
        return None
    return 100.0 * run.read_work["fwd_bound_s"] / kernel_s
