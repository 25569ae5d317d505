"""step_mfu_pct.stream: the reference's model FLOPs of the videos served in
the window's untraced part (work.video_flops, counted from its layer shapes)
over those videos' seconds and the configuration's peak rate, percent."""


def read(run):
    if run.kind != "stream" or run.untraced_s <= 0 or run.flops_untraced <= 0:
        return None
    return 100.0 * run.flops_untraced / (run.untraced_s * run.peak_flops)
