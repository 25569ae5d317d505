"""step_mfu_pct.train: the reference's forward and backward FLOPs of the
steps in the window's untraced part (work.train_step_flops) over those
steps' seconds and the configuration's peak rate (float32 products against
the published TF32 rate), percent."""


def read(run):
    if run.kind != "train" or run.untraced_s <= 0 or run.flops_untraced <= 0:
        return None
    return 100.0 * run.flops_untraced / (run.untraced_s * run.peak_flops)
