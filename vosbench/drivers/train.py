"""Training: ``Trainer.train_step`` back to back on batches of the reference's
training shape, each handed over in pinned host memory as ``train_net``
does, the loss read back every step.

Set-up: the weights and a pool of batches made from the seed, the trainer,
and its first steps on the pool's first batches, which the reference
follows. The same trainer then steps through the window until the first
step that finishes after ``--seconds``. With ``--trace`` a few steps are
profiled and the read's work is counted on the device. After the window,
the plain reference (float32, TF32 off, Adam written out) takes the same
first steps from the same weights, and the program's losses, first gradient
(the read's input heads each by their own norm), change of the parameters
and first estimates are compared with its.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from vosbench import harness, inputs, work
from vosbench.reference import rmnet_ref
from vosbench.trace import Tracer

# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone: left out of the change's comparison
STILL_LEAF = 1e-3


def make_config(c):
    from rmnet_tpu_torch.config import Config

    cfg = Config()
    tr = cfg.TRAIN
    tr.NETWORK = "RMNet"
    tr.BATCH_SIZE, tr.N_MAX_FRAMES, tr.N_MAX_OBJECTS = (c["batch_size"], c["n_frames"],
                                                        c["n_objects"])
    tr.AUGMENTATION.CROP_HSIZE, tr.AUGMENTATION.CROP_WSIZE = c["crop_height"], c["crop_width"]
    tr.MEMORIZE_EVERY = c["memorize_every"]
    tr.LEARNING_RATE, tr.BETAS, tr.WEIGHT_DECAY = (c["learning_rate"], tuple(c["betas"]),
                                                   c["weight_decay"])
    tr.REMAT, tr.FLASH_ATTENTION = c["remat"], c["flash_attention"]
    tr.BF16, tr.USE_BATCH_NORM = c["bf16"], c["use_batch_norm"]
    tr.GRAD_ACCUM_STEPS, tr.DATA_PARALLEL = 1, 1
    cfg.CONST.IGNORE_IDX = c["ignore_index"]
    return cfg


def make_pool(c, tr, seed, dev):
    return [inputs.train_batch(seed, i, c["batch_size"], c["n_frames"], c["crop_height"],
                               c["crop_width"], c["n_objects"], dev, pin=dev.type == "cuda")
            for i in range(tr["pool"])]


def host_copy(named) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True) for n, p in named}


# the read's inputs: the query key head takes the gradient that the read's
# backward gives dQ, the memory heads those it gives dK and dV
READ_HEADS = ("kv_query.key_conv.", "kv_memory.key_conv.", "kv_memory.value_conv.")


@contextlib.contextmanager
def estimates(record: List[torch.Tensor]):
    """Every estimate that RMNet's training forward returns in the block,
    appended to ``record`` as a float32 host copy."""
    from rmnet_tpu_torch.models.rmnet import RMNetApply

    real = RMNetApply.forward_video

    def forward_video(self, *args, **kw):
        out = real(self, *args, **kw)
        est = out[0] if isinstance(out, tuple) else out
        record.append(est.detach().float().cpu())
        return out

    RMNetApply.forward_video = forward_video
    try:
        yield
    finally:
        RMNetApply.forward_video = real


def first_steps(trainer, pool, n, beta1):
    """The trainer's first ``n`` steps on pool batches 0..n-1 -> (losses, its
    first gradient as Adam got it, the parameters after the n steps, the
    first step's estimates), host copies."""
    named = list(trainer.rmnet.named_parameters())
    losses, grad, est = [], None, []
    for i in range(n):
        with estimates(est) if i == 0 else contextlib.nullcontext():
            losses.append(trainer.train_step(pool[i]))
        if i == 0:  # exp_avg = (1 - beta1) g after one step; none if Adam got none
            state = trainer.optimizer.state
            grad = {name: (state[p]["exp_avg"] / (1 - beta1)).cpu() if "exp_avg" in state[p]
                    else torch.zeros(p.shape) for name, p in named}
    return losses, grad, host_copy(named), est[0] if est else None


def reference_steps(c, rm_sd, pool, n, dev, tf32=False):
    """The reference's first ``n`` steps from ``rm_sd`` on pool batches
    0..n-1 -> (losses, first gradient, parameters after the n steps, the
    first step's estimates); in float32, or with ``tf32`` with cuDNN's TF32
    as the configuration runs."""
    rm, _ = rmnet_ref.on_device(rm_sd, None, dev)
    params = dict(rm.named_parameters())
    state, losses, grad, est = {}, [], None, None
    with (harness.tf32(c["tf32_cudnn"], c["tf32_matmul"]) if tf32 else harness.no_tf32()):
        for i in range(n):
            b = {k: v.to(dev) for k, v in pool[i].items()}
            loss, e = rmnet_ref.train_loss(rm, b["frames"], b["masks"], b["flows"],
                                           b["n_objects"].cpu(), c["memorize_every"],
                                           c["ignore_index"], with_est=True)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if i == 0:
                grad = {k: (g + c["weight_decay"] * params[k]).detach().cpu()
                        for k, g in grads.items()}
                est = e.detach().cpu()
            rmnet_ref.adam_step(params, grads, state, c["learning_rate"], tuple(c["betas"]),
                                weight_decay=c["weight_decay"])
            losses.append(loss.item())
            del loss, grads, b, e
    return losses, grad, host_copy(params.items()), est


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = statistics.median(want.values())
    return max(abs(got[k] - w) / max(w, med) for k, w in want.items())


def own_gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, each against the reference's norm of that leaf, over the
    leaves ``names``."""
    return max(abs(got[k] - want[k]) / want[k] for k in names)


def est_gaps(got: torch.Tensor, want: torch.Tensor):
    """The mean gap of each frame 1..T-1 of a step's estimates (B, T, K, H,
    W); infinite where the program's are not of the reference's shape."""
    if got.shape != want.shape:
        return [math.inf] * (want.shape[1] - 1)
    return [float((got[:, t] - want[:, t]).abs().mean(dtype=torch.float64))
            for t in range(1, want.shape[1])]


def compare(prog, ref, p0) -> Dict[str, float]:
    """The numbers that decide ``correct`` from (losses, first gradient,
    parameters after the steps, first estimates) of the program and of the
    reference, and the starting parameters ``p0``: ``loss_gap``, the
    largest relative gap of the losses; ``grad_gap`` and ``change_gap``, the
    worst leaf's gap of norms (first gradient; change over the steps);
    ``read_grad_gap``, the worst of the read's input heads' first-gradient
    gaps, each over its own norm (leaves that the reference's gradient
    leaves still, as the memory key's bias under the softmax, left out);
    ``est_gap``, the mean gap of the first step's estimates at frame 1,
    which takes the given masks and flows and no box decision of the
    program's own."""
    (lp, gp, pp, ep), (lr, gr, pr, er) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    g_ref, g_prog = _norms(gr), _norms(gp)
    grad_gap = worst_leaf(g_prog, g_ref)
    med = statistics.median(g_ref.values())
    moving = [k for k, g in g_ref.items() if g >= STILL_LEAF * med]
    change_gap = worst_leaf(_norms({k: pp[k] - p0[k] for k in moving}),
                            _norms({k: pr[k] - p0[k] for k in moving}))
    out = dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap,
               read_grad_gap=own_gap(g_prog, g_ref,
                                     [k for k in moving if k.startswith(READ_HEADS)]),
               still_leaves=len(g_ref) - len(moving))
    if ep is not None:
        out["est_gap"] = est_gaps(ep, er)[0]
    return out


def run(cell, opt: harness.Options) -> harness.Run:
    import rmnet_tpu_torch.models.rmnet as rmnet_mod
    from rmnet_tpu_torch.train import Trainer

    c, tr = cell.config, cell.traffic
    dev = torch.device(opt.device)
    torch.backends.cudnn.allow_tf32 = c["tf32_cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = c["tf32_matmul"]
    sync = harness.synchronizer(dev)
    reset_peak, peak = harness.memory(dev)
    B = c["batch_size"]
    rm_sd, tfn_sd = inputs.weights(opt.seed, dev)
    pool = make_pool(c, tr, opt.seed, dev)
    n_first = tr["reference_steps"]
    tracer = Tracer(sync) if opt.trace else None
    counted = work.ReadWork(rmnet_mod, dev) if opt.trace else contextlib.nullcontext()
    with counted:
        trainer = Trainer(make_config(c), rm_sd, tfn_sd, device=dev)
        prog = first_steps(trainer, pool, n_first, c["betas"][0])
        sync()
        setup_s = time.perf_counter() - opt.t0
        setup_peak = peak()
        reset_peak()

        walls, losses, traced, read_work = [], [], [], {}
        first, n_traced = tr["trace_after"], tr["traced_steps"]
        start = time.perf_counter()
        while True:
            n = len(walls)
            if tracer is not None and n == first:
                counted.zero()
                tracer.start()
            batch = pool[(n_first + n) % len(pool)]
            t = time.perf_counter()
            losses.append(trainer.train_step(batch))
            walls.append(time.perf_counter() - t)
            if tracer is not None and tracer.active and n == first + n_traced - 1:
                tracer.stop()
                read_work = counted.read()
                traced = walls[first:]
            if time.perf_counter() - start >= opt.seconds and not (
                    tracer is not None and (tracer.active or n < first)):
                break
        window_s = time.perf_counter() - start
        steps = len(walls)
        window_peak = peak()
        del trainer
    summary = None
    if tracer is not None:
        summary = tracer.summary()
        summary.units = n_traced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    harness.note("window", harness.spread_note(walls))
    p0 = {k: v.detach().cpu() for k, v in rm_sd.items()}
    ref = reference_steps(c, rm_sd, pool, n_first, dev)
    numbers = compare(prog, ref, p0)
    harness.note("reference comparison", numbers)
    limits = cell.limits
    checks = {k: (numbers[k], limits[k]) for k in limits}
    failed = sum(not torch.isfinite(torch.tensor(v)) for v in losses)
    untraced_s = sum(walls) - sum(traced)
    return harness.Run(
        kind="train", setup_s=setup_s, window_s=window_s, attempted=steps, failed=failed,
        counts=dict(steps=steps, clips=steps * B, traced_steps=len(traced),
                    still_leaves=numbers["still_leaves"]),
        walls=walls, peak_bytes_window=window_peak,
        peak_bytes_process=max(setup_peak, window_peak),
        checks=checks, correct=bool(limits) and failed == 0 and harness.judge(checks),
        device=harness.device_info(dev), trace=summary, read_work=read_work,
        flops_untraced=(steps - len(traced)) * work.train_step_flops(
            B, c["n_frames"], c["crop_height"], c["crop_width"], c["n_objects"],
            c["memorize_every"]),
        untraced_s=untraced_s, peak_flops=work.PEAK_FLOPS[c["compute"]])
