"""Training on one GPU: the step and ``train_net`` (counterpart of
rmnet_tpu/core/train.py; reference core/train.py:29-234).

The reference objective: Lovász + NLL over frames 1..T-1 for RMNet, L1
against the batch's flows for TinyFlowNet (reference core/train.py:80-82,
174-180). The step is ``forward_video`` with backprop through time (the
block-sparse flash read and its backward kernel by default, TRAIN.
FLASH_ATTENTION), the loss, ``backward()``, and one Adam update with L2 weight
decay folded into the gradient (torch.optim.Adam is exactly the JAX
package's add_decayed_weights + scale_by_adam + ``-lr * u``). TRAIN.REMAT
recomputes the encoders ("encoders") or whole frames ("step") in the
backward pass; TRAIN.GRAD_ACCUM_STEPS splits the batch into micro-batches
whose gradients are averaged before the one update. TRAIN.BF16 runs every
conv in bfloat16 on float32 master weights (flax's ``dtype``: parameters,
gradients, Adam's moments and checkpoints stay float32; the masks, the
estimate, soft aggregation and the losses too). Modules stay in ``eval()``
mode: BatchNorm is frozen unless TRAIN.USE_BATCH_NORM, which normalizes the
encoders with batch statistics and carries their running statistics from
frame to frame and micro-batch to micro-batch, written to the module once
per step (rmnet_tpu/core/train.py:104, 148-199). A non-finite loss skips
the whole update: parameters, moments and running statistics (reference
core/train.py:187-189).

:func:`train_net` is the reference's training loop: seeded loaders, backbone
init, resume from a full-state ``.pth`` (epoch and Adam state), the
frame-step curriculum, cosine learning rate per epoch, validation through
``test_net`` on one engine whose weights are swapped each epoch, gated
checkpoints, and SIGTERM / SIGINT that finish the batch, save
``ckpt-interrupt.pth`` and return.

The one flag that the port does not honour raises (:func:`check_train_flags`):
TRAIN.DATA_PARALLEL > 1 (ROADMAP queue 1 item 4). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import os
import random
import time
import zipfile
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset
from rmnet_tpu_torch.engine import InferenceEngine, _on_device
from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.ops.losses import l1_loss, lovasz_loss, nll_loss
from rmnet_tpu_torch.test import test_net
from rmnet_tpu_torch.utils.average_meter import AverageMeter
from rmnet_tpu_torch.utils.checkpoint import (load_backbone_weights, load_weights_auto,
                                              save_checkpoint)
from rmnet_tpu_torch.utils.metrics import Metrics
from rmnet_tpu_torch.utils.signals import stop_on_signals
from rmnet_tpu_torch.utils.summary import SummaryWriter

NETWORKS = ("RMNet", "TinyFlowNet")
REMAT_MODES = ("none", "encoders", "step")



def check_train_flags(cfg) -> None:
    """Raise on a TRAIN flag that the port would otherwise ignore."""
    tr = cfg.TRAIN
    if tr.NETWORK not in NETWORKS:
        raise ValueError(f"unknown TRAIN.NETWORK {tr.NETWORK!r}; one of {NETWORKS}")
    if tr.REMAT not in REMAT_MODES + (True, False):
        raise ValueError(f"unknown remat mode {tr.REMAT!r}; TRAIN.REMAT is one of {REMAT_MODES}")
    accum = tr.GRAD_ACCUM_STEPS
    if not isinstance(accum, int) or accum < 1 or tr.BATCH_SIZE % accum:
        raise ValueError(f"TRAIN.GRAD_ACCUM_STEPS={accum!r} must be a positive integer that "
                         f"divides TRAIN.BATCH_SIZE={tr.BATCH_SIZE}")
    if tr.DATA_PARALLEL > 1:
        raise NotImplementedError(f"TRAIN.DATA_PARALLEL = {tr.DATA_PARALLEL}: data parallel "
                                  f"training is not ported yet (ROADMAP queue 1 item 4)")


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """torch-Adam: L2 weight decay folds into the gradient before the moment
    updates (unlike AdamW). The learning rate is set per step."""
    return torch.optim.Adam(params, lr=cfg.TRAIN.LEARNING_RATE, betas=tuple(cfg.TRAIN.BETAS),
                            weight_decay=cfg.TRAIN.WEIGHT_DECAY)


def cosine_lr(base_lr: float, epoch: int, n_epochs: int) -> float:
    """torch CosineAnnealingLR(T_max=n_epochs) value at a given epoch."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / n_epochs))


def with_remat(apply: RMNetApply, remat) -> RMNetApply:
    """``apply`` with a TRAIN.REMAT mode: "step" (or True) recomputes each
    frame in the backward pass, "encoders" only the two encoders, "none"
    (or False) nothing (rmnet_tpu/core/train.py:83-92)."""
    if remat in (True, "step"):
        return dataclasses.replace(apply, remat=True, remat_encoders=False)
    if remat == "encoders":
        return dataclasses.replace(apply, remat=False, remat_encoders=True)
    if remat in (False, "none"):
        return dataclasses.replace(apply, remat=False, remat_encoders=False)
    raise ValueError(f"unknown remat mode {remat!r}")


def make_loss_fn(cfg, apply: RMNetApply, tflownet: TinyFlowNet,
                 remat=None) -> Callable:
    """The training loss of the selected network: batch -> scalar tensor;
    RMNet's with ``remat`` (default TRAIN.REMAT) applied to ``apply``.

    A batch holds frames (B, T, H, W, 3), masks (B, T, K, H, W) one-hot,
    flows (B, T, H, W, 2) and n_objects (B, T), as the JAX package's. With
    ``apply.train_bn`` RMNet's loss takes the running statistics too and
    returns (loss, the statistics after the batch)."""
    ignore = cfg.CONST.IGNORE_IDX
    network = cfg.TRAIN.NETWORK
    if network not in NETWORKS:
        raise ValueError(f"unknown TRAIN.NETWORK {network!r}")
    if network == "RMNet":
        apply = with_remat(apply, cfg.TRAIN.REMAT if remat is None else remat)

    def rmnet_loss(batch, bn=None):
        out = apply.forward_video(batch["frames"], batch["masks"], batch["flows"],
                                  batch["n_objects"], bn)
        est, bn = out if apply.train_bn else (out, None)
        probs_cl = est[:, 1:].movedim(2, -1)                 # (B, T-1, H, W, K)
        labels = batch["masks"][:, 1:].argmax(dim=2)         # (B, T-1, H, W)
        log_probs = torch.log(probs_cl.clamp(min=1e-30))
        loss = lovasz_loss(probs_cl, labels, ignore) + nll_loss(log_probs, labels, ignore)
        return (loss, bn) if apply.train_bn else loss

    def tfn_loss(batch):
        return l1_loss(tflownet.video_forward(batch["frames"]), batch["flows"])

    return rmnet_loss if network == "RMNet" else tfn_loss


def make_train_step(cfg, apply: RMNetApply, tflownet: TinyFlowNet,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """-> step(batch, lr) -> loss (float): gradients of the selected
    network's loss, then one Adam update at ``lr``, skipped (moments
    included) when the loss is not finite.

    With TRAIN.GRAD_ACCUM_STEPS = n > 1 the batch is split into n
    micro-batches along B; their gradients are summed, divided by n, and
    the loss is the mean of theirs (rmnet_tpu/core/train.py:120-201). The
    Lovász term sorts pixels per micro-batch, so this is the mean of the
    micro-batch gradients, not the gradient of one loss over the batch.

    With ``apply.train_bn`` (RMNet) the running statistics go from
    micro-batch to micro-batch and are written to the module after the
    update, only when the loss is finite."""
    loss_fn = make_loss_fn(cfg, apply, tflownet)
    accum = int(cfg.TRAIN.GRAD_ACCUM_STEPS)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    train_bn = cfg.TRAIN.NETWORK == "RMNet" and apply.train_bn

    def step(batch, lr: float) -> float:
        optimizer.zero_grad(set_to_none=True)
        B = batch["frames"].shape[0]
        if B % accum:
            raise ValueError(f"TRAIN.GRAD_ACCUM_STEPS={accum} must divide the batch size "
                             f"(got B={B})")
        losses = []
        bn = apply.running_stats() if train_bn else None
        for i in range(accum):
            micro = slice(i * B // accum, (i + 1) * B // accum)
            micro_batch = {k: v[micro] for k, v in batch.items()}
            if train_bn:
                loss, bn = loss_fn(micro_batch, bn)
            else:
                loss = loss_fn(micro_batch)
            loss.backward()
            losses.append(loss.detach())
        if accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum)
        value = torch.stack(losses).mean().item()
        if math.isfinite(value):
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
            if train_bn:
                apply.load_running_stats(bn)
        return value

    return step


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return device


class Trainer:
    """RMNet and TinyFlowNet on one device with float32 parameters (their
    convs in bfloat16 under TRAIN.BF16), the optimizer of the network
    TRAIN.NETWORK selects, and its train step."""

    def __init__(self, cfg, rmnet_state: Mapping[str, torch.Tensor],
                 tflownet_state: Mapping[str, torch.Tensor], device=None):
        """``device=None`` means the card; there is no fallback to the CPU."""
        self.device = _device(device)
        check_train_flags(cfg)
        self.cfg = cfg
        # eval() mode (BatchNorm frozen unless train_bn), every parameter
        # trainable, float32 masters
        compute = torch.bfloat16 if cfg.TRAIN.BF16 else None
        self.rmnet = _on_device(functools.partial(RMNet, compute), rmnet_state, self.device,
                                torch.float32).requires_grad_(True)
        self.tflownet = _on_device(functools.partial(TinyFlowNet, compute), tflownet_state,
                                   self.device, torch.float32).requires_grad_(True)
        self.apply = RMNetApply(self.rmnet, memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                                use_flash_attention=cfg.TRAIN.FLASH_ATTENTION,
                                train_bn=cfg.TRAIN.USE_BATCH_NORM)
        net = self.rmnet if cfg.TRAIN.NETWORK == "RMNet" else self.tflownet
        self.optimizer = make_optimizer(cfg, net.parameters())
        self._step = make_train_step(cfg, self.apply, self.tflownet, self.optimizer)

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """numpy arrays or tensors -> tensors on the trainer's device, masks
        as float32 there (n_objects stays on the host: it only sets
        per-frame flags)."""
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
               if k != "n_objects"}
        if "masks" in out:
            out["masks"] = out["masks"].float()
        out["n_objects"] = torch.as_tensor(batch["n_objects"])
        return out

    def train_step(self, batch: Mapping, lr: Optional[float] = None) -> float:
        """One step on ``batch`` at ``lr`` (default TRAIN.LEARNING_RATE) ->
        the loss."""
        lr = self.cfg.TRAIN.LEARNING_RATE if lr is None else lr
        return self._step(self.to_device(batch), lr)

    def state_dicts(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        return self.rmnet.state_dict(), self.tflownet.state_dict()


def adam_summary(optimizer_state: Mapping) -> str:
    """One line that identifies an Adam ``state_dict()``: tensors, the
    steps, and the moments' sums of squares."""
    state = optimizer_state["state"].values()
    steps = sorted({int(s["step"]) for s in state})
    m2 = sum(float(s["exp_avg"].double().square().sum()) for s in state)
    v2 = sum(float(s["exp_avg_sq"].double().square().sum()) for s in state)
    return f"Adam state of {len(state)} tensors, steps {steps}, |m|^2 {m2:.12e}, |v|^2 {v2:.12e}"


@dataclasses.dataclass
class TrainStats:
    """What one ``train_net`` run did: batches drawn, batches skipped
    because their step raised (reference core/train.py:187-189), non-finite
    losses (their update skipped), (epoch, BatchTime, DataTime) seconds of
    each trained batch, and each epoch's validation seconds."""

    batches: int = 0
    skipped: int = 0
    non_finite: int = 0
    batch_times: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    val_s: List[float] = dataclasses.field(default_factory=list)


def train_net(cfg, device=None, stats: Optional[TrainStats] = None) -> Optional[Metrics]:
    """Train TRAIN.NETWORK for TRAIN.N_EPOCHS epochs, validating after each
    -> the best Metrics (None when no epoch ran). On the card unless
    ``device`` says otherwise; ``stats``, when given, is filled in."""
    device = _device(device)
    check_train_flags(cfg)
    stats = TrainStats() if stats is None else stats
    train_loader = DataLoader(
        DatasetCollector.get_dataset(cfg, cfg.DATASET.TRAIN_DATASET, DatasetSubset.TRAIN),
        batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=True, drop_last=True,
        seed=cfg.CONST.RNG_SEED, n_workers=cfg.CONST.N_WORKERS)
    val_loader = DataLoader(
        DatasetCollector.get_dataset(cfg, cfg.DATASET.TEST_DATASET, DatasetSubset.VAL),
        batch_size=1, shuffle=False, n_workers=cfg.CONST.N_WORKERS)

    rmnet, tflownet = build_models(cfg, cfg.CONST.RNG_SEED, device="cpu")
    if cfg.TRAIN.BACKBONE_WEIGHTS:
        n = load_backbone_weights(cfg.TRAIN.BACKBONE_WEIGHTS, rmnet)
        logging.info("Initialized both encoder trunks from %s (%d tensors).",
                     cfg.TRAIN.BACKBONE_WEIGHTS, n)
    logging.info("Parameters in TinyFlowNet: %d.", sum(p.numel() for p in tflownet.parameters()))
    logging.info("Parameters in RMNet: %d.", sum(p.numel() for p in rmnet.parameters()))
    rm_state, tfn_state = rmnet.state_dict(), tflownet.state_dict()
    del rmnet, tflownet

    init_epoch, best_metrics, opt_state = 0, None, None
    if cfg.CONST.WEIGHTS:
        logging.info("Recovering from %s ...", cfg.CONST.WEIGHTS)
        rm_state, tfn_state, extras = load_weights_auto(cfg.CONST.WEIGHTS)
        if extras["best_metrics"] is not None:
            best_metrics = Metrics(cfg.TEST.MAIN_METRIC_NAME, dict(extras["best_metrics"]))
        if cfg.TRAIN.RESUME_FULL_STATE and extras["epoch"] is not None:
            init_epoch = int(extras["epoch"])
            opt_state = extras["optimizer"]
        logging.info("Recover completed. Current epoch = #%d; best metrics = %s; %s.",
                     init_epoch, best_metrics,
                     "no optimizer state" if opt_state is None else adam_summary(opt_state))

    # output directories and the code snapshot (reference core/train.py:100-126)
    ckpt_dir = os.path.join(cfg.DIR.OUTPUT_DIR, "checkpoints", cfg.CONST.EXP_NAME)
    log_dir = os.path.join(cfg.DIR.OUTPUT_DIR, "logs", cfg.CONST.EXP_NAME)
    snap_dir = os.path.join(cfg.DIR.OUTPUT_DIR, "snapshots")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(snap_dir, exist_ok=True)
    _snapshot_code(os.path.join(snap_dir, f"{cfg.CONST.EXP_NAME}.zip"), cfg)

    trainer = Trainer(cfg, rm_state, tfn_state, device)
    if opt_state is not None:
        trainer.optimizer.load_state_dict(opt_state)

    def save(name, epoch, metrics):
        path = save_checkpoint(ckpt_dir, name, *trainer.state_dicts(), epoch_index=epoch,
                               best_metrics=None if metrics is None else metrics.state_dict(),
                               optimizer=trainer.optimizer.state_dict())
        logging.info("Saved checkpoint to %s ...", path)

    metrics_threshold = Metrics(cfg.TEST.MAIN_METRIC_NAME,
                                [cfg.TRAIN.CKPT_SAVE_THRESHOLD] * len(Metrics.names()))
    n_batches = len(train_loader)
    last_keep_epoch = -cfg.TRAIN.N_EPOCHS
    val_engine = None  # one engine; each epoch swaps its weights
    train_writer = SummaryWriter(log_dir, "train")
    val_writer = SummaryWriter(log_dir, "test")
    with stop_on_signals("finishing the batch, then checkpointing") as stop, \
            contextlib.closing(train_writer), \
            contextlib.closing(val_writer):
        for epoch_idx in range(init_epoch + 1, cfg.TRAIN.N_EPOCHS + 1):
            epoch_start = time.time()
            batch_time, data_time, losses = AverageMeter(), AverageMeter(), AverageMeter()

            # the frame-step curriculum on the global random (reference
            # core/train.py:146-157)
            if cfg.TRAIN.USE_RANDOM_FRAME_STEPS:
                if (cfg.TRAIN.EPOCH_INDEX_FIXING_FRAME_STEPS <= epoch_idx
                        <= last_keep_epoch + cfg.TRAIN.N_EPOCHS_KEEP_FRAME_STEPS):
                    max_steps = 1
                else:
                    max_steps = random.randint(
                        1, min(cfg.TRAIN.MAX_FRAME_STEPS, epoch_idx // 5 + 2))
                step_val = random.randint(1, max_steps)
                train_loader.dataset.set_frame_step(step_val)
                logging.info("[Epoch %d/%d] Set frame step to %d",
                             epoch_idx, cfg.TRAIN.N_EPOCHS, step_val)

            lr = cosine_lr(cfg.TRAIN.LEARNING_RATE, epoch_idx - 1, cfg.TRAIN.N_EPOCHS)
            n_drawn, n_updated = 0, 0
            batch_end = time.time()
            with contextlib.closing(iter(train_loader)) as batches:
                for batch_idx, (_, n_objects, frames, masks, flows) in enumerate(batches):
                    n_itr = (epoch_idx - 1) * n_batches + batch_idx
                    data_time.update(time.time() - batch_end)
                    n_drawn += 1
                    stats.batches += 1
                    try:
                        loss = trainer.train_step({"frames": frames, "masks": masks,
                                                   "flows": flows, "n_objects": n_objects}, lr)
                    except torch.AcceleratorError:  # a CUDA fault poisons the context
                        raise
                    except Exception as ex:  # skip the batch (reference core/train.py:187-189)
                        logging.exception(ex)
                        stats.skipped += 1
                        batch_end = time.time()
                        continue
                    if math.isfinite(loss):
                        n_updated += 1
                    else:
                        stats.non_finite += 1
                    losses.update(loss)
                    train_writer.add_scalar("Loss/Batch", loss, n_itr)
                    batch_time.update(time.time() - batch_end)
                    batch_end = time.time()
                    stats.batch_times.append((epoch_idx, batch_time.val(), data_time.val()))
                    logging.info(
                        "[Epoch %d/%d][Batch %d/%d] BatchTime = %.3f (s) DataTime = %.3f (s) "
                        "Loss = %.4f", epoch_idx, cfg.TRAIN.N_EPOCHS, batch_idx + 1, n_batches,
                        batch_time.val(), data_time.val(), losses.val())
                    if stop.is_set():
                        break
            if n_drawn and not n_updated:
                raise RuntimeError(f"epoch {epoch_idx}: all {n_drawn} batches were skipped "
                                   f"({stats})")

            if stop.is_set():
                # the epoch is incomplete: a resumed run repeats it
                save("ckpt-interrupt", epoch_idx - 1, best_metrics)
                logging.warning("Stopped in epoch %d; resume with --weights %s", epoch_idx,
                                os.path.join(ckpt_dir, "ckpt-interrupt.pth"))
                break

            train_writer.add_scalar("Loss/Epoch", losses.avg(), epoch_idx)
            logging.log(
                logging.WARNING if stats.skipped or stats.non_finite else logging.INFO,
                "[Epoch %d/%d] EpochTime = %.3f (s) Loss = %.4f; skipped batches = %d, "
                "non-finite losses = %d (this run)", epoch_idx, cfg.TRAIN.N_EPOCHS,
                time.time() - epoch_start, losses.avg(), stats.skipped, stats.non_finite)

            val_start = time.perf_counter()
            if val_engine is None:
                val_engine = InferenceEngine(cfg, *trainer.state_dicts(), device=trainer.device)
            else:
                val_engine.update_weights(*trainer.state_dicts())
            metrics = test_net(cfg, epoch_idx, val_loader, val_writer, val_engine,
                               raise_on_total_failure=False)
            stats.val_s.append(time.perf_counter() - val_start)
            if metrics.state_dict()[cfg.TEST.MAIN_METRIC_NAME] > cfg.TRAIN.KEEP_FRAME_STEPS_THRESHOLD:
                last_keep_epoch = epoch_idx

            # gated checkpoints (reference core/train.py:211-231)
            if epoch_idx % cfg.TRAIN.CKPT_SAVE_FREQ == 0 and metrics.better_than(metrics_threshold):
                save("ckpt-epoch-%03d" % epoch_idx, epoch_idx, metrics)
            if metrics.better_than(best_metrics):
                best_metrics = metrics
                save("ckpt-best", epoch_idx, metrics)
    return best_metrics


def _snapshot_code(zip_path: str, cfg) -> None:
    """Zip the source under the working directory, per experiment
    (reference core/train.py:112-126); the outputs, the top-level ``data``
    and ``build`` directories and hidden ones are left out."""
    root = os.getcwd()
    out_norm = os.path.normpath(os.path.join(root, cfg.DIR.OUTPUT_DIR))
    try:
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for dirname, subdirs, files in os.walk(root):
                subdirs[:] = [d for d in subdirs if not (
                    d.startswith(".") or d in ("__pycache__", "output")
                    or (dirname == root and d in ("data", "build")))]
                if os.path.normpath(dirname).startswith(out_norm):
                    continue
                for filename in files:
                    if filename.endswith((".py", ".cpp", ".cu", ".cuh", ".md", ".json", ".txt")):
                        full = os.path.join(dirname, filename)
                        zf.write(full, os.path.relpath(full, root))
    except Exception as ex:  # a failed snapshot never stops training
        logging.warning("code snapshot failed: %s", ex)
