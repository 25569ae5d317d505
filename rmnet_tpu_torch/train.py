"""Training: the step and ``train_net``, on one GPU or data-parallel over
ranks (counterpart of rmnet_tpu/core/train.py; reference
core/train.py:29-234).

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

TRAIN.DATA_PARALLEL = n > 1 trains on n ranks with the JAX mesh's semantics
(rmnet_tpu/core/train.py:279, 340-341; rmnet_tpu_torch/parallel/mesh.py):
the step is that of one device on the global batch, up to the order of
sums. Each rank runs the model on its rows of the batch (the layout of
GRAD_ACCUM_STEPS: micro-batch j is global rows [j B/A, (j+1) B/A), each
rank one n-th of it); the loss is computed on every rank over the
estimates and labels of the whole micro-batch, gathered; trainable
BatchNorm takes the global batch's statistics; the gradients are summed
over the ranks once, after the last micro-batch, so every rank takes the
same Adam update and the same non-finite decision. ``train_net`` starts the
ranks itself (or joins the ``torchrun`` world of that size): rank 0 runs
the loader and broadcasts each global batch, writes the logs and
checkpoints and runs the validation while the others wait; a stop request
is agreed on by every rank after each step. A step that raises on a rank
ends the run there (the others would wait in a collective): the skip rule
holds for one process only. Flags that do not fit raise
(:func:`check_train_flags`). Entry points run on the card unless the caller
passes ``device="cpu"``.

Hybrid batch x width training (Python API, as in the JAX package: a
:class:`~rmnet_tpu_torch.parallel.mesh.HybridMesh` from ``make_hybrid_mesh``
given as the ``mesh`` of :func:`make_loss_fn`, :func:`make_train_step` or
:class:`Trainer`, the batch placed by ``hybrid_shard_batch``): the same
step again, with each rank's rows split over the "space" ranks by frame
width (parallel/space.py). The loss gathers the estimates over both axes
(each rank's columns, then its rows) and the labels over the rows; trainable
BatchNorm takes the statistics of the whole grid; the gradients are summed
over every rank of the grid. RMNet runs on whole columns of its /16 grid,
TinyFlowNet (its flows gathered likewise, the given flows over the rows) on
whole columns of its /64 grid; a rank that holds no column takes part in
every collective and adds zeros to the gradient.
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
from rmnet_tpu_torch.models.tiny_flownet import CELL as TFN_CELL, TinyFlowNet
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.ops.flash_attention import BWD_LIBRARY, LIBRARY
from rmnet_tpu_torch.ops.losses import l1_loss, lovasz_loss, nll_loss
from rmnet_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, DataMesh, HybridMesh,
                                           all_gather_rows, all_reduce_grads, any_rank,
                                           barrier, broadcast_tensors, default_backend,
                                           hybrid_shard_batch, init_mesh, launch, mesh_devices,
                                           shard_batch)
from rmnet_tpu_torch.parallel.space import width_mesh
from rmnet_tpu_torch.test import test_net
from rmnet_tpu_torch.utils.average_meter import AverageMeter
from rmnet_tpu_torch.utils.checkpoint import (load_backbone_weights, load_weights_auto,
                                              save_checkpoint)
from rmnet_tpu_torch.utils.metrics import Metrics
from rmnet_tpu_torch.utils.profiling import new_request, phase, span
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
    n = tr.DATA_PARALLEL
    if not isinstance(n, int) or n < 1 or tr.BATCH_SIZE // accum % n:
        raise ValueError(f"TRAIN.DATA_PARALLEL={n!r} must be a positive integer that divides "
                         f"TRAIN.BATCH_SIZE / TRAIN.GRAD_ACCUM_STEPS = {tr.BATCH_SIZE} / {accum}")


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


def _hybrid_apply(apply: RMNetApply, mesh: HybridMesh, height: int, width: int
                  ) -> RMNetApply:
    """``apply`` on the rank's columns of frames of height x width, with
    BatchNorm over the whole grid. A "space" rank that holds no column of
    the /16 grid takes part all the same: its ops give empty results that
    depend on their weights with a zero gradient (parallel/space.py)."""
    return dataclasses.replace(apply, space=width_mesh(mesh.space, height, width),
                               mesh=mesh.world)


def make_loss_fn(cfg, apply: RMNetApply, tflownet: TinyFlowNet,
                 remat=None, mesh=None) -> Callable:
    """The training loss of the selected network: batch -> scalar tensor;
    RMNet's with ``remat`` (default TRAIN.REMAT) applied to ``apply``.

    A batch holds frames (B, T, H, W, 3), masks (B, T, K, H, W) one-hot,
    flows (B, T, H, W, 2) and n_objects (B, T), as the JAX package's. With
    ``apply.train_bn`` RMNet's loss takes the running statistics too and
    returns (loss, the statistics after the batch). With a ``mesh`` (a
    DataMesh) the batch is the rank's rows, and the loss that of the ranks'
    rows together: the estimates and labels (flows for TinyFlowNet) are
    gathered in rank order before the loss, the same on every rank. With a
    HybridMesh the rank runs its columns of its rows: the estimates are
    gathered over the "space" ranks, then the rows over "data" (each
    gather's backward keeps the rank's part of the gradient), the labels
    over "data"; BatchNorm takes the grid's statistics. TinyFlowNet runs its
    /64 columns of its rows (``tiny_flownet.CELL``), its flows gathered over
    "space", then with the given flows over "data"."""
    ignore = cfg.CONST.IGNORE_IDX
    network = cfg.TRAIN.NETWORK
    if network not in NETWORKS:
        raise ValueError(f"unknown TRAIN.NETWORK {network!r}")
    hybrid = isinstance(mesh, HybridMesh)
    rows = mesh.data if hybrid else mesh
    if network == "RMNet":
        apply = with_remat(apply, cfg.TRAIN.REMAT if remat is None else remat)

    def rmnet_loss(batch, bn=None):
        run = _hybrid_apply(apply, mesh, *batch["masks"].shape[-2:]) if hybrid else apply
        out = run.forward_video(batch["frames"], batch["masks"], batch["flows"],
                                batch["n_objects"], bn)
        est, bn = out if apply.train_bn else (out, None)
        probs = est[:, 1:]
        if hybrid:  # the rank's columns -> the whole width
            probs = run.space.gather_unpadded(probs, "loss gather", summed=False)
        probs_cl = probs.movedim(2, -1)                      # (B, T-1, H, W, K)
        labels = batch["masks"][:, 1:].argmax(dim=2)         # (B, T-1, H, W)
        if rows is not None:
            probs_cl = all_gather_rows(probs_cl, rows, "loss gather")
            labels = all_gather_rows(labels.to(torch.int32), rows, "loss gather").long()
        log_probs = torch.log(probs_cl.clamp(min=1e-30))
        loss = lovasz_loss(probs_cl, labels, ignore) + nll_loss(log_probs, labels, ignore)
        return (loss, bn) if apply.train_bn else loss

    def tfn_loss(batch):
        frames, flows = batch["frames"], batch["flows"]
        if hybrid:  # the rank's columns of the flows -> the whole width
            space = width_mesh(mesh.space, *frames.shape[2:4], TFN_CELL)
            with space.installed(tflownet):
                est = tflownet.video_forward(frames)
            est = space.gather_unpadded(est.movedim(-1, 2), "loss gather",
                                        summed=False).movedim(2, -1)
        else:
            est = tflownet.video_forward(frames)
        if rows is not None:
            est = all_gather_rows(est, rows, "loss gather")
            flows = all_gather_rows(flows, rows, "loss gather")
        return l1_loss(est, flows)

    return rmnet_loss if network == "RMNet" else tfn_loss


def make_train_step(cfg, apply: RMNetApply, tflownet: TinyFlowNet,
                    optimizer: torch.optim.Optimizer, mesh=None) -> Callable:
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
    update, only when the loss is finite.

    With a ``mesh`` the batch is the rank's rows (:func:`shard_batch`, the
    micro-batches' layout): each micro-batch's loss is that of the ranks'
    rows together, and the gradients are summed over the ranks once, after
    the last micro-batch, before the division by n. A HybridMesh's batch is
    the rank's rows from ``hybrid_shard_batch``, and the gradients are
    summed over every rank of the grid.

    With the profiling recorder on, host spans ``train.forward``,
    ``train.backward`` (once a micro-batch), ``train.loss_read`` (the
    ``.item()`` wait) and ``train.optimizer``, of request ``req`` (default a
    new one), and device phases ``train.forward`` and ``train.backward`` at
    the same boundaries."""
    loss_fn = make_loss_fn(cfg, apply, tflownet, mesh=mesh)
    grad_mesh = mesh.world if isinstance(mesh, HybridMesh) else mesh
    accum = int(cfg.TRAIN.GRAD_ACCUM_STEPS)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    train_bn = cfg.TRAIN.NETWORK == "RMNet" and apply.train_bn

    def step(batch, lr: float, req: Optional[int] = None) -> float:
        req = new_request() if req is None else req
        dev = batch["frames"].device
        optimizer.zero_grad(set_to_none=True)
        B = batch["frames"].shape[0]
        if B % accum:
            raise ValueError(f"TRAIN.GRAD_ACCUM_STEPS={accum} must divide the batch size "
                             f"(got B={B})")
        losses = []
        bn = apply.running_stats() if train_bn else None
        for i in range(accum):
            with span("train.forward", req):
                phase(None, dev)
                micro = slice(i * B // accum, (i + 1) * B // accum)
                micro_batch = {k: v[micro] for k, v in batch.items()}
                if train_bn:
                    loss, bn = loss_fn(micro_batch, bn)
                else:
                    loss = loss_fn(micro_batch)
                phase("train.forward", dev)
            with span("train.backward", req):
                loss.backward()
                phase("train.backward", dev)
            losses.append(loss.detach())
        if grad_mesh is not None:
            all_reduce_grads(params, grad_mesh)
        if accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum)
        with span("train.loss_read", req):
            value = torch.stack(losses).mean().item()
        with span("train.optimizer", req):
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
    TRAIN.NETWORK selects, and its train step; under TRAIN.DATA_PARALLEL,
    one rank of the mesh."""

    def __init__(self, cfg, rmnet_state: Mapping[str, torch.Tensor],
                 tflownet_state: Mapping[str, torch.Tensor], device=None, mesh=None):
        """``device=None`` means the card (the mesh's device with a
        ``mesh``); there is no fallback to the CPU. At TRAIN.DATA_PARALLEL =
        n > 1 ``mesh`` is the rank's (:func:`train_net` makes it), and every
        rank starts from rank 0's parameters and running statistics. A
        HybridMesh trains either network on its grid, whose "data" ranks
        are TRAIN.DATA_PARALLEL."""
        check_train_flags(cfg)
        n = cfg.TRAIN.DATA_PARALLEL
        hybrid = isinstance(mesh, HybridMesh)
        rows = mesh.data if hybrid else mesh
        if (1 if rows is None else rows.size) != n:
            raise ValueError(f"TRAIN.DATA_PARALLEL={n} needs a mesh of {n} ranks, got "
                             f"{'none' if rows is None else rows.size}; train_net starts them")
        self.device = _device(device if device is not None or mesh is None else mesh.device)
        self.cfg, self.mesh = cfg, mesh
        world = mesh.world if hybrid else mesh
        # eval() mode (BatchNorm frozen unless train_bn), every parameter
        # trainable, float32 masters
        compute = torch.bfloat16 if cfg.TRAIN.BF16 else None
        self.rmnet = _on_device(functools.partial(RMNet, compute), rmnet_state, self.device,
                                torch.float32).requires_grad_(True)
        self.tflownet = _on_device(functools.partial(TinyFlowNet, compute), tflownet_state,
                                   self.device, torch.float32).requires_grad_(True)
        if world is not None:
            broadcast_tensors([*self.rmnet.state_dict().values(),
                               *self.tflownet.state_dict().values()], world, "parameters")
        self.apply = RMNetApply(self.rmnet, memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                                use_flash_attention=cfg.TRAIN.FLASH_ATTENTION,
                                train_bn=cfg.TRAIN.USE_BATCH_NORM, mesh=world)
        net = self.rmnet if cfg.TRAIN.NETWORK == "RMNet" else self.tflownet
        self.optimizer = make_optimizer(cfg, net.parameters())
        self._step = make_train_step(cfg, self.apply, self.tflownet, self.optimizer, mesh)

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """numpy arrays or tensors -> tensors on the trainer's device, masks
        as float32 there (n_objects stays on the host: it only sets
        per-frame flags). With a mesh, ``batch`` is the global batch and
        the result the rank's rows of it (:func:`shard_batch`,
        :func:`hybrid_shard_batch`)."""
        accum = self.cfg.TRAIN.GRAD_ACCUM_STEPS
        if isinstance(self.mesh, HybridMesh):
            batch = hybrid_shard_batch(batch, self.mesh, accum)
        elif self.mesh is not None:
            batch = shard_batch(batch, self.mesh, accum)
        out = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
               if k != "n_objects"}
        if "masks" in out:
            out["masks"] = out["masks"].float()
        out["n_objects"] = torch.as_tensor(batch["n_objects"]).cpu()
        return out

    def train_step(self, batch: Mapping, lr: Optional[float] = None) -> float:
        """One step on ``batch`` (with a mesh: the global batch) at ``lr``
        (default TRAIN.LEARNING_RATE) -> the loss. With the profiling
        recorder on, one request: ``train.upload`` and the step's spans
        (:func:`make_train_step`)."""
        lr = self.cfg.TRAIN.LEARNING_RATE if lr is None else lr
        req = new_request()
        with span("train.upload", req):
            batch = self.to_device(batch)
        return self._step(batch, lr, req)

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


def train_net(cfg, device=None, stats: Optional[TrainStats] = None, *, devices=None,
              backend: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Metrics]:
    """Train TRAIN.NETWORK for TRAIN.N_EPOCHS epochs, validating after each
    -> the best Metrics (None when no epoch ran). On the card unless
    ``device`` says otherwise; ``stats``, when given, is filled in.

    At TRAIN.DATA_PARALLEL = n > 1 it trains on n ranks: inside a
    ``torchrun`` world of n processes this process is its rank (another
    world size raises); otherwise it starts n rank processes itself
    (``launch``), on ``devices`` (default: ``cuda:0`` .. ``cuda:n-1``, or n
    times the CPU when ``device`` is the CPU) over ``backend`` (default:
    NCCL for one card per rank, else gloo), with this process's ``random``
    state and TF32 settings, returns rank 0's best Metrics and fills
    ``stats`` with rank 0's. A rank waits at most ``timeout_s`` in
    a collective (the others wait there while rank 0 validates); a rank
    that fails stops them all and raises here."""
    check_train_flags(cfg)
    stats = TrainStats() if stats is None else stats
    n = cfg.TRAIN.DATA_PARALLEL
    if n == 1:
        return _train(cfg, _device(device), stats, None)
    if "WORLD_SIZE" in os.environ:  # torchrun's world
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != n:
            raise ValueError(f"TRAIN.DATA_PARALLEL={n} inside a torchrun world of {world}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        devices = mesh_devices(n, device, devices)
        mesh = init_mesh(rank, n, "env://", backend or default_backend(devices),
                         devices[local % len(devices)], timeout_s)
        try:
            return _train(cfg, mesh.device, stats, mesh)
        finally:
            mesh.close()
    devices = mesh_devices(n, device, devices)
    if any(d.type == "cuda" for d in devices):
        # the ranks find the kernels built and do not race on the build directory
        for lib in (LIBRARY, BWD_LIBRARY):
            lib.build()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    results = launch(_train_rank, (cfg, random.getstate(), tf32), devices,
                     backend or default_backend(devices), timeout_s)
    best, rank0_stats = results[0]
    for f in dataclasses.fields(TrainStats):
        setattr(stats, f.name, getattr(rank0_stats, f.name))
    return best


def _train_rank(mesh: DataMesh, cfg, random_state,
                tf32) -> Tuple[Optional[Metrics], TrainStats]:
    """One rank of train_net, with the caller's ``random`` state (the
    frame-step curriculum draws from it on rank 0) and TF32 settings
    (matmuls, cuDNN)."""
    random.setstate(random_state)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    stats = TrainStats()
    return _train(cfg, mesh.device, stats, mesh), stats


class _NoWriter:
    """The summary writer of a rank that is not rank 0."""

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _global_batches(train_loader, mesh: Optional[DataMesh]):
    """The epoch's batches as dicts; over a mesh rank 0 draws them from
    ``train_loader`` and broadcasts each (a header of shapes, then one
    bucket per dtype: frames and flows float32, masks uint8, n_objects
    int64), the other ranks receive them, and an all-zero header ends the
    epoch. A consumer that stops early (a stop request, agreed on by every
    rank) ends the epoch on every rank alike."""
    loader = iter(train_loader) if train_loader is not None else None
    try:
        if mesh is None:
            for _, n_objects, frames, masks, flows in loader:
                yield {"frames": frames, "masks": masks, "flows": flows,
                       "n_objects": n_objects}
            return
        dev = mesh.comm_device
        header = torch.zeros(6, dtype=torch.int64, device=dev)  # B, T, H, W, K, more
        while True:
            if mesh.rank == 0:
                item = next(loader, None)
                header.zero_()
                if item is not None:
                    _, n_objects, frames, masks, flows = item
                    batch = {"frames": torch.as_tensor(frames, dtype=torch.float32),
                             "masks": torch.as_tensor(masks).to(torch.uint8),
                             "flows": torch.as_tensor(flows, dtype=torch.float32),
                             "n_objects": torch.as_tensor(n_objects, dtype=torch.int64)}
                    batch = {k: v.to(dev) for k, v in batch.items()}
                    B, T, K, H, W = batch["masks"].shape
                    header.copy_(torch.tensor([B, T, H, W, K, 1]))
            mesh.broadcast_(header, "batch")
            B, T, H, W, K, more = header.tolist()
            if not more:
                return
            if mesh.rank != 0:
                batch = {"frames": torch.empty(B, T, H, W, 3, device=dev),
                         "masks": torch.empty(B, T, K, H, W, dtype=torch.uint8, device=dev),
                         "flows": torch.empty(B, T, H, W, 2, device=dev),
                         "n_objects": torch.empty(B, T, dtype=torch.int64, device=dev)}
            broadcast_tensors(batch.values(), mesh, "batch")
            yield batch
    finally:  # the loader's threads stop when the epoch ends early
        if loader is not None:
            loader.close()


def _train(cfg, device: torch.device, stats: TrainStats,
           mesh: Optional[DataMesh]) -> Optional[Metrics]:
    """train_net on this process's device, alone or as a rank of ``mesh``."""
    lead = mesh is None or mesh.rank == 0
    train_loader = val_loader = None
    if lead:
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

    # every rank loads the checkpoint: the Adam state too
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
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        os.makedirs(snap_dir, exist_ok=True)
        _snapshot_code(os.path.join(snap_dir, f"{cfg.CONST.EXP_NAME}.zip"), cfg)

    trainer = Trainer(cfg, rm_state, tfn_state, device, mesh)
    if opt_state is not None:
        trainer.optimizer.load_state_dict(opt_state)

    def save(name, epoch, metrics):
        path = save_checkpoint(ckpt_dir, name, *trainer.state_dicts(), epoch_index=epoch,
                               best_metrics=None if metrics is None else metrics.state_dict(),
                               optimizer=trainer.optimizer.state_dict())
        logging.info("Saved checkpoint to %s ...", path)

    def stop_requested():  # the same answer on every rank
        return stop.is_set() if mesh is None else any_rank(stop.is_set(), mesh)

    metrics_threshold = Metrics(cfg.TEST.MAIN_METRIC_NAME,
                                [cfg.TRAIN.CKPT_SAVE_THRESHOLD] * len(Metrics.names()))
    n_batches = len(train_loader) if lead else 0
    last_keep_epoch = -cfg.TRAIN.N_EPOCHS
    val_engine = None  # one engine; each epoch swaps its weights
    train_writer = SummaryWriter(log_dir, "train") if lead else _NoWriter()
    val_writer = SummaryWriter(log_dir, "test") if lead else _NoWriter()
    with stop_on_signals("finishing the batch, then checkpointing") as stop, \
            contextlib.closing(train_writer), \
            contextlib.closing(val_writer):
        for epoch_idx in range(init_epoch + 1, cfg.TRAIN.N_EPOCHS + 1):
            epoch_start = time.time()
            batch_time, data_time, losses = AverageMeter(), AverageMeter(), AverageMeter()

            # the frame-step curriculum on the global random (reference
            # core/train.py:146-157)
            if lead and cfg.TRAIN.USE_RANDOM_FRAME_STEPS:
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
            n_drawn, n_updated, stopped = 0, 0, False
            batch_end = time.time()
            with contextlib.closing(_global_batches(train_loader, mesh)) as batches:
                for batch_idx, batch in enumerate(batches):
                    n_itr = (epoch_idx - 1) * n_batches + batch_idx
                    data_time.update(time.time() - batch_end)
                    n_drawn += 1
                    stats.batches += 1
                    try:
                        loss = trainer.train_step(batch, lr)
                    except torch.AcceleratorError:  # a CUDA fault poisons the context
                        raise
                    except Exception as ex:  # skip the batch (reference core/train.py:187-189)
                        if mesh is not None:  # the other ranks would wait in a collective
                            raise
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
                    stopped = stop_requested()
                    if stopped:
                        break
            if n_drawn and not n_updated:
                raise RuntimeError(f"epoch {epoch_idx}: all {n_drawn} batches were skipped "
                                   f"({stats})")

            if stopped or stop_requested():
                # the epoch is incomplete: a resumed run repeats it
                if lead:
                    save("ckpt-interrupt", epoch_idx - 1, best_metrics)
                    logging.warning("Stopped in epoch %d; resume with --weights %s", epoch_idx,
                                    os.path.join(ckpt_dir, "ckpt-interrupt.pth"))
                if mesh is not None:
                    barrier(mesh)
                break

            if lead:
                train_writer.add_scalar("Loss/Epoch", losses.avg(), epoch_idx)
                logging.log(
                    logging.WARNING if stats.skipped or stats.non_finite else logging.INFO,
                    "[Epoch %d/%d] EpochTime = %.3f (s) Loss = %.4f; skipped batches = %d, "
                    "non-finite losses = %d (this run)", epoch_idx, cfg.TRAIN.N_EPOCHS,
                    time.time() - epoch_start, losses.avg(), stats.skipped, stats.non_finite)
                val_engine, best_metrics, last_keep_epoch = _validate(
                    cfg, epoch_idx, trainer, val_engine, val_loader, val_writer, stats, save,
                    metrics_threshold, best_metrics, last_keep_epoch)
            if mesh is not None:  # the other ranks wait for the validation
                barrier(mesh)
    return best_metrics


def _validate(cfg, epoch_idx, trainer, val_engine, val_loader, val_writer, stats, save,
              metrics_threshold, best_metrics, last_keep_epoch):
    """The epoch's validation on one engine whose weights are swapped each
    epoch, and the gated checkpoints -> (the engine, the best Metrics, the
    last epoch that kept the frame steps)."""
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
    return val_engine, best_metrics, last_keep_epoch


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
