"""One training step on one GPU (counterpart of rmnet_tpu/core/train.py:54-201).

The reference objective: Lovász + NLL over frames 1..T-1 for RMNet, L1
against the batch's flows for TinyFlowNet (reference core/train.py:80-82,
174-180). The step is ``forward_video`` with backprop through time (the
block-sparse flash read and its backward kernel by default, TRAIN.
FLASH_ATTENTION), the loss, ``backward()``, and one Adam update with L2 weight
decay folded into the gradient (torch.optim.Adam is exactly the JAX
package's add_decayed_weights + scale_by_adam + ``-lr * u``). A non-finite
loss skips the whole update, moments included (reference core/train.py:
187-189). Modules train with frozen BatchNorm, in ``eval()`` mode
(TRAIN.USE_BATCH_NORM = False in the reference configuration).

Entry point: :class:`Trainer`, on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from rmnet_tpu_torch.engine import _on_device
from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.ops.losses import l1_loss, lovasz_loss, nll_loss


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """torch-Adam: L2 weight decay folds into the gradient before the moment
    updates (unlike AdamW). The learning rate is set per step."""
    return torch.optim.Adam(params, lr=cfg.TRAIN.LEARNING_RATE, betas=tuple(cfg.TRAIN.BETAS),
                            weight_decay=cfg.TRAIN.WEIGHT_DECAY)


def cosine_lr(base_lr: float, epoch: int, n_epochs: int) -> float:
    """torch CosineAnnealingLR(T_max=n_epochs) value at a given epoch."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / n_epochs))


def make_loss_fn(cfg, apply: RMNetApply, tflownet: TinyFlowNet) -> Callable:
    """The training loss of the selected network: batch -> scalar tensor.

    A batch holds frames (B, T, H, W, 3), masks (B, T, K, H, W) one-hot,
    flows (B, T, H, W, 2) and n_objects (B, T), as the JAX package's."""
    ignore = cfg.CONST.IGNORE_IDX

    def rmnet_loss(batch):
        est = apply.forward_video(batch["frames"], batch["masks"], batch["flows"],
                                  batch["n_objects"])
        probs_cl = est[:, 1:].movedim(2, -1)                 # (B, T-1, H, W, K)
        labels = batch["masks"][:, 1:].argmax(dim=2)         # (B, T-1, H, W)
        log_probs = torch.log(probs_cl.clamp(min=1e-30))
        return lovasz_loss(probs_cl, labels, ignore) + nll_loss(log_probs, labels, ignore)

    def tfn_loss(batch):
        return l1_loss(tflownet.video_forward(batch["frames"]), batch["flows"])

    network = cfg.TRAIN.NETWORK
    if network not in ("RMNet", "TinyFlowNet"):
        raise ValueError(f"unknown TRAIN.NETWORK {network!r}")
    return rmnet_loss if network == "RMNet" else tfn_loss


def make_train_step(cfg, apply: RMNetApply, tflownet: TinyFlowNet,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """-> step(batch, lr) -> loss (float): gradients of the selected
    network's loss, then one Adam update at ``lr``, skipped (moments
    included) when the loss is not finite."""
    loss_fn = make_loss_fn(cfg, apply, tflownet)

    def step(batch, lr: float) -> float:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        value = loss.item()
        if math.isfinite(value):
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
        return value

    return step


class Trainer:
    """RMNet and TinyFlowNet on one device, the optimizer of the network
    TRAIN.NETWORK selects, and its train step."""

    def __init__(self, cfg, rmnet_state: Mapping[str, torch.Tensor],
                 tflownet_state: Mapping[str, torch.Tensor], device=None):
        """``device=None`` means the card; there is no fallback to the CPU."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        # frozen BatchNorm: eval() mode, every parameter trainable
        self.rmnet = _on_device(RMNet, rmnet_state, self.device,
                                torch.float32).requires_grad_(True)
        self.tflownet = _on_device(TinyFlowNet, tflownet_state, self.device,
                                   torch.float32).requires_grad_(True)
        self.apply = RMNetApply(self.rmnet, memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                                use_flash_attention=cfg.TRAIN.FLASH_ATTENTION)
        net = self.rmnet if cfg.TRAIN.NETWORK == "RMNet" else self.tflownet
        self.optimizer = make_optimizer(cfg, net.parameters())
        self._step = make_train_step(cfg, self.apply, self.tflownet, self.optimizer)

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """numpy arrays or tensors -> tensors on the trainer's device
        (n_objects stays on the host: it only sets per-frame flags)."""
        out = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
               if k != "n_objects"}
        out["n_objects"] = torch.as_tensor(batch["n_objects"])
        return out

    def train_step(self, batch: Mapping, lr: Optional[float] = None) -> float:
        """One step on ``batch`` at ``lr`` (default TRAIN.LEARNING_RATE) ->
        the loss."""
        lr = self.cfg.TRAIN.LEARNING_RATE if lr is None else lr
        return self._step(self.to_device(batch), lr)

