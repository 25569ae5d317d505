"""Training losses: Lovász-Softmax, NLL, L1, top-k focal NLL (counterpart of
rmnet_tpu/ops/losses.py; reference models/lovasz_loss.py and torch.nn).

Channels last, as in the JAX package: probabilities (..., C), labels (...).
Void pixels (``ignore_index``) are not gathered out (that would be a
data-dependent shape); their errors and foreground flags are forced to 0,
so they sort to the tail and add exactly 0 to the Lovász dot product, the
reference's result. The reference detaches the Lovász-grad vector
(models/lovasz_loss.py:48): here it is computed from the sorted foreground
flags, which carry no gradient, and autograd through ``torch.sort`` scatters
it back to pixel order, the gradient of the JAX package's custom VJP.
"""

from __future__ import annotations

import torch


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors (Alg. 1), along
    the last axis."""
    gts = fg_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(dim=-1)
    union = gts + (1.0 - fg_sorted).cumsum(dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_loss(probs: torch.Tensor, labels: torch.Tensor,
                ignore_index: int = 255) -> torch.Tensor:
    """Multi-class Lovász-Softmax: probs (..., C) in [0, 1], labels (...) in
    [0, C-1] or ``ignore_index`` -> scalar, the mean over the classes
    present in ``labels`` (0 when none is)."""
    C = probs.shape[-1]
    flat_p = probs.reshape(-1, C).float().t()        # (C, N)
    flat_l = labels.reshape(-1)
    valid = flat_l != ignore_index
    classes = torch.arange(C, device=flat_l.device)[:, None]
    fg = ((flat_l[None] == classes) & valid[None]).float()  # (C, N)
    errors = torch.where(valid[None], (fg - flat_p).abs(), torch.zeros_like(flat_p))
    # stable descending sort: ties keep pixel order, as the JAX keyed sort
    errors_sorted, perm = torch.sort(errors, dim=1, descending=True, stable=True)
    g = _lovasz_grad(torch.gather(fg, 1, perm))
    present = fg.sum(dim=1) > 0
    per_class = torch.where(present, (errors_sorted * g).sum(dim=1),
                            torch.zeros_like(errors_sorted[:, 0]))
    n_present = present.sum()
    return per_class.sum() / n_present.clamp(min=1)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """torch.nn.NLLLoss parity, channels last: mean of -log_probs[label]
    over the pixels that are not ``ignore_index``."""
    C = log_probs.shape[-1]
    flat_lp = log_probs.reshape(-1, C)
    flat_l = labels.reshape(-1)
    valid = flat_l != ignore_index
    onehot = (flat_l[:, None] == torch.arange(C, device=flat_l.device)[None]) & valid[:, None]
    # select, not multiply: a -inf in a column that is not the label stays out
    losses = -torch.where(onehot, flat_lp, torch.zeros_like(flat_lp)).sum(dim=-1)
    return losses.sum() / valid.sum().clamp(min=1)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.L1Loss parity: mean absolute error."""
    return (pred - target).abs().mean()


def focal_loss(log_probs: torch.Tensor, labels: torch.Tensor, top_k: float,
               ignore_index: int = 255, step_percent: float = 0.0) -> torch.Tensor:
    """Top-k (OHEM-like) NLL (rmnet_tpu/ops/losses.py:150-180, reference
    models/focal_loss.py:12-31): log_probs (B, N, H, W, K) channels last,
    labels (B, N, H, W) -> the mean of each frame's ``n`` largest per-pixel
    NLLs, ``n = step_percent * top_k * H*W + (1 - step_percent) * H*W``
    (``step_percent`` capped at 1). Ignored pixels have NLL 0."""
    B, N, H, W, K = log_probs.shape
    step_percent = min(float(step_percent), 1.0)
    flat_lp = log_probs.reshape(B * N, H * W, K)
    flat_l = labels.reshape(B * N, H * W)
    valid = flat_l != ignore_index
    safe_l = torch.where(valid, flat_l, torch.zeros_like(flat_l)).long()
    picked = torch.gather(flat_lp, -1, safe_l[..., None])[..., 0]
    nll = torch.where(valid, -picked, torch.zeros_like(picked))
    n_pixels = H * W
    n_top_k = int(step_percent * top_k * n_pixels + (1 - step_percent) * n_pixels)
    n_top_k = max(min(n_top_k, n_pixels), 1)
    return torch.topk(nll, n_top_k, dim=-1).values.mean()
