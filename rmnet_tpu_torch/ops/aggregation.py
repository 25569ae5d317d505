"""Soft aggregation of per-object fg probabilities into K-slot logits
(counterpart of rmnet_tpu/ops/aggregation.py; reference
models/rmnet.py:289-302).

Background slot 0 gets ``prod_k (1 - p_k)`` over valid object slots, valid
slots keep their probability, invalid slots get 0; everything is clamped to
[1e-7, 1 - 1e-7] and mapped through ``log(p / (1 - p))``.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def soft_aggregation(ps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ps (B, K, H, W) fg probabilities (slot 0 ignored), valid (B, K) bool
    -> (B, K, H, W) float32 logits. Always float32: the 1 - 1e-7 clamp is
    unrepresentable in bfloat16."""
    ps = ps.float()
    v = valid[:, :, None, None]
    bg = torch.where(v, 1.0 - ps, torch.ones_like(ps)).prod(dim=1)  # (B, H, W)
    em = torch.where(v, ps, torch.zeros_like(ps))
    em = torch.cat([bg[:, None], em[:, 1:]], dim=1)
    em = em.clamp(EPS, 1.0 - EPS)
    return torch.log(em / (1.0 - em))
