"""Layers with a compute dtype, and a BatchNorm whose training mode hands
its running statistics back (counterpart of rmnet_tpu/nn/layers.py).

Compute dtype (flax's ``dtype``, rmnet_tpu/nn/layers.py:40-60): a conv
casts its input, weight and bias to ``compute_dtype`` inside its forward
and returns that dtype, so parameters keep their own dtype and autograd
carries each gradient back to it in that dtype: float32 master weights
train with bfloat16 convolutions (TRAIN.BF16). ``compute_dtype = None``
computes in the weight's dtype, as torch's layers do (the serving engine
casts whole modules).

Trainable BatchNorm (rmnet_tpu/nn/layers.py:172-183, TRAIN.USE_BATCH_NORM):
the running statistics are an input and an output of the forward, never
written in place, so that a rematerialised forward (torch.utils.checkpoint
re-runs it in the backward pass) counts nothing twice. :func:`train_batch_norm`
runs a function with every :class:`BatchNorm2d` of a module in that mode,
and, given a data-parallel mesh, on the statistics of the global batch
(rmnet_tpu/nn/layers.py:150-175 under the JAX mesh: SyncBatchNorm).

Width mesh (parallel/space.py): while ``space`` is set, a :class:`Conv2d` or
:class:`ConvTranspose2d` holds the rank's columns of the frame and convolves
them with the halo that its kernel reads from the neighbours'
(``WidthMesh.conv2d`` / ``conv_transpose2d``, whose backward hands each
halo's gradient back to its owner); frozen BatchNorm is per pixel
and needs nothing, trainable BatchNorm takes the statistics of every rank's
columns and rows (its ``mesh`` is then the hybrid grid's world).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmnet_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum

_STATS = ("running_mean", "running_var")


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``compute_dtype`` (None: the weight's); under
    a width mesh (``space``) on the rank's columns."""

    compute_dtype: Optional[torch.dtype] = None
    space = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.space is None:
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        return self.space.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                 self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in ``compute_dtype`` (None: the weight's);
    under a width mesh (``space``) on the rank's columns."""

    compute_dtype: Optional[torch.dtype] = None
    space = None
    dtype = Conv2d.dtype

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.space is None:
            return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                      self.padding, self.output_padding, self.groups,
                                      self.dilation)
        return self.space.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                           self.padding, self.output_padding, self.groups,
                                           self.dilation)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Every conv of ``module`` computes in ``dtype`` (None: its weight's)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype
    return module


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d on its running statistics (frozen, in eval mode), or,
    while ``batch_stats`` holds a (mean, var) pair, on the batch's: it
    normalizes with the input's mean and biased variance over (N, H, W),
    computed in float32, and leaves the running statistics that follow,
    ``(1 - 0.1) * old + 0.1 * batch`` with the unbiased variance
    ``n / (n - 1)``, in ``new_stats``. Neither the pair nor the module's
    buffers are written.

    While ``mesh`` is set too, the batch is the global one of the mesh's
    ranks: the per-channel sum and sum of squares (float32, or the input's
    type where it is wider) and the element count are summed over the ranks
    in one collective (its backward sums their gradients), the mean and the
    variance ``E[x^2] - mean^2`` come from them as the JAX layer takes them,
    and ``n`` is the global count, the sum of the ranks' counts (a hybrid
    grid's width shares differ), so the statistics are the same on every
    rank."""

    batch_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    new_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    mesh: Optional[DataMesh] = None

    def forward(self, x):
        if self.batch_stats is None:
            return super().forward(x)
        if self.mesh is not None:
            return self._global_batch_forward(x)
        mean, var = (s.clone() for s in self.batch_stats)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        self.new_stats = (mean, var)
        return out

    def _global_batch_forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        C = x.shape[1]
        # the rank's element count rides the same collective: width shares
        # are unequal (exact in float32 below 2^24 elements a channel)
        local = torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        sums = all_reduce_sum(local, self.mesh, "batch norm")
        n = sums[-1].detach()
        mean = sums[:C] / n
        var = sums[C:2 * C] / n - mean.square()
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m, (old_mean, old_var) = self.momentum, self.batch_stats
            self.new_stats = ((1 - m) * old_mean + m * mean,
                              (1 - m) * old_var + m * var * (n / (n - 1).clamp(min=1)))
        return out.to(x.dtype)


def batch_norms(module: nn.Module) -> List[Tuple[str, BatchNorm2d]]:
    return [(n, m) for n, m in module.named_modules() if isinstance(m, BatchNorm2d)]


def running_stats(module: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The running statistics of ``module``'s BatchNorms by state-dict name
    (``prefix`` + ``res2.0.bn1.running_mean``, ...): the buffers themselves."""
    return {f"{prefix}{n}.{s}": getattr(m, s) for n, m in batch_norms(module) for s in _STATS}


def train_batch_norm(module: nn.Module, prefix: str, stats: Dict[str, torch.Tensor], fn,
                     *args, mesh: Optional[DataMesh] = None):
    """``fn(*args)`` with every BatchNorm2d of ``module`` on batch statistics
    (the global batch's over ``mesh``, when given), its running statistics
    read from ``stats`` (named as :func:`running_stats` names them) -> (fn's
    result, a copy of ``stats`` with ``module``'s replaced by the updated
    ones)."""
    bns = batch_norms(module)
    for n, m in bns:
        m.batch_stats = tuple(stats[f"{prefix}{n}.{s}"] for s in _STATS)
        m.mesh = mesh
    try:
        out = fn(*args)
        new = dict(stats)
        for n, m in bns:
            if m.new_stats is None:
                raise RuntimeError(f"BatchNorm {prefix}{n} did not run")
            new.update(zip((f"{prefix}{n}.{s}" for s in _STATS), m.new_stats))
    finally:  # also when a checkpoint's recompute stops early by raising
        for _, m in bns:
            m.batch_stats = m.new_stats = m.mesh = None
    return out, new
