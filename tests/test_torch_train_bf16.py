"""TRAIN.BF16 through the port against the JAX package's bfloat16 training,
on the CPU.

The JAX package trains in bf16 with flax's ``dtype`` (RMNet(dtype=bf16),
rmnet_tpu/core/engine.py:739): float32 parameters, every conv cast to bf16
(input, weight and bias), BatchNorm in its input's dtype, the key/value bank
in the heads' dtype, masks, estimate, soft aggregation and losses in
float32. The port's Trainer keeps float32 parameters and sets every conv's
compute dtype to bf16 (models/layers.py).

* One step's loss and per-tensor RMNet gradients against
  ``jax.value_and_grad`` of the JAX package's loss with ``dtype=bf16``, at
  the step geometry of tests/test_torch_train.py (B=1, T=3, K=3, 48x64,
  object 2 revealed at t=2), through the port's flash read (the plain
  versions of both kernels) and its dense read; the JAX package reads
  densely. Tolerances: the two bf16 paths round in different places (the
  JAX read rounds P to bf16, cuDNN-style convolutions and BatchNorm
  accumulate in float32 where XLA's CPU bf16 ops may not, bias gradients
  are sums over thousands of bf16 pixels), so they differ by bf16's own
  rounding: measured, the port's gradient differs from JAX's by a median
  of 2.9% of each tensor's largest magnitude and by 19.9% at worst
  (decoder.RF2.ResMM.conv2.bias), where the JAX bf16 gradient differs from
  the float32 one by a median of 3.2% and 19.2% at worst. Held: the loss
  within 5e-3 relative (measured 2.2e-3), every tensor within 0.25 of its
  largest JAX magnitude, the median over tensors within 0.05.
* A dtype audit of one Trainer step (the counterpart of
  tests/test_bf16_dtypes.py): every convolution, forward and backward,
  bf16 x bf16; both reads (the forward and the backward of the flash read)
  get bf16 keys, values and queries, and return bf16; soft aggregation
  returns float32 and the losses take float32; parameters, gradients and
  Adam's moments are float32.
* ``train_net`` with TRAIN.BF16 on the synthetic tree: finite losses and a
  float32 checkpoint that moved.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import train as jax_train
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet, RMNetApply as JaxApply
from rmnet_tpu.models.torch_import import import_state_dict

import rmnet_tpu_torch.models.rmnet as port_rmnet
import rmnet_tpu_torch.ops.flash_attention as port_flash
import rmnet_tpu_torch.train as port_train
from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.models.layers import set_compute_dtype
from rmnet_tpu_torch.models.rmnet import RMNetApply
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.train import Trainer, make_loss_fn, train_net
from rmnet_tpu_torch.utils.checkpoint import load_weights_auto

from tests.test_torch_engine import _jax_variables
from tests.test_torch_train import LOOSE, _clip, _flat
from tests.test_torch_train_net import _ckpt_dir, _configure, _drop_checkpoints, files  # noqa: F401

torch.set_num_threads(2)

LOSS_RTOL = 5e-3
TENSOR_TOL = 0.25     # of each tensor's largest JAX magnitude
MEDIAN_TOL = 0.05     # the median over tensors of the same


@pytest.fixture(scope="module")
def jax_bf16():
    """The port's seeded weights (non-trivial frozen BN statistics), the
    clip, and the JAX package's bf16 loss and gradients on them."""
    rmnet, tfn = build_models(seed=0, device="cpu")
    for m in rmnet.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            g = torch.Generator().manual_seed(m.num_features)
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.8, 1.4, generator=g)
    model = JaxRMNet(dtype=jnp.bfloat16)
    rm_vars = _jax_variables(model, rmnet.state_dict(), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    batch = _clip()
    cfg = JaxConfig()
    cfg.TRAIN.BF16 = True
    apply = JaxApply(model, memorize_every=cfg.TRAIN.MEMORIZE_EVERY, n_bbox_loose_pixels=LOOSE)
    loss_fn = jax_train.make_loss_fn(cfg, apply, None, remat="none")
    extra = {k: v for k, v in rm_vars.items() if k != "params"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(lambda p: loss_fn(p, extra, jbatch)[0])(
        rm_vars["params"])
    flat_j = {k: np.asarray(v, np.float32) for k, v in _flat(grads_j).items()}
    return rmnet, tfn, rm_vars, batch, float(loss_j), flat_j


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_bf16_step_matches_jax(jax_bf16, flash):
    rmnet, tfn, rm_vars, batch, loss_j, flat_j = jax_bf16
    cfg = Config()
    cfg.TRAIN.BF16, cfg.TRAIN.FLASH_ATTENTION = True, flash
    set_compute_dtype(rmnet, torch.bfloat16)
    try:
        apply = RMNetApply(rmnet, memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                           n_bbox_loose_pixels=LOOSE, use_flash_attention=flash)
        rmnet.zero_grad(set_to_none=True)
        loss = make_loss_fn(cfg, apply, tfn, "none")(
            {k: torch.as_tensor(v) for k, v in batch.items()})
        loss.backward()
    finally:
        set_compute_dtype(rmnet, None)
    assert loss.dtype == torch.float32
    assert abs(loss.item() - loss_j) <= LOSS_RTOL * abs(loss_j)

    grad_sd = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
               for name, p in rmnet.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grad_sd.values())
    for name, b in rmnet.state_dict().items():  # BN statistics: no gradient
        grad_sd.setdefault(name, torch.zeros_like(b) if b.is_floating_point() else b)
    tree, missing = import_state_dict(jax.tree_util.tree_map(np.zeros_like, rm_vars), grad_sd,
                                      "reference")
    assert not missing
    flat_t = _flat(tree["params"])
    assert set(flat_t) == set(flat_j)
    rel = {}
    for name, gj in flat_j.items():
        peak = np.abs(gj).max()
        assert peak > 0, name
        rel[name] = float(np.abs(flat_t[name] - gj).max() / peak)
    bad = {k: v for k, v in rel.items() if v > TENSOR_TOL}
    assert not bad, bad
    assert np.median(list(rel.values())) <= MEDIAN_TOL


class _ConvDtypes(TorchDispatchMode):
    """The operand dtypes of every convolution, forward and backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = {torch.ops.aten.convolution.default: "fwd",
                torch.ops.aten.convolution_backward.default: "bwd"}.get(func)
        if kind is not None:
            self.seen.append((kind, tuple(a.dtype for a in args[:3] if torch.is_tensor(a))))
        return func(*args, **(kwargs or {}))


def test_bf16_dtype_audit(jax_bf16, monkeypatch):
    rmnet, tfn, _, batch, _, _ = jax_bf16
    cfg = Config()
    cfg.TRAIN.BF16 = True
    trainer = Trainer(cfg, rmnet.state_dict(), tfn.state_dict(), device="cpu")
    seen = {"read": [], "read_bwd": [], "agg": [], "loss": []}

    def spy(mod, name, key, record):
        real = getattr(mod, name)

        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            seen[key].append(record(args, out))
            return out
        monkeypatch.setattr(mod, name, call)

    spy(port_rmnet, "flash_memory_read", "read",
        lambda a, out: tuple(t.dtype for t in a[:3]) + (out[0].dtype,))
    spy(port_flash, "flash_read_bwd_reference", "read_bwd",
        lambda a, out: tuple(t.dtype for t in a[:3]) + (a[6].dtype,))
    spy(port_rmnet, "soft_aggregation", "agg", lambda a, out: out.dtype)
    for name in ("lovasz_loss", "nll_loss"):
        spy(port_train, name, "loss", lambda a, out: (a[0].dtype, out.dtype))

    with _ConvDtypes() as convs:
        loss = trainer.train_step(batch)
    assert np.isfinite(loss)
    fwd = [d for kind, d in convs.seen if kind == "fwd"]
    bwd = [d for kind, d in convs.seen if kind == "bwd"]
    # two ResNet-50s per frame, the heads and the decoder: 380 forward (the
    # encoders recomputed under REMAT "encoders") and 208 backward
    assert len(fwd) > 300 and len(bwd) > 200
    leaks = [d for d in fwd + bwd if set(d) != {torch.bfloat16}]
    assert not leaks, leaks[:5]
    bf16 = torch.bfloat16
    T = batch["frames"].shape[1]
    assert seen["read"] == [(bf16,) * 4] * (T - 1)
    assert seen["read_bwd"] == [(bf16,) * 4] * (T - 1)  # keys, values, queries, d_out
    assert seen["agg"] == [torch.float32] * (T - 1)
    assert seen["loss"] == [(torch.float32, torch.float32)] * 2
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in trainer.rmnet.parameters())
    moments = [v for s in trainer.optimizer.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(list(trainer.rmnet.parameters()))
    assert all(v.dtype == torch.float32 for v in moments)
    assert all(b.dtype == torch.float32 for b in trainer.rmnet.buffers() if b.is_floating_point())


def test_train_net_bf16(files, tmp_path):  # noqa: F811
    cfg = _configure(Config(), files, tmp_path, BF16=True)
    losses = []
    real = port_train.SummaryWriter.add_scalar

    def add_scalar(self, tag, value, step=None):
        if tag == "Loss/Batch":
            losses.append(float(value))
        return real(self, tag, value, step)

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        mp.setattr(port_train.SummaryWriter, "add_scalar", add_scalar)
        best = train_net(cfg, device="cpu")
    assert best is not None and len(losses) == 2 and all(np.isfinite(losses))
    rm_sd, tfn_sd, extras = load_weights_auto(os.path.join(_ckpt_dir(cfg), "ckpt-best.pth"))
    tensors = list(rm_sd.values()) + list(tfn_sd.values())
    assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    moments = [v for s in extras["optimizer"]["state"].values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    init = files["states"][0]
    moved = [k for k, v in rm_sd.items() if k.endswith("weight") and not torch.equal(v, init[k])]
    assert len(moved) > 100
