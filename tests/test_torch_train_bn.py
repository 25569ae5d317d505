"""TRAIN.USE_BATCH_NORM (trainable BatchNorm) through the port against the
JAX package's, on the CPU, in float32.

The JAX package normalizes the two encoders with batch statistics and
threads their running statistics through its scan as values: the memory
encoder's at each frame's memorize, then the query encoder's at its segment
(rmnet_tpu/models/rmnet.py:411-430, 921-984), from micro-batch to
micro-batch under GRAD_ACCUM_STEPS, and into the variables only when the
loss is finite (rmnet_tpu/core/train.py:148-199). The port does the same
with ``RMNetApply.train_bn`` (models/layers.py: the statistics go in and out
of each encoder call; nothing is written during the forward).

Weights: the port's seeded init with non-trivial running statistics,
imported into the JAX package. Batch: B=2 clips at the step geometry of
tests/test_torch_train.py (T=3, K=3, 48x64, object 2 revealed at t=2; the
second clip's frames are other noise).

Tolerances. One BatchNorm layer on its own agrees with the JAX one to float32
rounding (output, input and parameter gradients, new statistics: 1e-5; in
bfloat16, where the JAX layer computes in bf16 and torch's in float32, 3e-2
of the largest magnitude). Through the network it does not: normalizing
every layer by its batch's statistics, and projecting the batch's mean and
scale out of each gradient, amplifies float32 rounding, so that the
packages' estimates differ by 1.7e-3 at t=1 and 9.4e-2 at t=2, their
running statistics by 8e-4 of a tensor's largest value and their Adam
updates by 0.61 of the update's norm (measured). The same amplification
shows when only the port's BatchNorm arithmetic changes: against a run whose
BatchNorms compute in float64 the port's float32 run differs by 4.7e-4 /
1.4e-2 (estimate at t=1 / t=2), 1e-4 (statistics) and 0.40 (update), and
the JAX package's by 1.4e-3 / 8.2e-2, 7.6e-4 and 0.56: the JAX variance
E[x^2] - mean^2 loses more to cancellation than torch's. So the test holds
the port to JAX at the measured level (estimate at t=1 5e-3, statistics
2e-3 of each tensor's largest value, update 0.8 of its norm, loss 1e-5),
and to the float64 run at least as closely as the JAX package is.
REMAT "none", "encoders" and "step" give bit-identical statistics (a
recompute writes nothing).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import train as jax_train
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet, RMNetApply as JaxApply
from rmnet_tpu.nn.layers import BatchNorm2d as JaxBatchNorm2d

import rmnet_tpu_torch.train as port_train
from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.models.layers import BatchNorm2d
from rmnet_tpu_torch.models.rmnet import RMNetApply
from rmnet_tpu_torch.models.weights import build_models, from_jax_variables
from rmnet_tpu_torch.train import Trainer, make_optimizer, make_train_step, train_net
from rmnet_tpu_torch.utils.checkpoint import load_weights_auto

from tests.test_torch_engine import _jax_variables
from tests.test_torch_train import _clip
from tests.test_torch_train_net import _ckpt_dir, _configure, _drop_checkpoints, files  # noqa: F401

torch.set_num_threads(2)

LR = 1e-3
EST_T1_TOL = 5e-3    # the estimate at t=1 against JAX's
STATS_REL = 2e-3     # each running statistic against JAX's, of its largest value
UPDATE_REL = 0.8     # the Adam update against JAX's, of its norm


def _batch():
    c = _clip()
    second = dict(c, frames=np.random.RandomState(11).rand(*c["frames"].shape)
                  .astype(np.float32) * 2 - 1)
    return {k: np.concatenate([c[k], second[k]]) for k in c}


def _stats(bn_tree):
    """A JAX batch_stats tree -> the running statistics by port name."""
    sd, _ = from_jax_variables({"batch_stats": bn_tree}, {})
    return {k: v for k, v in sd.items() if ".running_" in k}


def _cfg(**train):
    cfg = Config()
    cfg.TRAIN.USE_BATCH_NORM, cfg.TRAIN.REMAT, cfg.TRAIN.LEARNING_RATE = True, "none", LR
    for k, v in train.items():
        setattr(cfg.TRAIN, k, v)
    return cfg


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _micro(batch, i):
    return {k: v[i:i + 1] for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """Weights, batch, and the JAX package's results: forward_video with
    train_bn on the batch, and on its two halves in turn (the statistics
    threaded from the first to the second, as the accumulating step's scan
    carries them), and one make_train_step step."""
    rmnet, tfn = build_models(seed=0, device="cpu")
    for m in rmnet.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            g = torch.Generator().manual_seed(m.num_features)
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.8, 1.4, generator=g)
    states = (rmnet.state_dict(), tfn.state_dict())
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    batch = _batch()
    cfg = JaxConfig()
    cfg.TRAIN.USE_BATCH_NORM = True
    apply = JaxApply(JaxRMNet(), memorize_every=cfg.TRAIN.MEMORIZE_EVERY, train_bn=True)

    def forward(variables, b):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        return apply.forward_video(variables, jb["frames"], jb["masks"], jb["flows"],
                                   jb["n_objects"])

    est, bn = forward(rm_vars, batch)
    out = dict(est=np.asarray(est), stats=_stats(bn))
    _, bn = forward(rm_vars, _micro(batch, 0))
    _, bn = forward({**rm_vars, "batch_stats": bn}, _micro(batch, 1))
    out["accum_stats"] = _stats(bn)
    opt = jax_train.make_optimizer(cfg)
    params = rm_vars["params"]
    extra = {k: v for k, v in rm_vars.items() if k != "params"}
    step = jax_train.make_train_step(cfg, apply, None, opt, remat="none")
    p = jax.tree_util.tree_map(jnp.array, params)  # the step donates its inputs
    new_p, _, new_extra, loss = step(p, opt.init(p), jax.tree_util.tree_map(jnp.array, extra),
                                     {k: jnp.asarray(v) for k, v in batch.items()}, LR)
    new_sd, _ = from_jax_variables({"params": new_p, **new_extra}, {})
    out["step"] = dict(loss=float(loss), state=new_sd, stats=_stats(new_extra["batch_stats"]))
    return states, batch, out


def _bn_float64(self, x):
    """BatchNorm2d.forward with its batch-statistics arithmetic in float64."""
    if self.batch_stats is None:
        return torch.nn.BatchNorm2d.forward(self, x)
    mean, var = (s.double() for s in self.batch_stats)
    out = F.batch_norm(x.double(), mean, var, self.weight.double(), self.bias.double(), True,
                       self.momentum, self.eps)
    self.new_stats = (mean.float(), var.float())
    return out.to(x.dtype)


@pytest.fixture(scope="module")
def float64_bn(setup):
    """The port with its BatchNorms in float64: forward_video's estimate and
    statistics, and the parameters after one step."""
    states, batch, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchNorm2d, "forward", _bn_float64)
        est, stats = _forward(states, batch)
        _, trainer = _step(states, batch)
    return dict(est=est, stats=stats, state=trainer.rmnet.state_dict())


def _forward(states, batch, flash=True):
    trainer = Trainer(_cfg(FLASH_ATTENTION=flash), *states, device="cpu")
    buffers = {k: v.clone() for k, v in trainer.apply.running_stats().items()}
    b = _port_batch(batch)
    with torch.no_grad():
        est, bn = trainer.apply.forward_video(b["frames"], b["masks"], b["flows"],
                                              b["n_objects"])
    # the module's own statistics were not written
    assert all(torch.equal(trainer.apply.running_stats()[k], v) for k, v in buffers.items())
    return est.numpy(), bn


def _step(states, batch, **train):
    """One make_train_step step of a Trainer -> (loss, trainer)."""
    trainer = Trainer(_cfg(**train), *states, device="cpu")
    loss = trainer.train_step(batch, LR)
    return loss, trainer


def _stats_err(got, want):
    """max over tensors of max |got - want| / max |want|."""
    assert set(got) == set(want) and len(want) == 2 * 43 * 2  # 43 BatchNorms per trunk
    return max(float(np.abs(got[k].detach().numpy() - v.numpy()).max()
                     / np.abs(v.numpy()).max()) for k, v in want.items())


def _update_err(new, want, init):
    """||new - want|| / ||want - init|| over RMNet's parameters."""
    diff2 = update2 = 0.0
    for k, w in want.items():
        if k.endswith(("weight", "bias")):
            diff2 += float(np.linalg.norm(new[k].numpy() - w.numpy())) ** 2
            update2 += float(np.linalg.norm(w.numpy() - init[k].numpy())) ** 2
    return (diff2 / update2) ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_norm_layer_matches_jax(dtype):
    """One BatchNorm2d on batch statistics against the JAX package's
    (use_running_average=False): output, gradients of the input, weight and
    bias, and the new running statistics."""
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 16, 6, 5) * rs.uniform(0.5, 2.0, (1, 16, 1, 1))
         + rs.randn(1, 16, 1, 1)).astype(np.float32)
    dy = rs.randn(*x.shape).astype(np.float32)
    w, b = rs.uniform(0.5, 1.5, 16).astype(np.float32), rs.randn(16).astype(np.float32) * 0.1
    mean0, var0 = rs.randn(16).astype(np.float32) * 0.1, rs.uniform(0.8, 1.2, 16).astype(np.float32)

    bn = BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    bn.batch_stats = (torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy()))
    y = bn(xt)
    new_mean, new_var = bn.new_stats
    y.backward(torch.from_numpy(dy).to(dtype))

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    variables = {"params": {"weight": w, "bias": b},
                 "batch_stats": {"running_mean": mean0, "running_var": var0}}

    def f(params, xj):
        out, mut = JaxBatchNorm2d().apply({**variables, "params": params}, xj, False,
                                          mutable=["batch_stats"])
        return out, mut["batch_stats"]

    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    yj, new_j = f(variables["params"], xj)
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0], variables["params"], xj)
    gp, gx = pull(jnp.asarray(dy.transpose(0, 2, 3, 1)).astype(jdt))

    def close(a, ref, what):
        a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
        tol = 3e-2 * np.abs(ref).max() if dtype == torch.bfloat16 else 1e-5 * max(
            1.0, np.abs(ref).max())
        assert np.abs(a - ref).max() <= tol, what

    assert y.dtype == dtype
    close(y.detach().float().numpy().transpose(0, 2, 3, 1), yj, "out")
    close(xt.grad.float().numpy().transpose(0, 2, 3, 1), gx, "d input")
    close(bn.weight.grad.numpy(), gp["weight"], "d weight")
    close(bn.bias.grad.numpy(), gp["bias"], "d bias")
    close(new_mean.numpy(), new_j["running_mean"], "running mean")
    close(new_var.numpy(), new_j["running_var"], "running var")
    # the pair it read was not written
    assert np.array_equal(bn.batch_stats[0].numpy(), mean0)
    assert np.array_equal(bn.batch_stats[1].numpy(), var0)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_forward_video_train_bn_matches_jax(setup, float64_bn, flash):
    states, batch, jax_out = setup
    est, bn = _forward(states, batch, flash)
    assert est.shape == jax_out["est"].shape
    assert np.abs(est[:, 1] - jax_out["est"][:, 1]).max() <= EST_T1_TOL
    assert _stats_err(bn, jax_out["stats"]) <= STATS_REL
    # every statistic moved
    assert all(not torch.equal(bn[k], v) for k, v in
               Trainer(_cfg(), *states, device="cpu").apply.running_stats().items())
    # no further from the float64 run than the JAX package is
    ref = float64_bn
    for t in range(1, est.shape[1]):
        assert (np.abs(est[:, t] - ref["est"][:, t]).max()
                <= np.abs(jax_out["est"][:, t] - ref["est"][:, t]).max()), t
    assert _stats_err(bn, ref["stats"]) <= _stats_err(jax_out["stats"], ref["stats"])


def test_train_step_matches_jax(setup, float64_bn):
    """One step at REMAT "none" against JAX's make_train_step: the loss,
    every running statistic (all moved), and the parameters' update."""
    states, batch, jax_out = setup
    loss, trainer = _step(states, batch)
    want = jax_out["step"]
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    new = trainer.rmnet.state_dict()
    assert _stats_err({k: new[k] for k in want["stats"]}, want["stats"]) <= STATS_REL
    assert all(not torch.equal(new[k], states[0][k]) for k in want["stats"])
    assert _update_err(new, want["state"], states[0]) <= UPDATE_REL
    ref = float64_bn["state"]
    assert _update_err(new, ref, states[0]) <= _update_err(want["state"], ref, states[0])


@pytest.mark.parametrize("remat", ["encoders", "step"])
def test_remat_modes_give_equal_statistics(setup, remat):
    """A rematerialised forward counts nothing twice: the statistics after
    one step equal REMAT "none"'s, bit for bit, and so does the loss."""
    states, batch, _ = setup
    loss_none, ref = _step(states, batch)
    loss, trainer = _step(states, batch, REMAT=remat)
    assert loss == loss_none
    got, want = trainer.apply.running_stats(), ref.apply.running_stats()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_grad_accum_threads_statistics(setup):
    """GRAD_ACCUM_STEPS = 2: the statistics go through micro-batch 1, then
    micro-batch 2, as the JAX step's scan carries them."""
    states, batch, jax_out = setup
    _, trainer = _step(states, batch, GRAD_ACCUM_STEPS=2)
    got = trainer.apply.running_stats()
    assert _stats_err(got, jax_out["accum_stats"]) <= STATS_REL
    # not the one-batch statistics
    assert _stats_err(got, jax_out["step"]["stats"]) > 10 * STATS_REL


def test_nan_batch_leaves_statistics(setup):
    """A NaN loss skips the whole update: parameters, Adam's moments and
    every running statistic stay as they were."""
    states, batch, _ = setup
    loss, trainer = _step(states, batch)  # one good step: Adam has moments
    assert np.isfinite(loss)
    before = {k: v.clone() for k, v in trainer.rmnet.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in trainer.optimizer.state.items()}
    bad = {k: v.copy() for k, v in batch.items()}
    bad["frames"][0, 1, 3, 3, 0] = np.nan
    assert not np.isfinite(trainer.train_step(bad, LR))
    after = trainer.rmnet.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    for p, s in trainer.optimizer.state.items():
        assert all(torch.equal(v, moments[id(p)][k]) for k, v in s.items())


def test_make_train_step_writes_statistics_once_per_step(setup):
    """The module's buffers hold the statistics before the step until the
    update, and the statistics after it once the step returns."""
    states, batch, _ = setup
    trainer = Trainer(_cfg(), *states, device="cpu")
    seen = []
    real = trainer.apply.load_running_stats

    def load(bn):
        seen.append({k: v.clone() for k, v in trainer.apply.running_stats().items()})
        return real(bn)

    trainer.apply.load_running_stats = load
    step = make_train_step(trainer.cfg, trainer.apply, trainer.tflownet,
                           make_optimizer(trainer.cfg, trainer.rmnet.parameters()))
    assert np.isfinite(step(_port_batch(batch), LR))
    assert len(seen) == 1
    assert all(torch.equal(seen[0][k], states[0][k]) for k in seen[0])


def test_train_net_bf16_and_batch_norm(files, tmp_path):  # noqa: F811
    """train_net with TRAIN.BF16 and TRAIN.USE_BATCH_NORM: finite losses, a
    float32 checkpoint whose running statistics moved."""
    cfg = _configure(Config(), files, tmp_path, BF16=True, USE_BATCH_NORM=True)
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
    rm_sd, _, _ = load_weights_auto(os.path.join(_ckpt_dir(cfg), "ckpt-best.pth"))
    init = files["states"][0]
    stats = [k for k in init if ".running_" in k]
    assert len(stats) == 2 * 43 * 2
    assert all(rm_sd[k].dtype == torch.float32 and not torch.equal(rm_sd[k], init[k])
               for k in stats)
    assert all(torch.isfinite(rm_sd[k]).all() for k in stats)


def test_apply_threads_memory_then_query_statistics(setup):
    """memorize updates only the memory encoder's statistics, segment only
    the query encoder's."""
    states, batch, _ = setup
    trainer = Trainer(_cfg(), *states, device="cpu")
    apply: RMNetApply = trainer.apply
    bn0 = apply.running_stats()
    b = _port_batch(batch)
    frame = b["frames"][:, 0].permute(0, 3, 1, 2)
    obj_valid = torch.tensor([[False, True, True]] * 2)
    with torch.no_grad():
        *_, bn1 = apply.memorize(frame, b["masks"][:, 0], obj_valid, bn0)
    moved = {k for k in bn0 if not torch.equal(bn0[k], bn1[k])}
    assert moved == {k for k in bn0 if k.startswith("encoder_memory.")}
