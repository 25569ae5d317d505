"""The port's training path against the JAX package's, at f32 on the CPU.

Same inputs, made with numpy from a seed, go through both packages:

* the losses (Lovász-Softmax, NLL, L1) with ignore-255 pixels: values and
  gradients at 1e-5;
* the att map's constant-ones straight-through gradient, and the fused
  warp's mask gradient against ``jax.vjp`` of
  ``warped_regional_attention_small`` at 1e-5;
* TinyFlowNet's video forward (zero flow at t=0) at 2e-4, the TinyFlowNet
  tolerance of tests/test_torch_models.py;
* one train step's loss and every RMNet parameter's gradient against
  ``jax.value_and_grad`` of the JAX package's ``make_loss_fn`` loss (dense
  read), at B=1, T=3, K=3, 48x64, with object 2 revealed at t=2. The port
  runs both its reads (the block-sparse one through the plain versions of
  both kernels). Loss at rtol 1e-5; gradients within 1e-4 relative per
  tensor, with the absolute escape of tests/test_train_grad_parity.py:149.
  Weights are the port's seeded init imported into the JAX package, and the
  gradients are mapped through the same importer;
* Adam with weight decay over three steps on fixed gradients against the
  JAX package's optimizer and its ``-lr * u`` step, ``cosine_lr``, and a
  non-finite loss that leaves parameters and moments untouched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import train as jax_train
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet, RMNetApply as JaxApply
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet
from rmnet_tpu.models.torch_import import import_state_dict
from rmnet_tpu.ops import att_map as jax_att_map
from rmnet_tpu.ops import losses as jax_losses

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.models.rmnet import RMNetApply
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.ops import losses
from rmnet_tpu_torch.ops.att_map import (regional_attention_small,
                                         warped_regional_attention_small)
from rmnet_tpu_torch.train import cosine_lr, make_loss_fn, make_optimizer, make_train_step

from tests.test_torch_engine import _jax_variables

torch.set_num_threads(2)

B, T, K, H, W = 1, 3, 3, 48, 64
LOOSE = 6
IGNORE = 255


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, shape=(2, 2, 12, 16), C=4):
    rs = np.random.RandomState(seed)
    logits = rs.randn(*shape, C).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rs.randint(0, C, size=shape).astype(np.int32)
    labels[rs.rand(*shape) < 0.1] = IGNORE
    labels[..., 0, :] = IGNORE            # a whole void row
    labels[labels == C - 1] = 0           # class C-1 absent
    return probs.astype(np.float32), labels


def _torch_value_grad(fn, x, labels):
    xt = torch.from_numpy(x).requires_grad_(True)
    value = fn(xt, torch.from_numpy(labels).long())
    value.backward()
    return value.item(), xt.grad.numpy()


@pytest.mark.parametrize("name", ["lovasz", "nll"])
def test_classification_losses_match_jax(name):
    probs, labels = _loss_inputs()
    if name == "lovasz":
        x = probs
        t_fn = lambda p, l: losses.lovasz_loss(p, l, IGNORE)  # noqa: E731
        j_fn = lambda p: jax_losses.lovasz_loss(p, jnp.asarray(labels), IGNORE)  # noqa: E731
    else:
        x = np.log(probs)
        t_fn = lambda p, l: losses.nll_loss(p, l, IGNORE)  # noqa: E731
        j_fn = lambda p: jax_losses.nll_loss(p, jnp.asarray(labels), IGNORE)  # noqa: E731
    value, grad = _torch_value_grad(t_fn, x, labels)
    value_j, grad_j = jax.value_and_grad(j_fn)(jnp.asarray(x))
    np.testing.assert_allclose(value, float(value_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, np.asarray(grad_j), rtol=1e-5, atol=1e-6)
    assert np.all(grad[labels == IGNORE] == 0)
    assert np.abs(grad).max() > 0


def test_nll_loss_is_torch_nll():
    probs, labels = _loss_inputs(seed=1)
    lp = torch.from_numpy(np.log(probs))
    lab = torch.from_numpy(labels).long()
    expect = torch.nn.functional.nll_loss(lp.movedim(-1, 1), lab, ignore_index=IGNORE)
    np.testing.assert_allclose(losses.nll_loss(lp, lab, IGNORE).item(), expect.item(), rtol=1e-6)


def test_l1_loss_matches_jax():
    rs = np.random.RandomState(2)
    pred, target = rs.randn(2, 3, 8, 8, 2).astype(np.float32), rs.randn(2, 3, 8, 8, 2).astype(np.float32)
    pt = torch.from_numpy(pred).requires_grad_(True)
    value = losses.l1_loss(pt, torch.from_numpy(target))
    value.backward()
    value_j, grad_j = jax.value_and_grad(
        lambda p: jax_losses.l1_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    np.testing.assert_allclose(value.item(), float(value_j), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-8)


# ----------------------------------------------------------------- att map
def _soft_masks(seed, Bm=2, Km=3, Hm=48, Wm=64):
    rs = np.random.RandomState(seed)
    m = np.zeros((Bm, Km, Hm, Wm), np.float32)
    for b in range(Bm):
        for k in range(1, Km):
            y, x = rs.randint(0, Hm - 16), rs.randint(0, Wm - 16)
            m[b, k, y:y + 14, x:x + 12] = rs.uniform(0.6, 1.0)
    m[:, 0] = np.clip(1.0 - m[:, 1:].sum(1), 0, 1)
    return m


def test_att_map_gradient_is_ones():
    mask = torch.from_numpy(_soft_masks(3)).requires_grad_(True)
    att, boxes = regional_attention_small(mask, (3, 4), (0, 0), 16, 0.5, 10, LOOSE)
    wgt = torch.from_numpy(np.random.RandomState(4).randn(*att.shape).astype(np.float32))
    (att * wgt).sum().backward()
    assert boxes.dtype == torch.int32 and not boxes.requires_grad
    np.testing.assert_array_equal(mask.grad.numpy(), np.ones(mask.shape, np.float32))


def test_warped_att_map_matches_jax_vjp():
    mask = _soft_masks(5)
    rs = np.random.RandomState(6)
    flow = ((rs.rand(2, H, W, 2) - 0.5) * 6.0).astype(np.float32)
    args = ((3, 4), (0, 0), 16, 0.5, 10, LOOSE)
    mt = torch.from_numpy(mask).requires_grad_(True)
    att = warped_regional_attention_small(mt, torch.from_numpy(flow), *args)
    wgt = rs.randn(*att.shape).astype(np.float32)
    (att * torch.from_numpy(wgt)).sum().backward()
    att_j, vjp = jax.vjp(
        lambda m: jax_att_map.warped_regional_attention_small(m, jnp.asarray(flow), *args),
        jnp.asarray(mask))
    (g_j,) = vjp(jnp.asarray(wgt))
    np.testing.assert_array_equal(att.detach().numpy(), np.asarray(att_j))
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)
    # channel-uniform: every channel gets the same splat field
    np.testing.assert_array_equal(mt.grad.numpy()[:, 0], mt.grad.numpy()[:, 2])


# --------------------------------------------------------------- the step
def _clip():
    """Object 1 drifting, object 2 revealed at t=2 (injection at the last
    frame, suppression before it), smooth-ish random flows within +-1.5 px."""
    rs = np.random.RandomState(3)
    frames = rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1
    labels = np.zeros((B, T, H, W), np.uint8)
    for t in range(T):
        labels[:, t, 8 + 2 * t: 24 + 2 * t, 10:30] = 1
        if t >= 2:
            labels[:, t, 28:44, 36 + t: 56 + t] = 2
    masks = np.stack([(labels == k) for k in range(K)], axis=2).astype(np.float32)
    flows = ((rs.rand(B, T, H, W, 2).astype(np.float32)) - 0.5) * 3.0
    n_objects = np.array([[1, 1, 2]], np.int32)
    return dict(frames=frames, masks=masks, flows=flows, n_objects=n_objects)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def step_setup():
    rmnet, tfn = build_models(seed=0, device="cpu")
    for m in rmnet.modules():  # non-trivial frozen BN statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            g = torch.Generator().manual_seed(m.num_features)
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.8, 1.4, generator=g)
    sd = rmnet.state_dict()
    rm_vars = _jax_variables(JaxRMNet(), sd, jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    batch = _clip()
    cfg = JaxConfig()
    apply = JaxApply(JaxRMNet(), memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                     n_bbox_loose_pixels=LOOSE)
    loss_fn = jax_train.make_loss_fn(cfg, apply, None, remat="none")
    extra = {k: v for k, v in rm_vars.items() if k != "params"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(lambda p: loss_fn(p, extra, jbatch)[0])(
        rm_vars["params"])
    return rmnet, tfn, rm_vars, batch, float(loss_j), _flat(grads_j)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_train_step_gradients_match_jax(step_setup, flash):
    rmnet, tfn, rm_vars, batch, loss_j, flat_j = step_setup
    cfg = Config()
    cfg.TRAIN.FLASH_ATTENTION = flash
    apply = RMNetApply(rmnet, memorize_every=cfg.TRAIN.MEMORIZE_EVERY,
                       n_bbox_loose_pixels=LOOSE, use_flash_attention=flash)
    loss_fn = make_loss_fn(cfg, apply, tfn)
    rmnet.zero_grad(set_to_none=True)
    loss = loss_fn({k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5, atol=1e-6)

    grad_sd = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
               for name, p in rmnet.named_parameters()}
    for name, b in rmnet.state_dict().items():  # BN statistics: no gradient
        grad_sd.setdefault(name, torch.zeros_like(b) if b.is_floating_point() else b)
    zero_tree = jax.tree_util.tree_map(np.zeros_like, rm_vars)
    tree, missing = import_state_dict(zero_tree, grad_sd, "reference")
    assert not missing
    flat_t = _flat(tree["params"])
    assert set(flat_t) == set(flat_j)
    gmax = max(np.abs(g).max() for g in flat_j.values())
    assert gmax > 0
    bad = []
    for name in sorted(flat_j):
        gt, gj = flat_t[name], flat_j[name]
        err, ref = np.linalg.norm(gt - gj), np.linalg.norm(gj)
        if err > 1e-4 * ref and np.abs(gt - gj).max() > 1e-7 * gmax:
            bad.append((name, float(err / (ref + 1e-30))))
    assert not bad, f"{len(bad)} tensors off: {bad[:12]}"


def test_tinyflownet_video_forward_matches_jax():
    rmnet, tfn = build_models(seed=1, device="cpu")
    tfn_vars = _jax_variables(JaxTinyFlowNet(), tfn.state_dict(), jnp.zeros((1, 2, 64, 64, 3)))
    frames = np.random.RandomState(8).rand(1, 3, 64, 64, 3).astype(np.float32) * 2 - 1
    flows_j = np.asarray(JaxTinyFlowNet().apply(tfn_vars, jnp.asarray(frames)))
    with torch.no_grad():
        flows = tfn.video_forward(torch.from_numpy(frames)).numpy()
    assert flows.shape == (1, 3, 64, 64, 2)
    np.testing.assert_array_equal(flows[:, 0], 0.0)
    np.testing.assert_allclose(flows, flows_j, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- optimizer
def test_adam_matches_jax_optimizer():
    cfg, jcfg = Config(), JaxConfig()
    cfg.TRAIN.WEIGHT_DECAY = jcfg.TRAIN.WEIGHT_DECAY = 0.01
    rs = np.random.RandomState(9)
    params = {"a": rs.randn(4, 5).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(cfg, list(tp.values()))
    jopt = jax_train.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    for epoch, g in enumerate(grads):
        lr = cosine_lr(1e-2, epoch, 4)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p - lr * u, jp, updates)
        # torch folds the bias corrections into the step size and the
        # denominator, optax into the moments: the same update, rounded in
        # another order, so a few float32 ulps of parameters of size ~1
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    adam_state = state[-1]
    for k, p in tp.items():
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   np.asarray(adam_state.mu[k]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                   np.asarray(adam_state.nu[k]), rtol=1e-6, atol=1e-10)


def test_cosine_lr_matches_jax():
    for epoch in (0, 1, 57, 199):
        assert cosine_lr(1e-5, epoch, 200) == pytest.approx(
            float(jax_train.cosine_lr(1e-5, epoch, 200)), rel=1e-12)


def test_non_finite_loss_skips_the_update():
    """A NaN batch leaves the parameters and Adam's moments as they were."""
    cfg = Config()
    cfg.TRAIN.NETWORK = "TinyFlowNet"
    _, tfn = build_models(seed=2, device="cpu")
    opt = make_optimizer(cfg, tfn.parameters())
    step = make_train_step(cfg, None, tfn, opt)
    rs = np.random.RandomState(10)
    batch = {"frames": torch.from_numpy(rs.rand(1, 2, 64, 64, 3).astype(np.float32)),
             "flows": torch.from_numpy(rs.randn(1, 2, 64, 64, 2).astype(np.float32))}
    assert np.isfinite(step(batch, 1e-3))
    before = {n: p.detach().clone() for n, p in tfn.named_parameters()}
    moments = {n: {k: v.clone() for k, v in opt.state[p].items()}
               for n, p in tfn.named_parameters()}
    batch["frames"][0, 1, 3, 3, 0] = float("nan")
    assert not np.isfinite(step(batch, 1e-3))
    for n, p in tfn.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
        for k, v in opt.state[p].items():
            assert torch.equal(v, moments[n][k]), (n, k)
