"""Rank functions of tests/test_torch_hybrid.py. They run in processes that
``rmnet_tpu_torch.parallel.launch`` starts with the ``spawn`` method, which
import this module by name: it imports torch and the port, never JAX or
rmnet_tpu, and each rank reports whether either got imported."""

import hashlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

from rmnet_tpu_torch.models.layers import BatchNorm2d
from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.parallel import hybrid_shard_batch, make_hybrid_mesh
from rmnet_tpu_torch.parallel.space import WidthMesh, spatial_forward_video
from rmnet_tpu_torch.train import Trainer

from tests.torch_dp_ranks import seeded_states, train_cfg
from tests.torch_spatial_ranks import CONV_CASES, LOOSE, OPS_HW


def _jax_imported() -> bool:
    return any(m.split(".")[0] in ("jax", "jaxlib", "flax", "rmnet_tpu") for m in sys.modules)


def _digest(state) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def grid_steps(grid, batch, variants, lr):
    """One train step per variant (name -> TRAIN fields) on the rank's grid,
    from the seeded weights on the global ``batch`` -> per variant the loss,
    a digest of RMNet's state after the step, its running statistics, the
    collectives by mesh and kind, and on world rank 0 the gradients."""
    states = seeded_states(0)
    out = {}
    for name, train in variants.items():
        for m in grid.meshes().values():
            m.counts.clear()
        trainer = Trainer(train_cfg(grid.data.size, **train), *states, device="cpu", mesh=grid)
        loss = trainer.train_step(batch, lr)
        out[name] = dict(
            loss=loss, digest=_digest(trainer.rmnet.state_dict()),
            stats={k: v.numpy().copy() for k, v in trainer.apply.running_stats().items()},
            counts={mn: {k: v[0] for k, v in m.counts.items()}
                    for mn, m in grid.meshes().items()},
            grads=None if grid.world.rank else {n: p.grad.numpy().copy()
                                                for n, p in trainer.rmnet.named_parameters()
                                                if p.grad is not None})
    return out


def grid_work(world, steps, x, bn_args, layout_batch):
    """One launch's work on a 2 x 2 grid of the world's 4 ranks: the train
    steps of ``steps`` (name -> (batch, variants, lr), ``grid_steps``), the
    BatchNorm layer over both axes (``bn_grid``), ``hybrid_shard_batch``'s
    layout at 1 and 2 micro-batches, and on the world as a width mesh of 4
    the halo ops' gradients and the width gathers."""
    torch.set_num_threads(1)
    grid = make_hybrid_mesh(2, 2, world)
    out = {name: grid_steps(grid, *args) for name, args in steps.items()}
    out.update(place=(grid.data.rank, grid.space.rank), bn=bn_grid(grid, *bn_args),
               layout={accum: shard_layout(grid, layout_batch, accum) for accum in (1, 2)},
               halo=halo_grads(world, x), gathers=gathers(world),
               jax_imported=_jax_imported())
    return out


def _cotangent(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape)
                            .astype(np.float32))


def grad_cases(x):
    """Per halo op: (its input's name in ``x``, its parameters by name, a
    function of (input, width mesh or None, **parameters))."""
    t = {k: torch.from_numpy(v) for k, v in x.items() if isinstance(v, np.ndarray)}
    cases = {}
    for k, s, p in CONV_CASES:
        def conv(z, sp, weight, bias, s=s, p=p):
            return F.conv2d(z, weight, bias, s, p) if sp is None else sp.conv2d(
                z, weight, bias, s, p)

        cases[f"conv{k}_s{s}_p{p}"] = (
            "full" if k == 7 else "half",
            dict(weight=torch.from_numpy(x["weights"][(k, s, p)]), bias=t["bias"]), conv)
    cases["max_pool"] = ("half", {}, lambda z, sp: F.max_pool2d(z, 3, 2, 1) if sp is None
                         else sp.max_pool(z, 3, 2, 1))
    for f, src in ((2, "grid"), (4, "quarter")):
        cases[f"upsample{f}"] = (src, {}, lambda z, sp, f=f: F.interpolate(
            z, size=(z.shape[-2] * f, z.shape[-1] * f), mode="bilinear",
            align_corners=False) if sp is None else sp.upsample(z, f))
    return t, cases


def halo_op_grads(t, cases, width=None, lo=0, hi=None):
    """Each case's output on columns [lo, hi) of the /16 grid of its input
    (the whole tensor without ``width``), weighted by a seeded cotangent of
    the whole output at those columns and summed, then backward -> {op:
    (the input's gradient, {parameter: gradient})}."""
    out = {}
    for i, (name, (src, params, fn)) in enumerate(cases.items()):
        whole = t[src]
        n_cols = whole.shape[-1] // 4 if width is None else width.grid[-1][1]
        per = whole.shape[-1] // n_cols
        stop = n_cols if hi is None else hi
        part = whole[..., lo * per:stop * per].clone().requires_grad_(True)
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = fn(part, width, **params)
        out_per = y.shape[-1] // (stop - lo)
        cot = _cotangent(y.shape[:-1] + (n_cols * out_per,), i)
        (y * cot[..., lo * out_per:stop * out_per]).sum().backward()
        out[name] = (part.grad.numpy(), {k: v.grad.numpy() for k, v in params.items()})
    return out


def halo_grads(mesh, x):
    """``halo_op_grads`` of every case on the rank's columns of a 24 x 60
    frame's tensors (4 columns of the /16 grid)."""
    torch.set_num_threads(1)
    width = WidthMesh.build(mesh, *OPS_HW)
    t, cases = grad_cases(x)
    lo, hi = width.grid[width.rank]
    return dict(grads=halo_op_grads(t, cases, width, lo, hi),
                counts={k: v[0] for k, v in mesh.counts.items()})


def gathers(mesh):
    """The width gathers on a 24 x 60 frame (4 columns of the /16 grid):
    ``gather_unpadded`` summed and not, and ``gather_grid``, each weighted by
    a cotangent that differs per rank -> {name: (the gathered value, the
    rank's gradient)}."""
    width = WidthMesh.build(mesh, *OPS_HW)
    r = mesh.rank
    lo, hi = width.unpadded_columns()
    g_lo, g_hi = width.grid[r]
    base = torch.arange(2 * 3 * OPS_HW[1], dtype=torch.float32).reshape(2, 3, OPS_HW[1])
    out = {}
    for name, x, fn in (
            ("unpadded_summed", base[..., lo:hi], lambda z: width.gather_unpadded(z, "t")),
            ("unpadded_own", base[..., lo:hi],
             lambda z: width.gather_unpadded(z, "t", summed=False)),
            ("grid", base[..., :4][..., g_lo:g_hi], lambda z: width.gather_grid(z, "t"))):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * (r + 1) * torch.arange(y.shape[-1], dtype=torch.float32)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def bn_grid(grid, x, cot, weight, bias, mean, var, split):
    """A float64 BatchNorm2d on the global batch ``x`` (N, C, H, W), the
    rank's rows of which split over "data" and its columns over "space" at
    ``split`` (column bounds per space rank, unequal) -> the rank's input
    gradient, the weight's and bias's (the rank's part), and the
    statistics."""
    n_data = grid.data.size
    rows = slice(grid.data.rank * len(x) // n_data, (grid.data.rank + 1) * len(x) // n_data)
    cols = slice(*split[grid.space.rank])
    bn = BatchNorm2d(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    part = x[rows][..., cols].clone().requires_grad_(True)
    bn.batch_stats, bn.mesh = (mean, var), grid.world
    (bn(part) * cot[rows][..., cols]).sum().backward()
    return dict(x_grad=part.grad.numpy(), weight_grad=bn.weight.grad.numpy(),
                bias_grad=bn.bias.grad.numpy(), stats=tuple(t.numpy() for t in bn.new_stats))


def narrow_forward(mesh, state_path, clip):
    """spatial_forward_video on ``clip`` (memorize_every=1, the tests' loose
    box) on a width mesh where some ranks hold no column -> the whole
    clip's estimate, the rank's /16 columns and the collectives by kind."""
    torch.set_num_threads(1)
    model = RMNet()
    model.load_state_dict(torch.load(state_path, weights_only=True))
    apply = RMNetApply(model.eval(), memorize_every=1, n_bbox_loose_pixels=LOOSE)
    est = spatial_forward_video(apply, *clip, mesh).numpy()
    width = WidthMesh.build(mesh, *clip[1].shape[-2:])
    return dict(est=est, grid=width.grid[mesh.rank],
                counts={k: v[0] for k, v in mesh.counts.items()}, jax_imported=_jax_imported())


def shard_layout(grid, batch, accum):
    """``hybrid_shard_batch`` on the grid -> the rank's rows (frame 0's
    first value of each) and the arrays' shapes."""
    part = hybrid_shard_batch(batch, grid, accum)
    return dict(rows=part["frames"][:, 0, 0, 0, 0].tolist(),
                shapes={k: tuple(np.shape(v)) for k, v in part.items()})
