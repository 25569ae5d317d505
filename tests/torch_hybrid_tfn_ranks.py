"""Rank functions of tests/test_torch_hybrid_tfn.py. They run in processes
that ``rmnet_tpu_torch.parallel.launch`` starts with the ``spawn`` method,
which import this module by name: it imports torch and the port, never JAX
or rmnet_tpu, and each rank reports whether either got imported."""

import numpy as np
import torch
import torch.nn.functional as F

from rmnet_tpu_torch.models.tiny_flownet import CELL
from rmnet_tpu_torch.parallel import all_reduce_grads, make_hybrid_mesh
from rmnet_tpu_torch.parallel.space import WidthMesh
from rmnet_tpu_torch.train import Trainer, make_loss_fn

from tests.torch_dp_ranks import seeded_states, train_cfg, trained_net
from tests.torch_hybrid_ranks import _digest, _jax_imported, bn_grid, halo_op_grads

OPS_HW = (8, 256)  # 4 columns of the /64 grid


def op_inputs(seed=0):
    """The /64 grid ops' inputs on an OPS_HW frame: ``full`` (2, 6, 8, 256)
    at full resolution, ``grid`` (2, 16, 8, 4) at /64, ``sixteenth`` (2, 2,
    8, 16) at /16 and ``eighth`` (2, 2, 8, 32) at /8; the weights of a
    16 -> 8 transposed conv with its bias and of a 2 -> 2 one without."""
    rs = np.random.RandomState(seed)
    H, W = OPS_HW

    def normal(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    return dict(full=normal(2, 6, H, W), grid=normal(2, 16, H, W // 64),
                sixteenth=normal(2, 2, H, W // 16), eighth=normal(2, 2, H, W // 8),
                deconv_weight=normal(16, 8, 4, 4) * 0.2, deconv_bias=normal(8),
                flow_weight=normal(2, 2, 4, 4) * 0.2)


def op_cases(x):
    """Per /64 grid op: (its input's name, its parameters by name, a
    function of (input, width mesh or None, **parameters)), the form of
    ``torch_hybrid_ranks.grad_cases``: TinyFlowNet's deconv4 (k4 s2 p1 with
    a bias, on /64 columns) and flow upsampling (no bias, on /16 columns),
    the halving resize and the x8 resize."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}

    def deconv(z, sp, weight, bias=None):
        if sp is None:
            return F.conv_transpose2d(z, weight, bias, 2, 1)
        return sp.conv_transpose2d(z, weight, bias, 2, 1)

    def half(z, sp):
        if sp is None:
            return F.interpolate(z, size=(z.shape[-2] // 2, z.shape[-1] // 2), mode="bilinear",
                                 align_corners=False)
        return sp.downsample2(z)

    def up8(z, sp):
        if sp is None:
            return F.interpolate(z, size=(z.shape[-2] * 8, z.shape[-1] * 8), mode="bilinear",
                                 align_corners=False)
        return sp.upsample(z, 8)

    cases = {
        "deconv_grid": ("grid", dict(weight=t["deconv_weight"], bias=t["deconv_bias"]), deconv),
        "deconv_flow": ("sixteenth", dict(weight=t["flow_weight"]), deconv),
        "downsample2": ("full", {}, half),
        "upsample8": ("eighth", {}, up8),
    }
    return t, cases


def op_grads(mesh, x):
    """``halo_op_grads`` of every /64 grid case on the rank's columns of an
    OPS_HW frame's tensors, and the halos by kind."""
    torch.set_num_threads(1)
    width = WidthMesh.build(mesh, *OPS_HW, CELL)
    t, cases = op_cases(x)
    lo, hi = width.grid[width.rank]
    before = {k: v[0] for k, v in mesh.counts.items()}
    grads = halo_op_grads(t, cases, width, lo, hi)
    return dict(grads=grads, counts={k: v[0] - before.get(k, 0) for k, v in mesh.counts.items()})


def grid_steps(grid, network, batches, train):
    """One train step of ``network`` per batch (name -> global batch) on the
    rank's grid from the seeded weights -> per batch the loss, a digest of
    the trained network's state after the step, the names of the
    parameters with a gradient, the collectives by mesh and kind, and on
    world rank 0 the gradients."""
    states = seeded_states(0)
    out = {}
    for name, batch in batches.items():
        for m in grid.meshes().values():
            m.counts.clear()
        trainer = Trainer(train_cfg(grid.data.size, NETWORK=network, **train), *states,
                          device="cpu", mesh=grid)
        loss = trainer.train_step(batch, 1e-3)
        net = trained_net(trainer)
        out[name] = dict(
            loss=loss, digest=_digest(net.state_dict()),
            with_grad=sorted(n for n, p in net.named_parameters() if p.grad is not None),
            counts={mn: {k: v[0] for k, v in m.counts.items()}
                    for mn, m in grid.meshes().items()},
            grads=None if grid.world.rank else {n: p.grad.numpy().copy()
                                                for n, p in net.named_parameters()
                                                if p.grad is not None})
    return out


def tfn_grads64(batch, mesh=None):
    """TinyFlowNet's loss and gradients in float64 from the seeded weights
    on ``batch`` (global), on one process or on the rank's grid (the
    gradients summed over it) -> (loss, {name: gradient})."""
    trainer = Trainer(train_cfg(1 if mesh is None else mesh.data.size, NETWORK="TinyFlowNet"),
                      *seeded_states(0), device="cpu", mesh=mesh)
    net = trainer.tflownet.double()
    loss = make_loss_fn(trainer.cfg, trainer.apply, net, mesh=mesh)(
        {k: v.double() if v.is_floating_point() else v
         for k, v in trainer.to_device(batch).items()})
    loss.backward()
    if mesh is not None:
        all_reduce_grads(list(net.parameters()), mesh.world)
    return loss.item(), {n: p.grad.numpy().copy() for n, p in net.named_parameters()}


def tfn_work(world, batches, x, batch64, bn_args):
    """On a 2 x 2 grid of the world's 4 ranks: TinyFlowNet's step on each
    batch and its float64 gradient on ``batch64``, the float64 BatchNorm
    layer of ``bn_args`` over both axes (``bn_grid``, whose split may leave
    a space rank no column), then on the world as a width mesh of 4 the /64
    grid ops' gradients."""
    torch.set_num_threads(1)
    grid = make_hybrid_mesh(2, 2, world)
    return dict(steps=grid_steps(grid, "TinyFlowNet", batches, {}),
                f64=tfn_grads64(batch64, grid), bn=bn_grid(grid, *bn_args),
                ops=op_grads(world, x),
                place=(grid.data.rank, grid.space.rank), jax_imported=_jax_imported())


def columnless_work(world, n_space, batch, train):
    """On a 2 x ``n_space`` grid of the world's ranks: RMNet's step on
    ``batch``, whose width leaves some space ranks without a column of the
    /16 grid; the rank's columns."""
    torch.set_num_threads(1)
    grid = make_hybrid_mesh(2, n_space, world)
    steps = grid_steps(grid, "RMNet", {"step": batch}, train)["step"]
    width = WidthMesh.build(grid.space, *np.shape(batch["masks"])[-2:])
    return dict(steps, columns=width.grid[grid.space.rank], jax_imported=_jax_imported())
