"""Hybrid batch x width training of TinyFlowNet, and of RMNet where some
"space" ranks hold no column, through the port against the JAX package's, on
the CPU: gloo ranks, each a process started with ``spawn`` (rank functions in
tests/torch_hybrid_tfn_ranks.py, which imports no JAX), a 60 s timeout on the
groups and a deadline on each launch, so that a hang fails its test. One
launch at 4 ranks, one at 8 and one at 2 do all the rank work, in threads
beside the JAX programs and the port's single-process steps; the tests read
their results.

TinyFlowNet runs on whole columns of its /64 grid (``tiny_flownet.CELL``):
on a 2 x 2 grid at B=4, T=2, 64x256 (2 columns a rank), its step is held to
tests/test_parallel.py:99-167's bars (the loss within 5e-5 relative, every
gradient tensor within 5e-4 of its norm or within 1e-6 of the largest
gradient) against the JAX hybrid mesh's, JAX's single device's and the
port's single step; at 64x200 (pads 28 and 28, held by the edge ranks only)
against the port's single step, in float64 to 1e-9 (the replicas and the
collectives from the float32 step). In float32 a pre-activation of ``conv4``
there lies within rounding of LeakyReLU's kink (-1.7e-7 in float64, +2.5e-8
in the grid's float32), so the slope taken at one element differs and
``conv4``'s gradient moves by 1.4e-3 of its norm: the comparison, not the
grid, is ill-posed in float32 there. The JAX hybrid mesh is compared at
64x256
only: at one /64 column a rank (48x128) its gradient is far from its own
single device's (``conv5`` 2.95 of its norm), while at 64x256 the two agree
to 6e-7.

RMNet on a 2 x 4 grid at 48x48 (3 columns of the /16 grid: the last space
rank of each row holds none) against the port's and JAX's single-device step
at the same bars; the JAX hybrid mesh is not a reference there. Replicas are
bit-identical after every step, and every rank gives the same parameters a
gradient as the single step.

The transposes of the /64 grid ops (TinyFlowNet's transposed convolutions
with and without a bias, the halving resize, the x8 resize; at 2 and 4
ranks) against the whole op's, to 1e-5 of their largest magnitude; the plain
read's backward at a query of no column.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import train as jax_train
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet, RMNetApply as JaxApply
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet
from rmnet_tpu.parallel import hybrid_shard_batch as jax_hybrid_shard_batch
from rmnet_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh

from rmnet_tpu_torch.models.weights import from_jax_variables
from rmnet_tpu_torch.ops.flash_attention import (flash_memory_read, flash_read_bwd_reference,
                                                 merge_skipped_tiles, tile_metadata)
from rmnet_tpu_torch.parallel import DataMesh, launch
from rmnet_tpu_torch.parallel.space import WidthMesh, width_mesh
from rmnet_tpu_torch.train import Trainer

from tests.test_torch_engine import _jax_variables
from tests.test_torch_spatial import _read_case
from tests.torch_dp_ranks import bn_case, seeded_states, train_cfg, trained_net
from tests.torch_hybrid_ranks import halo_op_grads
from tests.torch_hybrid_tfn_ranks import OPS_HW, columnless_work, op_cases, op_grads, \
    op_inputs, tfn_grads64, tfn_work

torch.set_num_threads(2)

B, T, K = 4, 2, 3
TFN_HW = {"w256": (64, 256), "w200": (64, 200)}
RM_HW, RM_SPACE = (48, 48), 4
RM_TRAIN = dict(REMAT="encoders")
LR = 1e-3
LOSS_REL, GRAD_REL, ESCAPE = 5e-5, 5e-4, 1e-6   # tests/test_parallel.py:143-167
F64_REL = 1e-9  # the float64 step's loss and each gradient tensor, of its norm
OP_REL = 1e-5
TIMEOUT_S, DEADLINE_S = 60, 420
BN_SPLIT = ((0, 7), (7, 7))  # the float64 layer's width shares: the second space rank none


def _tfn_batch(hw, seed=0):
    """Seeded frames and flows (B, T, H, W, .) of TinyFlowNet's loss."""
    rs = np.random.RandomState(seed)
    H, W = hw
    return {"frames": rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1,
            "flows": (rs.rand(B, T, H, W, 2).astype(np.float32) - 0.5) * 4,
            "n_objects": np.full((B, T), K - 1, np.int32)}


def _rm_batch():
    """tests/test_parallel.py:111-123's batch at 48x48."""
    H, W = RM_HW
    rs = np.random.RandomState(0)
    labels = np.zeros((B, T, H, W), np.uint8)
    labels[:, :, 8:28, 10:30] = 1
    labels[:, :, 30:44, 32:46] = 2
    return {
        "frames": rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1,
        "masks": np.stack([(labels == k) for k in range(K)], 2).astype(np.float32),
        "flows": (rs.rand(B, T, H, W, 2).astype(np.float32) - 0.5) * 4,
        "n_objects": np.full((B, T), K - 1, np.int32),
    }


def _jax_grads(loss_fn, variables, batch, mesh=None):
    """JAX's loss and gradient on one device, or on ``mesh`` with the batch
    placed by its hybrid_shard_batch -> (loss, the gradient tree)."""
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    if mesh is None:
        dev = jax.devices()[0]
        put = (lambda x: jax.device_put(x, dev))
        placed = {k: put(v) for k, v in batch.items()}
    else:
        repl = NamedSharding(mesh, P())
        put = (lambda x: jax.device_put(x, repl))
        placed = jax_hybrid_shard_batch(batch, mesh)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        put(params), put(extra), placed)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _jax_steps(states, tfn_batch, rm_batch):
    """The JAX package's loss and gradients, by port name: TinyFlowNet on
    one device and on make_hybrid_mesh(2, 2) at 64x256, RMNet (REMAT
    "encoders", dense read, frozen BN) on one device at 48x48."""
    cfg = JaxConfig()
    cfg.TRAIN.NETWORK = "TinyFlowNet"
    tfn_vars = _jax_variables(JaxTinyFlowNet(), states[1], jnp.zeros((1, 2, 64, 64, 3)))
    tfn_loss = jax_train.make_loss_fn(cfg, JaxApply(JaxRMNet()), JaxTinyFlowNet(), remat="none")
    out = {}
    for name, mesh in (("tfn_single", None), ("tfn_hybrid", jax_make_hybrid_mesh(2, 2))):
        loss, grads = _jax_grads(tfn_loss, tfn_vars, tfn_batch, mesh)
        out[name] = dict(loss=loss, grads={k: v.numpy() for k, v in
                                           from_jax_variables({}, {"params": grads})[1].items()})
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    cfg = JaxConfig()
    apply = JaxApply(JaxRMNet(), memorize_every=cfg.TRAIN.MEMORIZE_EVERY)
    loss, grads = _jax_grads(jax_train.make_loss_fn(cfg, apply, None, remat="encoders"),
                             rm_vars, rm_batch)
    out["rm_single"] = dict(loss=loss, grads={k: v.numpy() for k, v in
                                              from_jax_variables({"params": grads}, {})[0]
                                              .items()})
    return out


def _single_step(states, batch, network, train):
    trainer = Trainer(train_cfg(1, NETWORK=network, **train), *states, device="cpu")
    loss = trainer.train_step(batch, LR)
    return dict(loss=loss, grads={n: p.grad.numpy().copy()
                                  for n, p in trained_net(trainer).named_parameters()
                                  if p.grad is not None})


@pytest.fixture(scope="module")
def runs():
    """The ranks' results (TinyFlowNet's grid and the /64 ops at 4 ranks,
    the columnless RMNet grid at 8, the /64 ops at 2), run in threads while
    this process runs the JAX programs and the port's single steps."""
    states = seeded_states(0)
    tfn_batches = {name: _tfn_batch(hw) for name, hw in TFN_HW.items()}
    rm_batch = _rm_batch()
    x = op_inputs()
    bn_args = bn_case(seed=2, shape=(4, 3, 5, 7))
    with ThreadPoolExecutor(2) as pool:
        def grids():
            tfn = launch(tfn_work, (tfn_batches, x, tfn_batches["w200"], (*bn_args, BN_SPLIT)),
                         ["cpu"] * 4, "gloo", TIMEOUT_S, DEADLINE_S)
            rm = launch(columnless_work, (RM_SPACE, rm_batch, RM_TRAIN), ["cpu"] * 8, "gloo",
                        TIMEOUT_S, DEADLINE_S)
            return tfn, rm

        grid_runs = pool.submit(grids)
        ops2 = pool.submit(launch, op_grads, (x,), ["cpu"] * 2, "gloo", TIMEOUT_S, DEADLINE_S)
        single = {name: _single_step(states, b, "TinyFlowNet", {})
                  for name, b in tfn_batches.items()}
        single["f64"] = tfn_grads64(tfn_batches["w200"])
        single["rm"] = _single_step(states, rm_batch, "RMNet", RM_TRAIN)
        jax_out = _jax_steps(states, tfn_batches["w256"], rm_batch)
        tfn, rm = grid_runs.result()
        ops = {2: ops2.result(), 4: [r["ops"] for r in tfn]}
    return dict(tfn=tfn, rm=rm, ops=ops, x=x, single=single, jax=jax_out, bn_args=bn_args)


def _bad_tensors(got, want):
    """The tensors past GRAD_REL of their norm and past the escape, as
    (name, ||got - want|| / ||want||)."""
    gmax = max(np.abs(g).max() for g in want.values())
    assert gmax > 0 and set(got) == set(want)
    bad = []
    for name in sorted(want):
        err, ref = np.linalg.norm(got[name] - want[name]), np.linalg.norm(want[name])
        if err > GRAD_REL * ref and np.abs(got[name] - want[name]).max() > ESCAPE * gmax:
            bad.append((name, float(err / (ref + 1e-30))))
    return bad


def _check_replicas(rows, want_keys):
    assert len({r["digest"] for r in rows}) == 1
    assert all(r["with_grad"] == sorted(want_keys) for r in rows)
    assert len({r["loss"] for r in rows}) == 1


@pytest.mark.parametrize("ref", ["jax_hybrid", "jax_single", "port_single"])
def test_tinyflownet_grid_step_matches(runs, ref):
    """TinyFlowNet's 2 x 2 step at 64x256 (2 /64 columns a rank) against
    the JAX hybrid mesh, JAX's single device and the port's single step:
    the loss and every gradient at tests/test_parallel.py's bar; the
    replicas bit-identical after Adam, every rank with the single step's
    parameters carrying a gradient; no JAX in the ranks."""
    rows = [r["steps"]["w256"] for r in runs["tfn"]]
    want = {"jax_hybrid": runs["jax"]["tfn_hybrid"], "jax_single": runs["jax"]["tfn_single"],
            "port_single": runs["single"]["w256"]}[ref]
    np.testing.assert_allclose(rows[0]["loss"], want["loss"], rtol=LOSS_REL)
    bad = _bad_tensors(rows[0]["grads"], want["grads"])
    assert not bad, f"{len(bad)} tensors off: {bad[:12]}"
    _check_replicas(rows, runs["single"]["w256"]["grads"])
    assert not any(r["jax_imported"] for r in runs["tfn"])


def test_tinyflownet_grid_step_where_the_edge_ranks_hold_padding(runs):
    """64x200 pads to 64x256 with 28 columns on each side, held by the
    first and the last space rank only: the loss and every gradient in
    float64 within 1e-9 of the port's single step's; the float32 step's
    loss at tests/test_parallel.py's bar, its replicas bit-identical; per
    step and rank 19 halos forward (every conv and transposed conv wider
    than 1, and the x8 resize) and 18 backward (the first conv reads the
    frames, which take no gradient), one gather of the flows over "space"
    with no backward collective, two over "data" (estimated and given
    flows) and one gradient all-reduce."""
    loss, grads = runs["tfn"][0]["f64"]
    want_loss, want = runs["single"]["f64"]
    np.testing.assert_allclose(loss, want_loss, rtol=F64_REL)
    assert set(grads) == set(want)
    for name, g in want.items():
        assert np.linalg.norm(grads[name] - g) <= F64_REL * np.linalg.norm(g), name
    rows = [r["steps"]["w200"] for r in runs["tfn"]]
    np.testing.assert_allclose(rows[0]["loss"], runs["single"]["w200"]["loss"], rtol=LOSS_REL)
    _check_replicas(rows, want)
    for r in runs["tfn"]:
        counts = r["steps"]["w200"]["counts"]
        assert counts["world"]["gradients"] == 1
        assert counts["data"] == {"loss gather": 2}
        assert counts["space"] == {"halo": 19, "halo backward": 18, "loss gather": 1}


@pytest.mark.parametrize("ref", ["jax_single", "port_single"])
def test_rmnet_grid_step_where_space_ranks_hold_no_column(runs, ref):
    """RMNet on a 2 x 4 grid at 48x48: 3 columns of the /16 grid, so the
    last space rank of each row holds none and still takes part in every
    collective. The loss and every gradient at tests/test_parallel.py's bar
    of the single-device step of both packages; the replicas bit-identical;
    every rank, with columns or without, gives the single step's
    parameters a gradient, so the gradient bucket is the same on each."""
    rows = runs["rm"]
    assert [r["columns"] for r in rows] == [(0, 1), (1, 2), (2, 3), (3, 3)] * 2
    want = {"jax_single": runs["jax"]["rm_single"], "port_single": runs["single"]["rm"]}[ref]
    np.testing.assert_allclose(rows[0]["loss"], want["loss"], rtol=LOSS_REL)
    bad = _bad_tensors(rows[0]["grads"], want["grads"])
    assert not bad, f"{len(bad)} tensors off: {bad[:12]}"
    _check_replicas(rows, runs["single"]["rm"]["grads"])
    assert all(r["counts"] == rows[0]["counts"] for r in rows)
    space = rows[0]["counts"]["space"]
    assert space["gather bank"] == space["gather bank backward"] == T - 1
    assert space["halo backward"] > 0 and rows[0]["counts"]["world"]["gradients"] == 1
    assert not any(r["jax_imported"] for r in rows)


def test_batch_norm_layer_where_a_space_rank_holds_no_column(runs):
    """Trainable BatchNorm2d in float64 on 4 rows split over "data" and 7
    columns all on the first space rank: the ranks without a column add a
    count of 0 to the global n, their input gradient is empty, and the
    input's, weight's and bias's gradients and the running statistics are
    those of torch's batch norm over the whole batch, to 1e-10."""
    x, cot, weight, bias, mean, var = runs["bn_args"]
    x, weight, bias = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    run_mean, run_var = mean.clone(), var.clone()
    (torch.nn.functional.batch_norm(x, run_mean, run_var, weight, bias, True, 0.1, 1e-5)
     * cot).sum().backward()
    ranks = [r["bn"] for r in runs["tfn"]]
    close = dict(rtol=1e-10, atol=1e-10)
    assert all(ranks[2 * d + 1]["x_grad"].shape[-1] == 0 for d in range(2))
    got = np.concatenate([ranks[2 * d]["x_grad"] for d in range(2)])
    np.testing.assert_allclose(got, x.grad.numpy(), **close)
    for name, want in (("weight_grad", weight.grad), ("bias_grad", bias.grad)):
        np.testing.assert_allclose(sum(r[name] for r in ranks), want.numpy(), **close)
    for r in ranks:
        np.testing.assert_allclose(r["stats"][0], run_mean.numpy(), **close)
        np.testing.assert_allclose(r["stats"][1], run_var.numpy(), **close)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["deconv_grid", "deconv_flow", "downsample2", "upsample8"])
def test_grid64_op_gradient_matches_the_whole_op(runs, n, op):
    """On an 8 x 256 frame (4 columns of the /64 grid) the rank's output and
    input gradient are its columns of the whole op's, the parameters'
    gradients summed over the ranks the whole op's; a halo forward and one
    backward for each op but the halving resize, which reads only its own
    columns."""
    t, cases = op_cases(runs["x"])
    whole_x, whole_p = halo_op_grads(t, cases)[op]
    ranks = runs["ops"][n]
    got = np.concatenate([r["grads"][op][0] for r in ranks], -1)
    assert got.shape == whole_x.shape
    np.testing.assert_allclose(got, whole_x, rtol=0, atol=OP_REL * np.abs(whole_x).max())
    for k, v in whole_p.items():
        np.testing.assert_allclose(sum(r["grads"][op][1][k] for r in ranks), v, rtol=0,
                                   atol=OP_REL * np.abs(v).max())
    for r in ranks:
        assert r["counts"]["halo"] == r["counts"]["halo backward"] == len(cases) - 1


def test_width_mesh_takes_the_grid_of_its_network():
    """The /64 grid of a 64x200 frame on 2 ranks: pads (28, 28), 2 columns a
    rank, columns at every resolution of TinyFlowNet; the plan cache keys on
    the cell, so RMNet's /16 mesh of the same frame is another."""
    mesh = DataMesh(1, 2, torch.device("cpu"), "gloo")
    tfn = width_mesh(mesh, 64, 200, 64)
    assert tfn is width_mesh(mesh, 64, 200, 64)
    assert (tfn.pads, tfn.grid, tfn.padded_width) == ((28, 28, 0, 0), ((0, 2), (2, 4)), 256)
    assert [tfn.columns(s) for s in (1, 2, 8, 64)] == [(128, 256), (64, 128), (16, 32), (2, 4)]
    assert tfn.unpadded_columns() == (100, 200) and tfn.own_pads((28, 28, 0, 0)) == (0, 28, 0, 0)
    rm = width_mesh(mesh, 64, 200)
    assert rm is not tfn and (rm.cell, rm.pads, rm.grid) == (16, (4, 4, 0, 0), ((0, 7), (7, 13)))
    assert WidthMesh.build(mesh, *OPS_HW, 64).grid == ((0, 2), (2, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_read_backward_of_an_empty_query_shard(dtype):
    """A rank that holds no column reads a query of Q = 0 rows: the plain
    backward gives an empty dq and zero dK/dV, the skipped tiles' closed
    form adds nothing, and the read's autograd takes it end to end."""
    mk, mv, q, valid, boxes = (t.to(dtype) if t.is_floating_point() else t
                               for t in _read_case())
    q = q[:, :, :0].contiguous()
    h, w = mk.shape[2:4]
    tile_active, _, order, counts = tile_metadata(valid, boxes, h, w)
    N = q.shape[0]
    lse = torch.empty(N, 0, dtype=torch.float32)
    d_out = torch.empty(N, h, 0, mv.shape[-1], dtype=dtype)
    dq, dk_t, dv_t = flash_read_bwd_reference(mk, mv, q, valid, order, counts, d_out, lse,
                                              torch.empty(N, 0, dtype=torch.float32))
    assert dq.shape == q.shape and not dk_t.any() and not dv_t.any()
    dmk, dmv = merge_skipped_tiles(dk_t, dv_t, tile_active, valid, q, d_out, lse, lse,
                                   mk.shape)
    assert dmk.shape == mk.shape and dmv.shape == mv.shape
    assert not dmk.any() and not dmv.any()
    mk, mv, q = (t.clone().requires_grad_(True) for t in (mk, mv, q))
    out, lse = flash_memory_read(mk, mv, q, valid, boxes)
    assert out.shape == (N, h, 0, mv.shape[-1]) and lse.shape == (N, 0)
    out.sum().backward()
    assert q.grad.shape == q.shape and not mk.grad.any() and not mv.grad.any()


def test_chip_smoke_holds_the_read_of_a_rank_without_columns():
    """Variant columnless of phase hybrid keeps the crop's columns 200-215:
    one column of the /16 grid, held by the first space rank, none by the
    second. Its empty query is a forward and a backward case of
    chip_smoke.py in both types, on the bank of the hybrid read; and phase
    hybrid_tfn's batch has 4 of the 8 /64 columns a rank."""
    import chip_smoke

    cfg = chip_smoke._dp_cfg(1, {})
    H = cfg.TRAIN.AUGMENTATION.CROP_HSIZE
    lo, hi = chip_smoke.HYBRID_VARIANTS["columnless"][1]
    space = DataMesh(0, chip_smoke.HYBRID_GRID[1], torch.device("cpu"), "gloo")
    assert WidthMesh.build(space, H, hi - lo).grid == ((0, 1), (1, 1))
    tfn_grid = WidthMesh.build(space, H, cfg.TRAIN.AUGMENTATION.CROP_WSIZE, 64).grid
    assert tfn_grid == ((0, 4), (4, 8))
    assert chip_smoke.HYBRID_TFN_VARIANTS["tfn"][0] == dict(NETWORK="TinyFlowNet")
    for dtype in ("f32", "bf16"):
        case = chip_smoke.KERNEL_CASES[f"hybrid_N6_S3_empty_{dtype}"]
        assert case[:4] == chip_smoke.KERNEL_CASES[f"hybrid_N6_S3_{dtype}"][:4]
        assert case[9] == (0, 0) and f"hybrid_N6_S3_empty_{dtype}" in chip_smoke.BWD_CASES
