"""Hybrid batch x width training (``make_hybrid_mesh`` /
``hybrid_shard_batch``) through the port against the JAX package's, on the
CPU: a 2 x 2 grid of gloo ranks, each a process started with ``spawn``
(rank functions in tests/torch_hybrid_ranks.py, which imports no JAX), a 60 s
timeout on the groups and a deadline on each launch, so that a hang fails its
test. One launch at 4 ranks, one at 2 and one at 8 do all the rank work, in
threads beside the JAX programs and the port's single-process steps; the
tests read their results.

Under the JAX mesh (tests/test_parallel.py:99-167) the hybrid step is one
GSPMD program whose gradient is the single device's: B=4, T=2, K=3, 48x64,
REMAT "encoders", the loss within 5e-5 relative, every gradient tensor within
5e-4 of its norm or within 1e-6 of the largest gradient. The port's grid is
held to that bar against the JAX hybrid mesh (the port's seeded weights with
non-trivial BatchNorm statistics imported into the JAX package), with the
port's read dense and flash (its plain versions), and against the port's own
single-process step; and at T=3 (the estimate's gather, whose backward sums
the ranks' parts, and the training warp of a shard) alone and with
GRAD_ACCUM_STEPS = 2. Replicas are bit-identical after the step.

Trainable BatchNorm on the grid takes the statistics of every rank's rows and
columns: held as tests/test_torch_dp.py holds it (statistics within 2e-3 of
each tensor's largest value of the single step's and the JAX hybrid mesh's,
the loss within 2e-4 of the single step's), and the layer alone in float64 on
unequal width shares to 1e-10.

The transposes of the width collectives: each halo op's input and parameter
gradients (convolutions 7/3/1 at strides 1 and 2, the -inf max pool,
bilinear upsamples x2 and x4, at 2 and 4 ranks) against the whole op's, to
1e-5 of their largest magnitude (sums taken in another order); the width
gathers' gradients summed over the ranks or kept, exactly; the read's
backward at a query shard against the whole read's (dQ its columns, dK/dV
summed over the shards) at 2e-4.

Narrow widths: 48x64 on 8 ranks (4 columns of the /16 grid, 4 ranks with
none) through ``spatial_forward_video`` against the port's single forward and
the JAX package's, within 1e-4. The JAX ``spatial_forward_video`` accepts 8
devices at this width, but its estimate is 0.109 away from its own single
forward's on this clip (2 and 4 devices: 4e-6), so the JAX single forward is
the reference of the semantics there.
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
from rmnet_tpu.models.torch_import import import_state_dict
from rmnet_tpu.parallel import hybrid_shard_batch as jax_hybrid_shard_batch
from rmnet_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read
from rmnet_tpu_torch.parallel import (DataMesh, HybridMesh, launch, make_hybrid_mesh,
                                      rank_rows)
from rmnet_tpu_torch.parallel.space import WidthMesh
from rmnet_tpu_torch.train import Trainer

from tests.test_rmnet_forward import LOOSE, build_clip
from tests.test_torch_dp import _batch as t3_batch
from tests.test_torch_dp import _flat, _stats
from tests.test_torch_engine import _jax_variables
from tests.test_torch_spatial import _read_case
from tests.torch_dp_ranks import bn_case, seeded_states, train_cfg
from tests.torch_hybrid_ranks import grad_cases, grid_work, halo_grads, halo_op_grads, \
    narrow_forward
from tests.torch_spatial_ranks import op_inputs

torch.set_num_threads(2)

B, T, K, H, W = 4, 2, 3, 48, 64
LR = 1e-3
LOSS_REL, GRAD_REL, ESCAPE = 5e-5, 5e-4, 1e-6   # tests/test_parallel.py:143-167
BN_STATS_REL, BN_LOSS_REL = 2e-3, 2e-4           # tests/test_torch_dp.py
OP_REL = 1e-5
TOL = 1e-4                                       # tests/test_parallel.py:84
READ_TOL = 2e-4                                  # tests/test_flash_attention.py
TIMEOUT_S, DEADLINE_S = 60, 420
VARIANTS = {
    "dense": dict(REMAT="encoders", FLASH_ATTENTION=False),
    "flash": dict(REMAT="encoders"),
    "bn": dict(REMAT="encoders", USE_BATCH_NORM=True),
}
T3_VARIANTS = {
    "t3": dict(REMAT="encoders"),
    "t3_accum": dict(REMAT="encoders", GRAD_ACCUM_STEPS=2),
}
BN_SPLIT = ((0, 4), (4, 7))  # the float64 layer's unequal width shares


def _parallel_batch():
    """tests/test_parallel.py:111-123's batch."""
    rs = np.random.RandomState(0)
    labels = np.zeros((B, T, H, W), np.uint8)
    labels[:, :, 8:28, 10:30] = 1
    labels[:, :, 30:44, 36:58] = 2
    return {
        "frames": rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1,
        "masks": np.stack([(labels == k) for k in range(K)], 2).astype(np.float32),
        "flows": (rs.rand(B, T, H, W, 2).astype(np.float32) - 0.5) * 4,
        "n_objects": np.full((B, T), K - 1, np.int32),
    }


def _layout_batch():
    """A batch whose frames say their row: frames[b] = b."""
    b = np.arange(B, dtype=np.float32)
    return {"frames": np.broadcast_to(b[:, None, None, None, None], (B, T, H, W, 3)).copy(),
            "masks": np.zeros((B, T, K, H, W), np.float32),
            "flows": np.zeros((B, T, H, W, 2), np.float32),
            "n_objects": np.ones((B, T), np.int32)}


def _jax_hybrid(states, batch, clip):
    """The JAX package on a 2 x 2 hybrid mesh: make_loss_fn's loss and
    gradient (REMAT "encoders", dense read, frozen BN), forward_video with
    trainable BN and its statistics; and its forward_video of ``clip``."""
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    mesh = jax_make_hybrid_mesh(2, 2)
    repl = NamedSharding(mesh, P())
    sharded = jax_hybrid_shard_batch(batch, mesh)
    assert sharded["frames"].sharding.num_devices == 4
    cfg = JaxConfig()
    apply = JaxApply(JaxRMNet(), memorize_every=cfg.TRAIN.MEMORIZE_EVERY)
    loss_fn = jax_train.make_loss_fn(cfg, apply, None, remat="encoders")
    extra = {k: v for k, v in rm_vars.items() if k != "params"}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.device_put(rm_vars["params"], repl), jax.device_put(extra, repl), sharded)
    bn_apply = JaxApply(JaxRMNet(), memorize_every=cfg.TRAIN.MEMORIZE_EVERY, train_bn=True)
    _, bn = jax.jit(bn_apply.forward_video)(
        jax.device_put(rm_vars, repl), *(sharded[k] for k in ("frames", "masks", "flows",
                                                              "n_objects")))
    narrow = JaxApply(JaxRMNet(), memorize_every=1, n_bbox_loose_pixels=LOOSE)
    est = np.asarray(jax.jit(narrow.forward_video)(rm_vars, *(jnp.asarray(c) for c in clip)))
    return dict(rm_vars=rm_vars, loss=float(loss), grads=_flat(grads), stats=_stats(bn),
                narrow=est)


def _single_step(states, batch, train):
    trainer = Trainer(train_cfg(1, **train), *states, device="cpu")
    loss = trainer.train_step(batch, LR)
    return dict(loss=loss,
                grads={n: p.grad.numpy().copy() for n, p in trainer.rmnet.named_parameters()
                       if p.grad is not None},
                stats={k: v.numpy().copy() for k, v in trainer.apply.running_stats().items()})


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """The ranks' results (the 2 x 2 grid, the halo ops at 2 ranks, the
    narrow forward at 8), run in threads while this process runs the JAX
    programs, the port's single-process steps and its single forward."""
    batch, batch3 = _parallel_batch(), t3_batch()
    states = seeded_states(0)
    path = tmp_path_factory.mktemp("hybrid") / "rmnet.pth"
    torch.save(states[0], path)
    clip = build_clip()
    x = op_inputs()
    bn_args = bn_case(seed=1, shape=(4, 3, 5, 7))
    steps = {"parallel": (batch, VARIANTS, LR), "t3": (batch3, T3_VARIANTS, LR)}
    with ThreadPoolExecutor(2) as pool:
        def grid_then_narrow():
            ranks = launch(grid_work, (steps, x, (*bn_args, BN_SPLIT), _layout_batch()),
                           ["cpu"] * 4, "gloo", TIMEOUT_S, DEADLINE_S)
            narrow = launch(narrow_forward, (str(path), clip), ["cpu"] * 8, "gloo",
                            TIMEOUT_S, DEADLINE_S)
            return ranks, narrow

        runs = pool.submit(grid_then_narrow)
        halo2 = pool.submit(launch, halo_grads, (x,), ["cpu"] * 2, "gloo", TIMEOUT_S,
                            DEADLINE_S)
        single = {name: _single_step(states, batch, VARIANTS[name]) for name in VARIANTS}
        single.update({name: _single_step(states, batch3, T3_VARIANTS[name])
                       for name in T3_VARIANTS})
        model = RMNet()
        model.load_state_dict(states[0])
        apply = RMNetApply(model.eval(), memorize_every=1, n_bbox_loose_pixels=LOOSE)
        with torch.no_grad():
            narrow_single = apply.forward_video(*(torch.from_numpy(c) for c in clip[:3]),
                                                clip[3]).numpy()
        jax_out = _jax_hybrid(states, batch, clip)
        ranks, narrow = runs.result()
        halo = {2: halo2.result(), 4: [r["halo"] for r in ranks]}
    return dict(ranks=ranks, narrow=narrow, narrow_single=narrow_single, halo=halo, x=x,
                single=single, jax=jax_out, bn_args=bn_args)


def _grad_errors(got, want):
    """Per tensor ||got - want|| / ||want||, for the tensors past GRAD_REL
    and past the escape."""
    gmax = max(np.abs(g).max() for g in want.values())
    assert gmax > 0 and set(got) == set(want)
    bad = []
    for name in sorted(want):
        err, ref = np.linalg.norm(got[name] - want[name]), np.linalg.norm(want[name])
        if err > GRAD_REL * ref and np.abs(got[name] - want[name]).max() > ESCAPE * gmax:
            bad.append((name, float(err / (ref + 1e-30))))
    return bad


def _step(hybrid, name, rank=0):
    group = "t3" if name in T3_VARIANTS else "parallel"
    return hybrid["ranks"][rank][group][name]


@pytest.mark.parametrize("variant", ["dense", "flash"])
def test_grid_step_matches_the_jax_hybrid_mesh(hybrid, variant):
    """The port's 2 x 2 step against the JAX package's gradient on
    make_hybrid_mesh(2, 2) + hybrid_shard_batch, tests/test_parallel.py's
    shape and bar, with the port's read dense and flash."""
    rank0, want = _step(hybrid, variant), hybrid["jax"]
    np.testing.assert_allclose(rank0["loss"], want["loss"], rtol=LOSS_REL)
    grad_sd = {k: torch.from_numpy(v) for k, v in rank0["grads"].items()}
    for name, b in seeded_states(0)[0].items():  # statistics and counters: no gradient
        grad_sd.setdefault(name, torch.zeros_like(b) if b.is_floating_point() else b)
    tree, missing = import_state_dict(jax.tree_util.tree_map(np.zeros_like, want["rm_vars"]),
                                      grad_sd, "reference")
    assert not missing
    bad = _grad_errors(_flat(tree["params"]), want["grads"])
    assert not bad, f"{len(bad)} tensors off: {bad[:12]}"


@pytest.mark.parametrize("variant", ["dense", "flash", "t3", "t3_accum"])
def test_grid_step_matches_the_single_process_step(hybrid, variant):
    """Four ranks against the Trainer's step on the same global batch: the
    loss and every gradient at the JAX test's bar, the replicas
    bit-identical after Adam, one gradient all-reduce over the world, the
    loss's gathers over "space" (once per micro-batch, its backward local)
    and "data" (estimates and labels), the bank's and the estimate's gathers
    each with one backward; no JAX in the ranks."""
    rows = [_step(hybrid, variant, r) for r in range(4)]
    want = hybrid["single"][variant]
    assert len({r["loss"] for r in rows}) == 1
    np.testing.assert_allclose(rows[0]["loss"], want["loss"], rtol=LOSS_REL)
    bad = _grad_errors(rows[0]["grads"], want["grads"])
    assert not bad, f"{len(bad)} tensors off: {bad[:12]}"
    assert len({r["digest"] for r in rows}) == 1
    accum = (T3_VARIANTS.get(variant) or VARIANTS[variant]).get("GRAD_ACCUM_STEPS", 1)
    frames = (3 if variant.startswith("t3") else T) - 1
    counts = rows[0]["counts"]
    assert counts["world"]["gradients"] == 1
    assert counts["data"]["loss gather"] == 2 * accum
    space = counts["space"]
    assert space["loss gather"] == accum and "loss gather backward" not in space
    assert space["gather bank"] == space["gather bank backward"] == accum * frames
    assert space.get("gather estimate", 0) == space.get("gather estimate backward", 0) \
        == accum * (frames - 1)
    assert space["halo backward"] > 0
    assert not any(r["jax_imported"] for r in hybrid["ranks"])


def test_batch_norm_over_the_grid(hybrid):
    """Trainable BatchNorm: the statistics identical on every rank and
    within 2e-3 of the single step's and of the JAX hybrid mesh's, the loss
    within 2e-4 of the single step's, one collective per BatchNorm call on
    the world (the recompute of REMAT "encoders" repeats it) and one in the
    backward."""
    rows = [_step(hybrid, "bn", r) for r in range(4)]
    ref = rows[0]["stats"]
    assert len(ref) == 2 * 43 * 2
    for r in rows:
        assert r["digest"] == rows[0]["digest"]
        for k, v in ref.items():
            np.testing.assert_array_equal(r["stats"][k], v)
    for want in (hybrid["single"]["bn"]["stats"], hybrid["jax"]["stats"]):
        assert set(want) == set(ref)
        err = max(float(np.abs(ref[k] - w).max() / np.abs(w).max()) for k, w in want.items())
        assert err <= BN_STATS_REL, err
    np.testing.assert_allclose(rows[0]["loss"], hybrid["single"]["bn"]["loss"],
                               rtol=BN_LOSS_REL)
    world = rows[0]["counts"]["world"]
    assert world["batch norm"] == 2 * 2 * (T - 1) * 43
    assert world["batch norm backward"] == 2 * (T - 1) * 43


def test_batch_norm_layer_over_both_axes(hybrid):
    """BatchNorm2d in float64 on a batch of 4 rows split over "data" and 7
    columns split 4 / 3 over "space": its input's gradient, the weight's and
    bias's summed over the ranks, and the running statistics (n the sum of
    the ranks' unequal counts) those of torch's batch norm over the whole
    batch, to 1e-10."""
    x, cot, weight, bias, mean, var = hybrid["bn_args"]
    x, weight, bias = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    run_mean, run_var = mean.clone(), var.clone()
    (torch.nn.functional.batch_norm(x, run_mean, run_var, weight, bias, True, 0.1, 1e-5)
     * cot).sum().backward()
    ranks = hybrid["ranks"]
    close = dict(rtol=1e-10, atol=1e-10)
    got = np.concatenate([np.concatenate([ranks[2 * d + s]["bn"]["x_grad"] for s in range(2)],
                                         -1) for d in range(2)])
    np.testing.assert_allclose(got, x.grad.numpy(), **close)
    for name, want in (("weight_grad", weight.grad), ("bias_grad", bias.grad)):
        np.testing.assert_allclose(sum(r["bn"][name] for r in ranks), want.numpy(), **close)
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["stats"][0], run_mean.numpy(), **close)
        np.testing.assert_allclose(r["bn"]["stats"][1], run_var.numpy(), **close)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["conv7_s2_p3", "conv3_s1_p1", "conv3_s2_p1", "conv1_s2_p0",
                                "max_pool", "upsample2", "upsample4"])
def test_halo_op_gradient_matches_the_whole_op(hybrid, n, op):
    """The rank's input gradient is its columns of the whole op's, the
    parameters' gradients summed over the ranks are the whole op's: each
    halo's gradient is handed back to the rank that holds those columns."""
    t, cases = grad_cases(hybrid["x"])
    whole_x, whole_p = halo_op_grads(t, cases)[op]
    ranks = hybrid["halo"][n]
    got = np.concatenate([r["grads"][op][0] for r in ranks], -1)
    assert got.shape == whole_x.shape
    np.testing.assert_allclose(got, whole_x, rtol=0, atol=OP_REL * np.abs(whole_x).max())
    for k, v in whole_p.items():
        np.testing.assert_allclose(sum(r["grads"][op][1][k] for r in ranks), v, rtol=0,
                                   atol=OP_REL * np.abs(v).max())
    for r in ranks:  # a halo exchange forward and one backward, for every op but the 1x1
        assert r["counts"]["halo"] == r["counts"]["halo backward"] == len(cases) - 1


def test_width_gathers(hybrid):
    """On 4 ranks of a 24 x 60 frame (widths 14, 16, 16, 14; /16 grid one
    column each), rank r weighting the gathered value by (r + 1) times the
    column index: the value is the whole row on every rank; a summed gather
    hands each rank its columns of the sum over the ranks (10 times the
    index), a kept one its own weighting."""
    ranks = [r["gathers"] for r in hybrid["ranks"]]
    width = WidthMesh.build(DataMesh(0, 4, torch.device("cpu"), "gloo"), 24, 60)
    base = np.arange(2 * 3 * 60, dtype=np.float32).reshape(2, 3, 60)
    for rank, got in enumerate(ranks):
        lo, hi = width.unpadded_columns(rank)
        idx = np.arange(60, dtype=np.float32)[lo:hi]
        np.testing.assert_array_equal(got["unpadded_summed"][0], base)
        np.testing.assert_array_equal(got["unpadded_summed"][1],
                                      np.broadcast_to(10 * idx, (2, 3, hi - lo)))
        np.testing.assert_array_equal(got["unpadded_own"][1],
                                      np.broadcast_to((rank + 1) * idx, (2, 3, hi - lo)))
        np.testing.assert_array_equal(got["grid"][0], base[..., :4])
        np.testing.assert_array_equal(got["grid"][1], np.full((2, 3, 1), 10.0 * rank))


@pytest.mark.parametrize("cols", [(0, 3), (3, 5), (5, 8)])
def test_read_backward_of_a_query_shard(cols):
    """The plain flash read's backward for a query's columns against the
    whole bank: dQ is those columns of the whole read's dQ, at 2e-4."""
    mk, mv, q, valid, boxes = _read_case()
    d_out = torch.from_numpy(np.random.RandomState(9).standard_normal((3, 3, 8, 512))
                             .astype(np.float32))
    whole = _read_grads(mk, mv, q, valid, boxes, d_out)
    lo, hi = cols
    part = _read_grads(mk, mv, q[:, :, lo:hi], valid, boxes, d_out[:, :, lo:hi])
    np.testing.assert_allclose(part[2], whole[2][:, :, lo:hi], rtol=READ_TOL, atol=READ_TOL)


def test_read_backward_of_query_shards_sums_the_bank_gradient():
    """dK and dV of the three shards summed are the whole read's, at 2e-4."""
    mk, mv, q, valid, boxes = _read_case()
    d_out = torch.from_numpy(np.random.RandomState(9).standard_normal((3, 3, 8, 512))
                             .astype(np.float32))
    whole = _read_grads(mk, mv, q, valid, boxes, d_out)
    parts = [_read_grads(mk, mv, q[:, :, lo:hi], valid, boxes, d_out[:, :, lo:hi])
             for lo, hi in ((0, 3), (3, 5), (5, 8))]
    for i in (0, 1):
        np.testing.assert_allclose(sum(p[i] for p in parts), whole[i], rtol=READ_TOL,
                                   atol=READ_TOL)
        assert np.abs(whole[i]).max() > 0


def _read_grads(mk, mv, q, valid, boxes, d_out):
    mk, mv, q = (t.clone().requires_grad_(True) for t in (mk, mv, q.contiguous()))
    out, _ = flash_memory_read(mk, mv, q, valid, boxes)
    (out * d_out).sum().backward()
    return mk.grad.numpy(), mv.grad.numpy(), q.grad.numpy()


def test_hybrid_shard_batch_layout(hybrid):
    """World rank r sits at (r // 2, r % 2); its rows are rank_rows of its
    data index (one micro-batch: rows 2d, 2d+1; two: rows d, 2+d), the same
    on both ranks of a space group, each array at the whole width."""
    for rank, r in enumerate(hybrid["ranks"]):
        d, s = divmod(rank, 2)
        assert r["place"] == (d, s)
        for accum in (1, 2):
            got = r["layout"][accum]
            assert got["rows"] == rank_rows(B, 2, accum, d)
            assert got["shapes"] == {"frames": (2, T, H, W, 3), "masks": (2, T, K, H, W),
                                     "flows": (2, T, H, W, 2), "n_objects": (2, T)}


def test_grid_of_more_ranks_than_the_world_raises():
    world = DataMesh(0, 4, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="requested 8 devices, only 4"):
        make_hybrid_mesh(2, 4, world)
    with pytest.raises(ValueError, match="takes all ranks"):
        make_hybrid_mesh(1, 2, world)
    assert not world.counts


def _fake_grid(n_data=2, n_space=2):
    cpu = torch.device("cpu")
    return HybridMesh(DataMesh(0, n_data * n_space, cpu, "gloo"),
                      DataMesh(0, n_data, cpu, "gloo"), DataMesh(0, n_space, cpu, "gloo"))


def test_tinyflownet_on_a_grid_raises():
    """TinyFlowNet trains on a grid of its own /64 columns
    (tests/test_torch_hybrid_tfn.py); what still raises, before any
    collective, is a width mesh of another grid or frame size installed in
    it: RMNet's /16 mesh of the same frames."""
    trainer = Trainer(train_cfg(1, NETWORK="TinyFlowNet"), *seeded_states(0), device="cpu")
    grid = _fake_grid()
    width = WidthMesh.build(grid.space, H, W)
    frames = trainer.to_device(_parallel_batch())["frames"]
    with width.installed(trainer.tflownet), pytest.raises(ValueError, match="/16 grid"):
        trainer.tflownet.video_forward(frames)
    assert trainer.tflownet.space is None
    assert not any(m.counts for m in grid.meshes().values())


def test_training_where_a_space_rank_holds_no_column_raises():
    """A space rank without a column trains (tests/test_torch_hybrid_tfn.py);
    what still raises there, before any collective, is a halo wider than
    the narrowest shard: 48x64 on 8 space ranks leaves shards of one /16
    column, and a 5-wide kernel at /16 would read two columns of each
    neighbour."""
    space = WidthMesh.build(DataMesh(5, 8, torch.device("cpu"), "gloo"), H, W)
    assert space.grid[5] == (4, 4)
    x = torch.zeros(1, 4, H // 16, 0)
    with pytest.raises(ValueError, match=r"a halo of \(2, 2\) columns on shards as narrow"):
        space.conv2d(x, torch.zeros(4, 4, 5, 5), None, 1, 2)
    assert not space.mesh.counts


def test_narrow_width_on_8_ranks(hybrid):
    """48x64 on 8 ranks: 4 columns of the /16 grid, one each for ranks 0-3,
    none for ranks 4-7, which take part in every collective. Every rank's
    estimate of the whole clip is within 1e-4 of the port's single forward
    and of the JAX package's."""
    ranks = hybrid["narrow"]
    assert [r["grid"] for r in ranks] == [(0, 1), (1, 2), (2, 3), (3, 4)] + [(4, 4)] * 4
    for r in ranks:
        np.testing.assert_allclose(r["est"], hybrid["narrow_single"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["est"], hybrid["jax"]["narrow"], rtol=TOL, atol=TOL)
        assert r["counts"] == ranks[0]["counts"] and not r["jax_imported"]


def test_chip_smoke_holds_the_backward_at_the_hybrid_read():
    """Phase hybrid's read (465x465 padded to 480x480 on 2 space ranks: N = 2
    rows x 2 objects, the 30x30 bank of capacity 2 plus the ephemeral slot,
    rank 0's 30x15 query columns) is a forward and a backward case of
    chip_smoke.py in both types, each held twice for bit-identical results."""
    import chip_smoke

    cfg = chip_smoke._dp_cfg(1, {})
    crop = cfg.TRAIN.AUGMENTATION.CROP_HSIZE, cfg.TRAIN.AUGMENTATION.CROP_WSIZE
    width = WidthMesh.build(DataMesh(0, chip_smoke.HYBRID_GRID[1], torch.device("cpu"), "gloo"),
                            *crop)
    rows = cfg.TRAIN.BATCH_SIZE // chip_smoke.HYBRID_GRID[0]
    for name in ("hybrid_N6_S3_f32", "hybrid_N6_S3_bf16"):
        case = chip_smoke.KERNEL_CASES[name]
        assert case[:4] == (rows * cfg.TRAIN.N_MAX_OBJECTS, cfg.TRAIN.N_MAX_FRAMES, 30,
                            width.grid[-1][1])
        assert case[9] == width.grid[0]
        assert name in chip_smoke.BWD_CASES and name in chip_smoke.BWD_DETERMINISM_CASES
        assert name in chip_smoke.FWD_DETERMINISM_CASES
