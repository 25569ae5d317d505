"""Width-sharded whole-clip inference (``spatial_forward_video``) through the
port against the JAX package's, on the CPU: gloo ranks splitting the width, each a
process started with ``spawn`` (rank functions in tests/torch_spatial_ranks.py,
which imports no JAX), a 60 s timeout on the group and a deadline on the
launch, so that a hang fails its test. One launch at 4 ranks and one at 2 do
all the rank work; the tests read their results.

Under the JAX mesh (tests/test_parallel.py:55-96) the width-sharded forward
is one GSPMD program equal to the single forward within 1e-4, and a second
call reuses the cached program bit for bit. The port's ranks each hold a
slice of the width and exchange every value that crosses a shard edge; held
to the same bars on the same clip (tests/test_rmnet_forward.py:22, B=1, T=3,
K=4, memorize_every=1, n_bbox_loose_pixels=8), with the JAX package's
seeded weights carried across by ``from_jax_variables``: against the JAX
``spatial_forward_video`` on the conftest's virtual CPU devices and against
the port's single ``forward_video``.

Each halo op is held against the same op on the whole tensor at 2 and 4
ranks (the rank's columns of the whole op's output): to 1e-6 for the
convolutions (the CPU's convolution may block an extended slice otherwise),
bit-identical for the pool, the upsamples, the boxes, their rasters and the
warp.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core.engine import build_models as jax_build_models
from rmnet_tpu.models.rmnet import RMNetApply as JaxApply
from rmnet_tpu.parallel import make_mesh
from rmnet_tpu.parallel.mesh import spatial_forward_video as jax_spatial_forward_video

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply, _dense_read
from rmnet_tpu_torch.models.weights import from_jax_variables
from rmnet_tpu_torch.ops.att_map import _bboxes, _raster_small, regional_attention_small
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read
from rmnet_tpu_torch.ops.warp import backward_warp
from rmnet_tpu_torch.parallel import DataMesh, launch
from rmnet_tpu_torch.parallel.mesh import spatial_forward_video
from rmnet_tpu_torch.parallel.space import WidthMesh, column_split

from tests.test_rmnet_forward import LOOSE, build_clip
from tests.torch_spatial_ranks import OPS_HW, op_cases, op_inputs, spatial_forward

torch.set_num_threads(2)

RANKS = (4, 2)
TOL = 1e-4  # tests/test_parallel.py:84
CONV_TOL = 1e-6
TIMEOUT_S, DEADLINE_S = 60, 300


def _launch(n, state_path, clip, x):
    return launch(spatial_forward, (state_path, clip, x), ["cpu"] * n, "gloo", TIMEOUT_S,
                  DEADLINE_S)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """The ranks' results at 4 and 2 ranks (run in threads, while this
    process runs the JAX spatial forward at 4 and 2 devices and the port's
    single forward), the inputs of the halo ops and the port's model."""
    clip = build_clip()
    x = op_inputs()
    _, _, rm_vars, _ = jax_build_models(JaxConfig(), 0)
    rm_vars = jax.tree_util.tree_map(np.asarray, rm_vars)
    state, _ = from_jax_variables(rm_vars, {})
    path = tmp_path_factory.mktemp("spatial") / "rmnet.pth"
    torch.save(state, path)
    with ThreadPoolExecutor(len(RANKS)) as pool:
        runs = {n: pool.submit(_launch, n, path, clip, x) for n in RANKS}
        model = RMNet()
        model.load_state_dict(state)
        model.eval()
        apply = RMNetApply(model, memorize_every=1, n_bbox_loose_pixels=LOOSE)
        with torch.no_grad():
            single = apply.forward_video(*(torch.from_numpy(c) for c in clip[:3]),
                                         clip[3]).numpy()
            model64 = RMNet().double()
            model64.load_state_dict(state)
            bn_est, bn = dataclasses.replace(apply, model=model64.eval(), train_bn=True
                                             ).forward_video(
                *(torch.from_numpy(c).double() for c in clip[:3]), clip[3])
        single_bn = (bn_est.numpy(), {k: v.numpy() for k, v in bn.items()})
        jax_apply = JaxApply(jax_build_models(JaxConfig(), 0)[0], memorize_every=1,
                             n_bbox_loose_pixels=LOOSE)
        jax_est = {n: np.asarray(jax_spatial_forward_video(
            jax_apply, rm_vars, *(jnp.asarray(c) for c in clip),
            mesh=make_mesh(n, axis_name="space"))) for n in RANKS}
        ranks = {n: f.result() for n, f in runs.items()}
    return dict(ranks=ranks, single=single, single_bn=single_bn, jax=jax_est, x=x, apply=apply)


@pytest.mark.parametrize("n", RANKS)
def test_spatial_forward_matches_the_jax_mesh_and_the_single_forward(spatial, n):
    """Every rank returns the whole clip's estimate: within 1e-4 of the JAX
    spatial_forward_video on n devices and of the port's forward_video."""
    for r in spatial["ranks"][n]:
        assert r["est"].shape == spatial["single"].shape
        np.testing.assert_allclose(r["est"], spatial["jax"][n], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["est"], spatial["single"], rtol=TOL, atol=TOL)
        assert not r["jax_imported"]


@pytest.mark.parametrize("n", RANKS)
def test_repeated_call_builds_nothing(spatial, n):
    """The first call caches its plan (one entry), the second adds none and
    gives a bit-identical estimate; no module keeps the width mesh after a
    call."""
    for r in spatial["ranks"][n]:
        assert r["plans"] == [0, 1, 1]
        np.testing.assert_array_equal(r["again"], r["est"])
        assert r["hooks_left"] == 0


@pytest.mark.parametrize("n", RANKS)
def test_activations_are_width_slices(spatial, n):
    """Each encoder stage's output on a rank holds the rank's columns only:
    the 48x64 clip's 4 columns of the /16 grid, 4 / n a rank, at /4, /8,
    /16; and the collectives of the 2-frame forward, by kind: 49 halos a
    frame (15 a trunk, 1 for both KeyValue heads of a frame's two calls,
    6 for the decoder's skips, 11 in from_skips), one bank and one
    estimate gather a frame, 2 box reductions a box (memorize's and the
    warped mask's) and the objects present (frame 0 and each frame)."""
    per = 4 // n
    want = {f"{enc}.{stage}": [per * scale] for enc in ("encoder_memory", "encoder_query")
            for stage, scale in (("res2", 4), ("res3", 2), ("res4", 1))}
    for r in spatial["ranks"][n]:
        assert r["widths"] == want
        calls = {k: v[0] for k, v in r["counts"].items()}
        assert calls == {"halo": 2 * 49, "gather bank": 2, "gather estimate": 2,
                         "box points": 4, "box extremes": 4, "objects max": 3}


def _whole_ops(x):
    """Each halo op of the ranks' cases on the whole tensor."""
    t, cases = op_cases(x)
    return {name: fn(t[src], None).numpy() for name, (fn, src) in cases.items()}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("op", ["conv7_s2_p3", "conv3_s1_p1", "conv3_s2_p1", "conv1_s2_p0",
                                "max_pool", "upsample2", "upsample4"])
def test_halo_op_matches_the_whole_op(spatial, n, op):
    """The rank's output is its columns of the op on the whole tensor."""
    whole = _whole_ops(spatial["x"])[op]
    got = [r["ops"][op] for r in spatial["ranks"][n]]
    assert sum(g.shape[-1] for g in got) == whole.shape[-1]
    tol = CONV_TOL if op.startswith("conv") else 0.0
    np.testing.assert_allclose(np.concatenate(got, -1), whole, rtol=tol, atol=tol)


@pytest.mark.parametrize("n", RANKS)
def test_box_reductions_match_the_whole_mask(spatial, n):
    """The boxes reduced over the ranks are the whole mask's (object 1 lies
    in the first ranks' columns only; object 2 has too few points; an
    all-zero mask keeps the sentinels on every rank and gives the
    whole-frame box); each rank's raster is its columns of the whole map."""
    x = spatial["x"]
    masks = torch.from_numpy(x["masks"])
    H, W = OPS_HW
    width = WidthMesh.build(DataMesh(0, n, torch.device("cpu"), "gloo"), H, W)
    lw, uw, lh, uh = width.pads
    padded = torch.nn.functional.pad(masks, (lw, uw, lh, uh))
    hw16 = (padded.shape[-2] // 16, padded.shape[-1] // 16)
    ranks = spatial["ranks"][n]
    for name, whole, offset in (("padded", padded, (0, 0)), ("frame", masks, (lh, lw))):
        att, boxes = regional_attention_small(whole, hw16, offset, 16, 0.5, 10, LOOSE)
        for r in ranks:
            np.testing.assert_array_equal(r["ops"][f"boxes_{name}"], boxes.numpy())
        np.testing.assert_array_equal(
            np.concatenate([r["ops"][f"raster_{name}"] for r in ranks], -1), att.numpy())
    whole_box = _bboxes(masks[:, :2] * 0, 0.5, 10, LOOSE).numpy()
    assert (whole_box[:, 1] == [0, W - 1, 0, H - 1]).all()  # too few points: the whole frame
    for r in ranks:
        np.testing.assert_array_equal(r["ops"]["boxes_no_hit"], whole_box)


@pytest.mark.parametrize("n", RANKS)
def test_warp_of_a_shard_matches_the_whole_warp(spatial, n):
    """Each rank warps its own columns out of the whole image, its flow
    pointing up to 40 columns away (across two shards at 4 ranks): its
    columns of the whole warp and validity, bit for bit."""
    x = spatial["x"]
    warped, valid = backward_warp(torch.from_numpy(x["image"]), torch.from_numpy(x["flow"]))
    ranks = spatial["ranks"][n]
    assert np.abs(x["flow"][..., 0]).max() > 32
    np.testing.assert_array_equal(np.concatenate([r["ops"]["warp"] for r in ranks], 2),
                                  warped.numpy())
    np.testing.assert_array_equal(np.concatenate([r["ops"]["warp_valid"] for r in ranks], 2),
                                  valid.numpy())


def _read_case(seed=0, N=3, S=4, h=3, w=8):
    rs = np.random.RandomState(seed)
    mk = torch.from_numpy(rs.standard_normal((N, S, h, w, 128)).astype(np.float32))
    mv = torch.from_numpy(rs.standard_normal((N, S, h, w, 512)).astype(np.float32))
    q = torch.from_numpy(rs.standard_normal((N, h, w, 128)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(N, S) > 0.3)
    valid[:, -1] = True
    boxes = torch.tensor([[[0, 16 * w - 1, 0, 16 * h - 1], [20, 60, 0, 30], [0, 15, 16, 40],
                           [40, 127, 10, 47]]] * N, dtype=torch.int32)[:, :S]
    # zero outside the boxes, as memorize leaves the bank
    slot1 = torch.stack([torch.zeros_like(boxes), boxes], dim=2).reshape(N * S, 2, 4)
    keep = _raster_small(slot1, (h, w), (0, 0), 16, torch.float32)[:, 1]
    keep = keep.reshape(N, S, h, w, 1)
    return mk * keep, mv * keep, q, valid, boxes


@pytest.mark.parametrize("cols", [(0, 3), (3, 8), (5, 6)])
def test_read_of_a_query_shard_matches_the_whole_read(cols):
    """The plain flash read and the dense read of a query's columns against
    the whole bank: those columns of the whole read, to 1e-6."""
    mk, mv, q, valid, boxes = _read_case()
    lo, hi = cols
    whole, whole_lse = flash_memory_read(mk, mv, q, valid, boxes)
    part, part_lse = flash_memory_read(mk, mv, q[:, :, lo:hi].contiguous(), valid, boxes)
    np.testing.assert_allclose(part.numpy(), whole[:, :, lo:hi].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(part_lse.numpy(),
                               whole_lse.reshape(q.shape[:3])[:, :, lo:hi].reshape(3, -1),
                               rtol=1e-6, atol=1e-6)
    dense, p = _dense_read(mk, mv, q, valid)
    dense_part, p_part = _dense_read(mk, mv, q[:, :, lo:hi], valid)
    np.testing.assert_allclose(dense_part.numpy(), dense[:, :, lo:hi].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert p_part.shape == (3, 4 * 3 * 8, 3 * (hi - lo))
    np.testing.assert_allclose(dense_part.numpy(), part.numpy(), rtol=2e-4, atol=2e-4)


def test_training_under_a_width_mesh_raises(spatial):
    """A data-parallel mesh on ``apply`` raises before any collective: to
    split the batch too is the hybrid grid's training step. Trainable
    BatchNorm takes the statistics of the whole frames: every rank's
    estimate and running statistics are the single forward_video's, in
    float64 (in float32, E[x^2] - mean^2 loses digits to cancellation, and
    this clip's estimate moves by 1e-2 when only the order of the sums
    changes: a box flips): the estimate within 1e-4, the statistics within
    1e-8 of each tensor's largest value."""
    import dataclasses

    mesh = DataMesh(0, 2, torch.device("cpu"), "gloo")
    clip = build_clip()
    apply = spatial["apply"]
    bad = dataclasses.replace(apply, mesh=DataMesh(0, 2, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="hybrid"):
        spatial_forward_video(bad, *clip, mesh)
    assert not mesh.counts
    est, bn = spatial["single_bn"]
    for n in RANKS:
        for r in spatial["ranks"][n]:
            np.testing.assert_allclose(r["bn_est"], est, rtol=TOL, atol=TOL)
            assert set(r["bn"]) == set(bn) and len(bn) == 2 * 43 * 2
            err = max(float(np.abs(r["bn"][k] - v).max() / np.abs(v).max())
                      for k, v in bn.items())
            assert err <= 1e-8, err


@pytest.mark.parametrize("n,want", [(2, [(0, 27), (27, 54)]),
                                    (4, [(0, 14), (14, 28), (28, 41), (41, 54)])])
def test_column_split_of_480x854(n, want):
    """854 columns padded to 864: 54 columns of the /16 grid, as even as the
    ranks divide them; only the edge ranks hold padding (5 columns each)."""
    assert column_split(54, n) == want
    width = WidthMesh.build(DataMesh(0, n, torch.device("cpu"), "gloo"), 480, 854)
    assert width.grid == tuple(want) and width.pads == (5, 5, 0, 0)
    spans = [width.unpadded_columns(r) for r in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == 854
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # fewer columns than ranks: the last ranks hold none
    assert column_split(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]


def test_halo_wider_than_a_shard_raises():
    width = WidthMesh.build(DataMesh(1, 4, torch.device("cpu"), "gloo"), 48, 64)
    x = torch.zeros(1, 2, 3, 1)  # a /16 tensor: one column a rank
    with pytest.raises(ValueError, match="halo"):
        width.halo(x, 2, 0, 0.0)
    assert not width.mesh.counts


def test_chip_smoke_holds_the_kernel_at_the_spatial_read():
    """Phase spatial's read (480x854 on 2 ranks, 2 objects, T=12: N=2 rows,
    the 30x54 bank of capacity 11 plus the ephemeral slot, rank 0's 30x27
    query columns) is a forward and a backward case of chip_smoke.py in both
    types, each held twice for bit-identical results."""
    import chip_smoke

    width = WidthMesh.build(DataMesh(0, 2, torch.device("cpu"), "gloo"),
                            chip_smoke.HEIGHT, chip_smoke.WIDTH)
    for name in ("spatial_S12_f32", "spatial_S12_bf16"):
        case = chip_smoke.KERNEL_CASES[name]
        assert case[:4] == (chip_smoke.N_OBJECTS, chip_smoke.SPATIAL_T, 30,
                            width.grid[-1][1])
        assert case[9] == width.grid[0]
        assert name in chip_smoke.FWD_DETERMINISM_CASES
        assert name not in chip_smoke.FWD_ONLY_CASES and name in chip_smoke.BWD_CASES
        assert name in chip_smoke.BWD_DETERMINISM_CASES
