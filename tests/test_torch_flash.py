"""The port's block-sparse memory read against the Pallas kernel.

On the CPU the plain PyTorch version of the CUDA kernel is compared with
``rmnet_tpu.ops.flash_attention`` in interpret mode on every case of
tests/test_flash_attention.py: ``out`` at 2e-4 (that file's tolerance),
``lse`` at 1e-4 where finite and +inf where the Pallas kernel gives +inf,
and the tile metadata (active tiles, z) equal to ``_tile_metadata`` at the
Pallas tile of 512. The public wrapper (kernel tile of 64 positions) must
give the same result. The plain versions of the forward's two CUDA kernels,
the partial (m, l, acc) of each contiguous share of the active list and the
fixed-order merge, are held to the same tolerances with 1, 2, 3 and more
splits than active tiles. The CUDA kernels themselves are held against the
plain version on the card by tests/test_torch_kernels_gpu.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rmnet_tpu.ops.flash_attention import _flash_fwd_impl, _tile_metadata

from rmnet_tpu_torch.ops.flash_attention import (
    MAX_SPLITS,
    flash_memory_read,
    flash_memory_read_reference,
    flash_read_fwd,
    flash_read_fwd_merge_reference,
    flash_read_fwd_partials_reference,
    fwd_splits,
    tile_metadata,
)

from tests.test_flash_attention import _boxed_case, _case

torch.set_num_threads(2)

PALLAS_TILE = 512


def _padded_capacity_case():
    mk, mv, qk, qv, valid, bboxes = _boxed_case(2, 3, 6, 10, 128, 128, 4)
    pad = 32 - 3
    return (np.pad(mk, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0))),
            np.pad(mv, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0))),
            qk, qv, np.pad(valid, ((0, 0), (0, pad))),
            np.pad(bboxes, ((0, 0), (0, pad), (0, 0))))


def _zero_query_case():
    mk, mv, qk, qv, valid = _case(1, 2, 4, 8, 128, 64, 2, invalidate=False)
    return mk, mv, np.zeros_like(qk), qv, valid, None


def _all_invalid_case():
    mk, mv, qk, qv, valid = _case(1, 2, 4, 8, 128, 64, 3, invalidate=False)
    return mk, mv, qk, qv, np.zeros_like(valid), None


def _fuzz_case(trial):
    rs = np.random.RandomState(11)
    for _ in range(trial + 1):
        N, S = int(rs.randint(1, 3)), int(rs.randint(1, 7))
        h, w = int(rs.randint(3, 12)), int(rs.randint(3, 20))
    return _boxed_case(N, S, h, w, 128, 128, seed=100 + trial)


CASES = {
    "dense_bank": lambda: _case(2, 3, 8, 16, 128, 512, 0) + (None,),
    "unaligned": lambda: _case(1, 2, 6, 10, 128, 512, 1) + (None,),
    "block_sparse": lambda: _boxed_case(3, 5, 8, 16, 128, 256, 3),
    "padded_capacity": _padded_capacity_case,
    "small_bank": lambda: _boxed_case(2, 3, 6, 10, 128, 128, 4),
    "zero_query": _zero_query_case,
    "all_invalid": _all_invalid_case,
    **{f"fuzz{t}": (lambda t=t: _fuzz_case(t)) for t in range(6)},
}


@functools.lru_cache(maxsize=None)
def _pallas_case(name):
    mk, mv, qk, _, valid, bboxes = CASES[name]()
    return _pallas(mk, mv, qk, valid, bboxes)


def _pallas(mk, mv, qk, valid, bboxes):
    out, lse = _flash_fwd_impl(
        jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(qk), jnp.asarray(valid),
        None if bboxes is None else jnp.asarray(bboxes), 16, PALLAS_TILE, True)
    Q = qk.shape[1] * qk.shape[2]
    return np.asarray(out), np.asarray(lse)[:, :Q, 0]


def _check(out, lse, out_ref, lse_ref):
    np.testing.assert_allclose(out, out_ref, rtol=2e-4, atol=2e-4)
    finite = np.isfinite(lse_ref)
    np.testing.assert_array_equal(np.isfinite(lse), finite)
    assert np.all(lse[~finite] == np.inf)
    np.testing.assert_allclose(lse[finite], lse_ref[finite], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_read_matches_pallas(name):
    mk, mv, qk, _, valid, bboxes = CASES[name]()
    N, S, h, w, _ = mk.shape
    out_ref, lse_ref = _pallas_case(name)

    tv, tb = torch.from_numpy(valid), None if bboxes is None else torch.from_numpy(bboxes)
    act, z, order, counts = tile_metadata(tv, tb, h, w, mt=PALLAS_TILE)
    _, act_j, z_j, _, _ = _tile_metadata(
        jnp.asarray(valid), None if bboxes is None else jnp.asarray(bboxes),
        N, S, h, w, 16, PALLAS_TILE)
    np.testing.assert_array_equal(act.numpy(), np.asarray(act_j))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_j))
    for n in range(N):  # compacted list: the active tiles in ascending order
        listed = order[n, :counts[n]].numpy()
        np.testing.assert_array_equal(listed, np.flatnonzero(np.asarray(act_j)[n]))

    out, lse = flash_memory_read_reference(
        torch.from_numpy(mk), torch.from_numpy(mv), torch.from_numpy(qk), tv,
        order, counts, z, mt=PALLAS_TILE)
    _check(out.numpy(), lse.numpy().reshape(N, -1), out_ref, lse_ref)

    # the wrapper on CPU tensors: the plain version at the kernel's tile
    out_k, lse_k = flash_memory_read(torch.from_numpy(mk), torch.from_numpy(mv),
                                     torch.from_numpy(qk), tv, tb)
    _check(out_k.numpy(), lse_k.numpy(), out_ref, lse_ref)


SPLITS = ("1", "2", "3", "more_than_tiles")


def _split_read(name, splits):
    """The plain split and merge (the forward's two kernels) on CASES[name]
    at the kernel tile -> (out, lse, z, counts, splits)."""
    mk, mv, qk, _, valid, bboxes = CASES[name]()
    N, S, h, w, _ = mk.shape
    tv, tb = torch.from_numpy(valid), None if bboxes is None else torch.from_numpy(bboxes)
    _, z, order, counts = tile_metadata(tv, tb, h, w)
    n = int(counts.max()) + 3 if splits == "more_than_tiles" else int(splits)
    m, l, acc = flash_read_fwd_partials_reference(
        torch.from_numpy(mk), torch.from_numpy(mv), torch.from_numpy(qk), tv, order, counts, n)
    out, lse = flash_read_fwd_merge_reference(m, l, acc, z, torch.float32)
    return out.reshape(N, h, w, -1), lse, (m, l), z, counts, n


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", list(CASES))
def test_split_and_merge_plain_versions_match_pallas(name, splits):
    """Partial (m, l, acc) per contiguous share of the active list, merged in
    order with z and the all-invalid guard, is the Pallas read at 2e-4."""
    out, lse, (m, l), _, counts, n = _split_read(name, splits)
    out_ref, lse_ref = _pallas_case(name)
    _check(out.numpy(), lse.numpy(), out_ref, lse_ref)
    # a split without tiles holds m = -1e30, l = 0
    share = [(int(c) * (s + 1) // n - int(c) * s // n) for c in counts for s in range(n)]
    empty = torch.tensor(share).reshape(len(counts), n) == 0
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    if splits == "more_than_tiles":
        assert bool(empty.any())


def test_split_cases_cover_skipped_mass_and_all_invalid_rows():
    """The cases above include rows whose skipped tiles hold valid positions
    (z > 0) and rows with no valid position at all (lse = +inf)."""
    zs, infinite = [], []
    for name in CASES:
        _, lse, _, z, _, _ = _split_read(name, "2")
        zs.append(int(z.max()))
        infinite.append(bool(torch.isinf(lse).all(dim=1).any()))
    assert max(zs) > 0 and any(infinite)


@pytest.mark.parametrize("shape, splits", [
    ((2, 1620, 836, 132), 5),   # the engine's read at 480p, S = 33, on an H100
    ((12, 900, 43, 132), 2),    # the training read, 465x465 crop, S = 3
    ((1, 60, 1, 132), 1),       # one tile: nothing to split
    ((1, 64, 10_000, 132), MAX_SPLITS),
])
def test_fwd_splits_follow_shapes_and_sm_count(shape, splits):
    assert fwd_splits(*shape) == splits


def test_cpu_wrapper_does_not_count_launches():
    mk, mv, qk, _, valid, bboxes = CASES["small_bank"]()
    before = flash_memory_read.launches
    flash_memory_read(*(torch.from_numpy(a) for a in (mk, mv, qk, valid, bboxes)))
    assert flash_memory_read.launches == before


def test_kernel_entry_takes_cuda_tensors_only():
    """No fallback below the wrapper: the kernel entry raises on CPU tensors."""
    mk, mv, qk, _, valid, bboxes = CASES["small_bank"]()
    t = [torch.from_numpy(a) for a in (mk, mv, qk, valid, bboxes)]
    _, z, order, counts = tile_metadata(t[3], t[4], *mk.shape[2:4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_read_fwd(*t[:4], order, counts, z)
