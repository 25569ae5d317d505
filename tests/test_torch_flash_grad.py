"""The port's differentiable block-sparse read against the Pallas read's VJP.

On the CPU, ``flash_memory_read`` runs the plain versions of both kernels
(forward, and the backward over the listed active tiles with the skipped
tiles' closed form merged in torch). Its gradients of ``sum(out * wgt)``
with respect to the memory keys, values and the query keys are held against
``jax.vjp`` of ``rmnet_tpu.ops.flash_attention.flash_memory_read`` in
interpret mode, on the cases of tests/test_flash_attention.py:242-317 (plain
bank, boxes with skipped tiles, four fuzzed geometries, all slots invalid),
at rtol 1e-4 / atol 1e-5 (2e-4 / 2e-5 on the fuzz, that file's tolerances),
and against torch autograd of the port's dense read. The CUDA kernel itself
is held against the plain backward on the card (tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmnet_tpu.ops.flash_attention import flash_memory_read as jax_flash_read

from rmnet_tpu_torch.models.rmnet import _dense_read
from rmnet_tpu_torch.ops.flash_attention import (
    flash_memory_read,
    flash_read_bwd,
    flash_read_bwd_reference,
    tile_metadata,
)

from tests.test_flash_attention import _boxed_case, _case

torch.set_num_threads(2)


def _fuzz_case(trial):
    rs = np.random.RandomState(21)
    for _ in range(trial + 1):
        N, S = int(rs.randint(1, 3)), int(rs.randint(1, 6))
        h, w = int(rs.randint(3, 10)), int(rs.randint(3, 16))
    return _boxed_case(N, S, h, w, 128, 128, seed=300 + trial)


def _all_invalid_case():
    mk, mv, qk, qv, valid = _case(1, 2, 4, 8, 128, 64, 9, invalidate=False)
    return mk, mv, qk, qv, np.zeros_like(valid), None


# name -> (case, weight seed, rtol, atol)
CASES = {
    "plain": (lambda: _case(2, 3, 8, 16, 128, 256, 5) + (None,), 7, 1e-4, 1e-5),
    "block_sparse": (lambda: _boxed_case(2, 5, 8, 16, 128, 128, 6), 7, 1e-4, 1e-5),
    **{f"fuzz{t}": ((lambda t=t: _fuzz_case(t)), 400 + t, 2e-4, 2e-5) for t in range(4)},
    "all_invalid": (_all_invalid_case, 7, 1e-4, 1e-5),
}


def _port_grads(read, mk, mv, qk, valid, bboxes, wgt):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (mk, mv, qk)]
    b = None if bboxes is None else torch.from_numpy(bboxes)
    out, _ = read(*t, torch.from_numpy(valid), b)
    (out * torch.from_numpy(wgt)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def _jax_grads(mk, mv, qk, valid, bboxes, wgt):
    b = None if bboxes is None else jnp.asarray(bboxes)
    out, vjp = jax.vjp(
        lambda k, v, q: jax_flash_read(k, v, q, jnp.asarray(valid), b, interpret=True),
        jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(qk))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(wgt))]


@pytest.mark.parametrize("name", list(CASES))
def test_flash_read_gradient_matches_pallas_vjp(name):
    make, seed, rtol, atol = CASES[name]
    mk, mv, qk, _, valid, bboxes = make()
    wgt = np.random.RandomState(seed).randn(*qk.shape[:-1], mv.shape[-1]).astype(np.float32)
    out, grads = _port_grads(flash_memory_read, mk, mv, qk, valid, bboxes, wgt)
    out_j, grads_j = _jax_grads(mk, mv, qk, valid, bboxes, wgt)
    np.testing.assert_allclose(out, out_j, rtol=2e-4, atol=2e-4)
    for gname, g, gj in zip(("d_mkey", "d_mval", "d_qkey"), grads, grads_j):
        assert np.all(np.isfinite(g)), gname
        np.testing.assert_allclose(g, gj, rtol=rtol, atol=atol, err_msg=gname)
    if name == "all_invalid":  # lse = +inf everywhere: finite zeros, no NaN
        for g in grads:
            np.testing.assert_array_equal(g, np.zeros_like(g))
    else:
        assert sum(float(np.abs(g).sum()) for g in grads_j) > 0
        # and the same gradient as torch autograd of the dense read
        _, grads_d = _port_grads(lambda k, v, q, s, b: _dense_read(k, v, q, s), mk, mv,
                                 qk, valid, bboxes, wgt)
        for gname, g, gd in zip(("d_mkey", "d_mval", "d_qkey"), grads, grads_d):
            np.testing.assert_allclose(g, gd, rtol=rtol, atol=atol, err_msg=gname)


def test_skipped_tiles_carry_gradient():
    """The block-sparse case has valid out-of-box positions in skipped tiles:
    their dK comes from the closed form alone and is nonzero."""
    mk, mv, qk, _, valid, bboxes = _boxed_case(2, 5, 8, 16, 128, 128, 6)
    N, S, h, w, _ = mk.shape
    tile_active, _, _, _ = tile_metadata(torch.from_numpy(valid), torch.from_numpy(bboxes), h, w)
    skipped = ~tile_active.repeat_interleave(64, dim=1)[:, :S * h * w].numpy()
    skipped &= np.repeat(valid, h * w, axis=1)
    assert skipped.any()
    wgt = np.random.RandomState(7).randn(N, h, w, mv.shape[-1]).astype(np.float32)
    _, (dmk, _, _) = _port_grads(flash_memory_read, mk, mv, qk, valid, bboxes, wgt)
    assert np.abs(dmk.reshape(N, -1, 128)[skipped]).min() > 0


def test_backward_plain_version_lists_active_tiles_only():
    """The backward's plain version writes dK/dV only on listed active
    tiles (the kernel's contract); an empty list gives zeros and leaves dQ 0."""
    mk, mv, qk, _, valid, bboxes = _boxed_case(1, 3, 6, 10, 128, 128, 4)
    t = [torch.from_numpy(a) for a in (mk, mv, qk, valid, bboxes)]
    h, w = mk.shape[2:4]
    _, _, order, counts = tile_metadata(t[3], t[4], h, w)
    rs = np.random.RandomState(0)
    d_out = torch.from_numpy(rs.randn(1, h, w, 128).astype(np.float32))
    lse = torch.from_numpy(rs.rand(1, h * w).astype(np.float32)) + 3.0
    delta = torch.from_numpy(rs.randn(1, h * w).astype(np.float32))
    args = (*t[:4], order, counts, d_out, lse, delta)
    dq, dk_t, dv_t = flash_read_bwd_reference(*args)
    listed = np.zeros(order.shape[1], bool)
    listed[order[0, :counts[0]].numpy()] = True
    rows = np.repeat(listed, 64)
    assert np.abs(dk_t[0, ~rows].numpy()).max(initial=0.0) == 0.0
    assert np.abs(dv_t[0, rows].numpy()).max() > 0
    dq0, dk0, dv0 = flash_read_bwd_reference(*t[:4], order, torch.zeros_like(counts),
                                             d_out, lse, delta)
    for g in (dq0, dk0, dv0):
        assert float(g.abs().max()) == 0.0


def test_cpu_backward_does_not_count_launches():
    mk, mv, qk, _, valid, bboxes = _boxed_case(1, 3, 6, 10, 128, 128, 4)
    wgt = np.ones((1, 6, 10, 128), np.float32)
    before = flash_read_bwd.launches
    _port_grads(flash_memory_read, mk, mv, qk, valid, bboxes, wgt)
    assert flash_read_bwd.launches == before


def test_backward_kernel_entry_takes_cuda_tensors_only():
    """No fallback below the Function: the kernel entry raises on CPU tensors."""
    mk, mv, qk, _, valid, bboxes = _boxed_case(1, 3, 6, 10, 128, 512, 4)
    t = [torch.from_numpy(a) for a in (mk, mv, qk, valid, bboxes)]
    h, w = mk.shape[2:4]
    _, _, order, counts = tile_metadata(t[3], t[4], h, w)
    d_out = torch.zeros(1, h, w, 512)
    lse = delta = torch.zeros(1, h * w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_read_bwd(*t[:4], order, counts, d_out, lse, delta)
