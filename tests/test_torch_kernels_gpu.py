"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor rmnet_tpu, so it runs where only PyTorch is
installed; tests/conftest.py imports JAX, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Each test skips without a CUDA device. The cases and the comparisons are
chip_smoke.py's. Forward (``KERNEL_CASES``, ``compare_read``; main and
merge kernels, against the plain read and the plain split and merge): f32 at
2e-4 (the read's tolerance in tests/test_flash_attention.py), bf16 within
1e-2 of the plain output's largest magnitude, ``lse`` at 2e-4 where finite
and +inf on the same rows. Backward (``BWD_CASES``, ``compare_bwd``): dQ, dK
and dV each within 1e-4 (f32) or 1e-2 (bf16) of the plain gradient's largest
magnitude. Both count one launch per call. Two forward calls
(``check_fwd_deterministic``, bf16 at the engine's shape and f32 at the
training read) and two backward calls on the f32 training read
(``check_bwd_deterministic``) give bit-identical results.
"""

import pytest
import torch

from chip_smoke import (BWD_CASES, FWD_DETERMINISM_CASES, KERNEL_CASES, bank_case, bwd_case,
                        check_bwd_deterministic, check_fwd_deterministic, compare_bwd,
                        compare_read)
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_flash_read_kernel_matches_plain_version(name):
    _cuda()
    compare_read(name, bank_case(*KERNEL_CASES[name]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", FWD_DETERMINISM_CASES)
def test_flash_read_kernel_is_deterministic(name):
    _cuda()
    check_fwd_deterministic(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BWD_CASES))
def test_flash_read_bwd_kernel_matches_plain_version(name):
    _cuda()
    compare_bwd(name, bwd_case(name))


@pytest.mark.gpu
def test_flash_read_bwd_kernel_is_deterministic():
    _cuda()
    check_bwd_deterministic("train_S3_f32")


@pytest.mark.gpu
def test_flash_read_kernel_reads_the_bank_through_its_strides():
    """A strided view into a larger bank (the engine hands the kernel views
    of its ring, never a copy) reads the same as a contiguous copy."""
    _cuda()
    c = bank_case(2, 9, 6, 10, torch.float32, 7, invalid=(8,), loose=16)
    bank_k = torch.zeros(2, 12, 6, 10, 128, device="cuda")
    bank_v = torch.zeros(2, 12, 6, 10, 512, device="cuda")
    bank_k[:, 2:11] = c.pop("m_key")
    bank_v[:, 2:11] = c.pop("m_val")
    view_k, view_v = bank_k[:, 2:11], bank_v[:, 2:11]
    assert not view_k.is_contiguous() and not view_v.is_contiguous()
    out_view, lse_view = flash_memory_read(view_k, view_v, **c)
    out_copy, lse_copy = flash_memory_read(view_k.contiguous(), view_v.contiguous(), **c)
    torch.cuda.synchronize()
    assert torch.equal(out_view, out_copy) and torch.equal(lse_view, lse_copy)
