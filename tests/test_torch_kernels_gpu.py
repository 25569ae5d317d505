"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor rmnet_tpu, so it runs where only PyTorch is
installed; tests/conftest.py imports JAX, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Each test skips without a CUDA device. The cases and the comparisons are
chip_smoke.py's. The engine's CUDA graphs (``graphed_vs_eager``,
``check_update_weights``): on a 12-frame 480x854 clip whose 2-slot ring
wraps, the graphed engine's probabilities and labels are bit-identical to
the engine's chunk function run eagerly, at bf16 and at f32, the forward
launches replayed equal the chunk steps, and new weights reach the
captured graphs. Forward (``KERNEL_CASES``, ``compare_read``; main and
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

from chip_smoke import (BWD_CASES, FWD_DETERMINISM_CASES, GRAPH_T, HEIGHT, KERNEL_CASES,
                        N_OBJECTS, WIDTH, bank_case, bwd_case, check_bwd_deterministic,
                        check_fwd_deterministic, check_update_weights, compare_bwd, compare_read,
                        graph_engine, graphed_vs_eager, make_clip)
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _models(seed=0):
    from rmnet_tpu_torch.models.weights import build_models

    rmnet, tfn = build_models(seed=seed)
    return rmnet.state_dict(), tfn.state_dict()


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_graphed_engine_matches_the_eager_chunk(dtype):
    """Bit-identical probabilities and labels; forward launches replayed =
    chunk steps (checked inside ``counted``)."""
    _cuda()
    eng = graph_engine(_models(), dtype)
    graphed_vs_eager(eng, make_clip(GRAPH_T, HEIGHT, WIDTH, N_OBJECTS), str(dtype))


@pytest.mark.gpu
def test_update_weights_reaches_the_captured_graphs():
    _cuda()
    eng = graph_engine(_models(), torch.float32)
    clip = make_clip(GRAPH_T, HEIGHT, WIDTH, N_OBJECTS)
    check_update_weights(eng, clip, eng.run_video(*clip))
