"""What the kernels' builds read and what their entry points take, on the CPU
(no nvcc needed): the build tag of each kernel library (the reads', the
phase stamp's) covers its source, every header beside it and nothing else;
every quoted include of a kernel source names a header that the tag covers;
the kernel entry points refuse CPU tensors; the bf16 forward's tensor maps
refuse a bank whose slots do not follow each other; the backward probe's
patches still apply to the sources."""

import re
import shutil

import pytest
import torch

from chip_bwd_probe import SOURCE, VARIANTS, write_variant
from rmnet_tpu_torch.ops.flash_attention import (
    _CSRC,
    BWD_LIBRARY,
    LIBRARY,
    _Library,
    flash_memory_read,
    flash_read_bwd,
    flash_read_fwd,
    tile_metadata,
    tma_bank_refusal,
)
from rmnet_tpu_torch.utils.profiling import STAMP_LIBRARY

LIBRARIES = {lib.name: lib for lib in (LIBRARY, BWD_LIBRARY, STAMP_LIBRARY)}


def _copy(tmp_path, name):
    csrc = tmp_path / "csrc"
    shutil.copytree(_CSRC, csrc)
    return csrc, _Library(name, LIBRARIES[name].argtypes, csrc=csrc)


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_tag_is_the_checkout_tag_for_an_identical_copy(tmp_path, name):
    _, lib = _copy(tmp_path, name)
    assert lib.tag() == LIBRARIES[name].tag() == lib.tag()


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_tag_changes_when_a_header_changes(tmp_path, name):
    csrc, lib = _copy(tmp_path, name)
    before = lib.tag()
    header = csrc / "mma_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = lib.tag()
    assert edited != before
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert lib.tag() not in (before, edited)


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_tag_changes_with_its_own_source_only(tmp_path, name):
    csrc, lib = _copy(tmp_path, name)
    before = lib.tag()
    other = next(n for n in LIBRARIES if n != name)
    (csrc / f"{other}.cu").write_text("// another kernel's source\n")
    assert lib.tag() == before
    lib.source.write_text(lib.source.read_text() + "\n// edited\n")
    assert lib.tag() != before


def test_quoted_includes_are_headers_the_tag_covers():
    headers = {p.name for p in _CSRC.glob("*.cuh")}
    for source in _CSRC.glob("*.cu"):
        for included in re.findall(r'^#include "([^"]+)"', source.read_text(), re.M):
            assert included in headers, f"{source.name} includes {included}"
    assert {"mma_tf32.cuh", "mma_bf16.cuh"} <= headers


def _cpu_read():
    g = torch.Generator().manual_seed(0)
    N, S, h, w = 1, 3, 6, 10
    mk = torch.randn(N, S, h, w, 128, generator=g)
    mv = torch.randn(N, S, h, w, 512, generator=g)
    qk = torch.randn(N, h, w, 128, generator=g)
    valid = torch.ones(N, S, dtype=torch.bool)
    _, z, order, counts = tile_metadata(valid, None, h, w)
    return mk, mv, qk, valid, order, counts, z


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_kernel_entries_refuse_cpu_tensors_without_counting(entry):
    mk, mv, qk, valid, order, counts, z = _cpu_read()
    if entry == "forward":
        fn, args, counted = flash_read_fwd, (mk, mv, qk, valid, order, counts, z), flash_memory_read
    else:
        d_out, lse = torch.zeros(1, 6, 10, 512), torch.zeros(1, 60)
        fn, args = flash_read_bwd, (mk, mv, qk, valid, order, counts, d_out, lse, lse)
        counted = flash_read_bwd
    before = counted.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)
    assert counted.launches == before


def _ring_view():
    """5 slots of an 8-slot ring, as the engine hands its bank to the read."""
    return torch.zeros(2, 8, 7, 9, 128)[:, 2:7]


def _padded_slots():
    """Slots 8 positions apart beyond their 7 x 9: (h, w) stays one linear
    axis, but the slots are not one axis with it."""
    return torch.zeros(2, 5, 7 * 9 + 8, 128)[:, :, :63].view(2, 5, 7, 9, 128)


@pytest.mark.parametrize("bank, refused", [
    (lambda: torch.zeros(2, 5, 7, 9, 128), False),
    (_ring_view, False),
    (lambda: torch.zeros(3, 1, 7, 9, 512), False),       # one slot: nothing to follow
    (lambda: _padded_slots()[:, :1], False),
    (_padded_slots, True),
    (lambda: torch.zeros(2, 12, 7, 9, 512)[:, ::2], True),  # every other slot
], ids=["contiguous", "ring_view", "one_slot", "padded_one_slot", "padded_slots",
        "strided_slots"])
def test_bf16_tensor_maps_take_banks_whose_slots_follow_each_other(bank, refused):
    t = bank()
    refusal = tma_bank_refusal(t.shape, t.stride())
    assert (refusal is not None) == refused
    if refused:
        assert "one position axis" in refusal


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_probe_variant_patches_a_copy_of_the_backward_source(tmp_path, variant):
    source = write_variant(variant, tmp_path / variant)
    for file in VARIANTS[variant]:
        assert (source.parent / file).read_text() != (_CSRC / file).read_text()
    assert source.name == SOURCE and source.parent != _CSRC
