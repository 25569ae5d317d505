"""What the kernels' builds read and what their entry points take, on the CPU
(no nvcc needed): the build tag of each kernel library (the reads', the
phase stamp's) covers its source, every header beside it and nothing else;
every quoted include of a kernel source names a header that the tag covers;
the kernel entry points refuse CPU tensors; the backward probe's patches
still apply to the sources."""

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


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_probe_variant_patches_a_copy_of_the_backward_source(tmp_path, variant):
    source = write_variant(variant, tmp_path / variant)
    for file in VARIANTS[variant]:
        assert (source.parent / file).read_text() != (_CSRC / file).read_text()
    assert source.name == SOURCE and source.parent != _CSRC
