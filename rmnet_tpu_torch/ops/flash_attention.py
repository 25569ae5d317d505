"""Block-sparse regional memory read (flash style): tile metadata, the plain
PyTorch version and the wrapper of the hand-written CUDA kernel.

Counterpart of rmnet_tpu/ops/flash_attention.py (forward only). The memory
read computes ``softmax_m(q . k_m / sqrt(Ck) + bias_m) . v_m`` over
M = S*h*w memory positions, with bias 0 on valid slots and -1e30 on invalid
ones. Memory keys/values are exactly zero outside each slot's regional box
(``memorize`` multiplies them by the rasterized /16 attention map), so any
memory tile without an in-box valid position contributes scores of exactly
0 and values of exactly 0. Such tiles are never read; their ``z`` valid
positions add ``z * exp(0 - m)`` to the softmax denominator in closed form.

The kernel (rmnet_tpu_torch/csrc/flash_read_fwd.cu) replaces the Pallas TPU
kernel ``_kernel`` of rmnet_tpu/ops/flash_attention.py:61 (pallas_call at
:226). It is bound by operations: 2*N*Q*M_active*(Ck+Cv) FLOP against the
active K/V bytes read once, an intensity of about Q (1620 at 480p) FLOP per
byte, well above the H100's ridge of about 295. It is built with nvcc for
sm_90a at first use into build/kernels/ and bound with ctypes.

The wrapper ``flash_memory_read`` computes the tile metadata, then takes the
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel (``flash_read_fwd``) or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

# memory positions per tile of the CUDA kernel (BM in flash_read_fwd.cu);
# the Pallas kernel's tile is 512, the result does not depend on it
KERNEL_TILE = 64
_CK = 128  # key width the kernel takes
_CV_SLICE = 128  # value columns per block
_GRID = 16  # full-resolution pixels per cell of the /16 grid memorize rasterizes on

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "rmnet_tpu_torch" / "csrc" / "flash_read_fwd.cu"
_BUILD_DIR = _REPO / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def tile_metadata(
    slot_valid: torch.Tensor,          # (N, S) bool
    bboxes: Optional[torch.Tensor],    # (N, S, 4) int32 or None
    h: int,
    w: int,
    mt: int = KERNEL_TILE,
):
    """Per-tile activity and compacted tile order (flash_attention.py:121-168).

    Returns ``(tile_active (N, nt), z (N,), order (N, nt), counts (N,))``:
    ``order[n, :counts[n]]`` lists the active tiles of row n in ascending
    order, the tail repeats the last active tile (as the Pallas compaction
    does); ``z`` counts the valid positions of the skipped tiles.
    Runs on the tensors' device with no host synchronisation.
    """
    N, S = slot_valid.shape
    hw = h * w
    M = S * hw
    nt = -(-M // mt)
    Mp = nt * mt
    dev = slot_valid.device

    pos_valid = slot_valid.repeat_interleave(hw, dim=1)  # (N, M)
    if bboxes is None:
        in_box = pos_valid
    else:
        # the /16 sample grid of memorize's raster (ops/att_map.py::
        # _raster_small with offset (0, 0))
        ys = (torch.arange(h, device=dev, dtype=torch.int32) * _GRID)[:, None]
        xs = (torch.arange(w, device=dev, dtype=torch.int32) * _GRID)[None, :]
        b = bboxes.to(torch.int32)[:, :, :, None, None]
        cell = ((ys >= b[:, :, 2]) & (ys <= b[:, :, 3])
                & (xs >= b[:, :, 0]) & (xs <= b[:, :, 1]))  # (N, S, h, w)
        in_box = cell.reshape(N, M) & pos_valid
    if Mp != M:
        pos_valid = torch.nn.functional.pad(pos_valid, (0, Mp - M))
        in_box = torch.nn.functional.pad(in_box, (0, Mp - M))

    tile_active = in_box.reshape(N, nt, mt).any(dim=2)  # (N, nt)
    z = (pos_valid.reshape(N, nt, mt).sum(dim=2) * ~tile_active).sum(dim=1)
    z = z.to(torch.int32)

    idx_sorted = torch.argsort((~tile_active).to(torch.int8), dim=1, stable=True)
    counts = tile_active.sum(dim=1).to(torch.int32)  # (N,)
    last = torch.gather(idx_sorted, 1, (counts.long() - 1).clamp(min=0)[:, None])
    ar = torch.arange(nt, device=dev)[None]
    order = torch.where(ar < counts[:, None], idx_sorted, last).to(torch.int32)
    return tile_active, z, order, counts


def flash_memory_read_reference(
    m_key: torch.Tensor,       # (N, S, h, w, Ck)
    m_val: torch.Tensor,       # (N, S, h, w, Cv)
    q_key: torch.Tensor,       # (N, h, w, Ck)
    slot_valid: torch.Tensor,  # (N, S) bool
    order: torch.Tensor,       # (N, nt) int32 compacted active tiles
    counts: torch.Tensor,      # (N,) int32
    z: torch.Tensor,           # (N,) int32
    mt: int = KERNEL_TILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel -> (out (N, h, w, Cv), lse (N, Q)).

    Reads exactly the positions of the listed active tiles (invalid slots
    masked), adds the closed-form mass of the ``z`` skipped valid positions
    and applies the all-invalid guard, all in float32.
    """
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    M = S * hw
    nt = order.shape[1]
    listed = (torch.arange(nt, device=order.device)[None] < counts[:, None])
    active = torch.zeros(N, nt, dtype=torch.int32, device=order.device)
    active = active.scatter_add_(1, order.long(), listed.to(torch.int32)) > 0
    in_tile = active.repeat_interleave(mt, dim=1)[:, :M]
    use = in_tile & slot_valid.repeat_interleave(hw, dim=1)  # (N, M)

    qf = q_key.reshape(N, hw, Ck).float()
    kf = m_key.reshape(N, M, Ck).float()
    vf = m_val.reshape(N, M, Cv).float()
    s = torch.einsum("nqc,nmc->nqm", qf, kf) / math.sqrt(Ck)
    s = s.masked_fill(~use[:, None, :], -math.inf)
    zf = z.float()[:, None]                       # (N, 1)
    m = s.amax(dim=2)                             # (N, Q), -inf if nothing
    m2 = torch.where(zf > 0, torch.clamp(m, min=0.0), m)
    m2 = torch.where(torch.isfinite(m2), m2, torch.zeros_like(m2))
    p = torch.exp(s - m2[..., None])
    l_raw = p.sum(dim=2) + zf * torch.exp(-m2)
    l = torch.where(l_raw > 0, l_raw, torch.ones_like(l_raw))
    out = torch.einsum("nqm,nmc->nqc", p, vf) / l[..., None]
    lse = torch.where(l_raw > 0, m2 + torch.log(l),
                      torch.full_like(l, math.inf))
    return out.reshape(N, h, w, Cv).to(q_key.dtype), lse


class _Library:
    """The kernel's shared library, built from the checkout at first use."""

    def __init__(self):
        self.lib = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def load(self, force_build: bool = False):
        """Load the library, building it first if this source has no build
        yet (or always, with ``force_build``)."""
        if self.lib is not None and not force_build:
            return self.lib
        src = _SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
        path = _BUILD_DIR / f"libflash_read_fwd_{tag}.so"
        if force_build or not path.exists():
            cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
            nvcc = str(Path(cuda_home) / "bin" / "nvcc")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True,
            )
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n{self.build_log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fn = lib.flash_read_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for const in (lib.flash_read_fwd_tile, lib.flash_read_fwd_smem_bytes):
            const.argtypes = []
            const.restype = ctypes.c_int
        if lib.flash_read_fwd_tile() != KERNEL_TILE:
            raise RuntimeError("kernel tile size disagrees with KERNEL_TILE")
        self.lib, self.path = lib, path
        return lib


LIBRARY = _Library()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_inputs(m_key, m_val, q_key, slot_valid, order, counts, z):
    dev = q_key.device
    if dev.type != "cuda":
        raise ValueError(f"the flash read kernel takes CUDA tensors, not {dev}")
    named = (("m_key", m_key), ("m_val", m_val), ("slot_valid", slot_valid),
             ("order", order), ("counts", counts), ("z", z))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_key on {dev}")
    if q_key.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash read takes float32 or bfloat16, not {q_key.dtype}")
    if m_key.dtype != q_key.dtype or m_val.dtype != q_key.dtype:
        raise TypeError("m_key, m_val and q_key must share one dtype")
    if slot_valid.dtype != torch.bool:
        raise TypeError("slot_valid must be bool")
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    if Ck != _CK or Cv % _CV_SLICE != 0:
        raise ValueError(f"kernel takes Ck == {_CK} and Cv % {_CV_SLICE} == 0, "
                         f"got Ck={Ck}, Cv={Cv}")
    if m_val.shape[:4] != (N, S, h, w) or q_key.shape != (N, h, w, Ck):
        raise ValueError(f"shape mismatch: m_key {tuple(m_key.shape)}, m_val "
                         f"{tuple(m_val.shape)}, q_key {tuple(q_key.shape)}")
    if slot_valid.shape != (N, S):
        raise ValueError(f"slot_valid must be {(N, S)}, got {tuple(slot_valid.shape)}")
    nt = -(-S * h * w // KERNEL_TILE)
    for name, t, shape in (("order", order, (N, nt)), ("counts", counts, (N,)),
                           ("z", z, (N,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("m_key", m_key), ("m_val", m_val)):
        st = t.stride()
        # channels contiguous, (h, w) one linear position axis, 16-byte
        # aligned rows for the vector loads
        if st[4] != 1 or st[2] != w * st[3]:
            raise ValueError(f"{name} needs contiguous channels and a linear "
                             f"(h, w) position axis, got strides {st}")
        if any(s % 8 for s in st[:4]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {st} / pointer not 16-byte aligned")
    if not q_key.is_contiguous() or q_key.data_ptr() % 16:
        raise ValueError("q_key must be contiguous and 16-byte aligned")


def flash_memory_read(
    m_key: torch.Tensor,       # (N, S, h, w, Ck), any strides with C contiguous
    m_val: torch.Tensor,       # (N, S, h, w, Cv)
    q_key: torch.Tensor,       # (N, h, w, Ck)
    slot_valid: torch.Tensor,  # (N, S) bool
    bboxes: Optional[torch.Tensor] = None,  # (N, S, 4) int32 full-res boxes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse memory read -> (out (N, h, w, Cv), lse (N, h*w) f32).

    ``bboxes`` are the per-slot regional boxes in padded full-resolution
    coordinates (x_min, x_max, y_min, y_max), as the bank stores them; memory
    positions outside a slot's box must hold zero keys and values. On the
    CPU this runs the plain version; on CUDA it launches the kernel.
    """
    h, w = m_key.shape[2:4]
    _, z, order, counts = tile_metadata(slot_valid, bboxes, h, w)
    if q_key.device.type == "cpu":
        return flash_memory_read_reference(m_key, m_val, q_key, slot_valid,
                                           order, counts, z)
    return flash_read_fwd(m_key, m_val, q_key, slot_valid, order, counts, z)


def flash_read_fwd(m_key, m_val, q_key, slot_valid, order, counts, z):
    """Launch the CUDA kernel on tile metadata from :func:`tile_metadata`
    (at ``KERNEL_TILE``) -> (out (N, h, w, Cv), lse (N, h*w) f32). Takes CUDA
    tensors only; adds one to ``flash_memory_read.launches``."""
    _check_cuda_inputs(m_key, m_val, q_key, slot_valid, order, counts, z)
    lib = LIBRARY.load()
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    Q = h * w
    out = torch.empty((N, h, w, Cv), dtype=q_key.dtype, device=q_key.device)
    lse = torch.empty((N, Q), dtype=torch.float32, device=q_key.device)
    valid_u8 = slot_valid.to(torch.uint8).contiguous()
    ks, vs = m_key.stride(), m_val.stride()
    err = lib.flash_read_fwd(
        _DTYPE_CODE[q_key.dtype], q_key.data_ptr(), m_key.data_ptr(),
        m_val.data_ptr(), valid_u8.data_ptr(), order.data_ptr(),
        counts.data_ptr(), z.data_ptr(), out.data_ptr(), lse.data_ptr(),
        N, Q, S, Q, Cv, order.shape[1],
        Q * Ck, ks[0], ks[1], ks[3], vs[0], vs[1], vs[3],
        1.0 / math.sqrt(Ck), torch.cuda.current_stream(q_key.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_read_fwd launch failed: CUDA error {err}")
    flash_memory_read.launches += 1
    return out, lse


flash_memory_read.launches = 0
