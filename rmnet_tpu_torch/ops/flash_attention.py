"""Block-sparse regional memory read (flash style) with its gradient: tile
metadata, the plain PyTorch versions and the wrappers of the hand-written
CUDA kernels.

Counterpart of rmnet_tpu/ops/flash_attention.py. The memory read computes
``softmax_m(q . k_m / sqrt(Ck) + bias_m) . v_m`` over M = S*h*w memory
positions, with bias 0 on valid slots and -1e30 on invalid ones. Memory
keys/values are exactly zero outside each slot's regional box (``memorize``
multiplies them by the rasterized /16 attention map), so any memory tile
without an in-box valid position contributes scores of exactly 0 and values
of exactly 0. Such tiles are never read; their ``z`` valid positions add
``z * exp(0 - m)`` to the softmax denominator in closed form.

Two kernels, each built with nvcc for sm_90a at first use into
build/kernels/ and bound with ctypes:

* rmnet_tpu_torch/csrc/flash_read_fwd.cu replaces the Pallas TPU kernel
  ``_kernel`` of rmnet_tpu/ops/flash_attention.py:61 (pallas_call at :226).
  It is bound by operations: 2*N*Q*M_active*(Ck+Cv) FLOP against the
  active K/V bytes read once, an intensity of about Q (1620 at 480p) FLOP
  per byte, well above the H100's ridge of about 295. Two kernels on the
  tensor cores (bf16 mma.sync m16n8k16 with P rounded to bf16 as the TPU
  kernel rounds it, csrc/mma_bf16.cuh; 3xTF32 for f32, csrc/mma_tf32.cuh):
  the main kernel computes Q.K^T once per (64 query rows, active tile),
  holds all Cv = 512 value columns of its rows and walks a fixed
  contiguous share of the row's active tiles (a split, :func:`fwd_splits`
  picks their count), writing a float32 partial (m, l, acc) per split; a
  merge kernel combines the splits in a fixed order, adds the skipped
  tiles' mass and writes ``out`` and ``lse``. Plain versions of the two:
  :func:`flash_read_fwd_partials_reference`,
  :func:`flash_read_fwd_merge_reference`.
* rmnet_tpu_torch/csrc/flash_read_bwd.cu replaces ``_bwd_kernel``
  (:239, pallas_call at :335): dQ, and dK/dV of the active tiles, from the
  forward's lse, 2*N*Q*M_active*(3*Ck+2*Cv) FLOP, also bound by operations.
  Three kernels on the tensor cores (TF32 mma.sync, 3xTF32 for f32 inputs;
  csrc/mma_tf32.cuh): s and dP once per (query block, tile) into a float32
  P / dS scratch, then dK/dV per tile and dQ per query block from it.
  As in the JAX package, D = rowsum(dO * O) and the skipped tiles' exact
  rank-1 dK/dV (every valid position there has k = v = 0 and probability
  exp(-lse)) are computed in torch around the kernel.

``flash_memory_read`` is differentiable (:class:`FlashMemoryRead`). It
computes the tile metadata, then takes the plain versions only for tensors
on the CPU; for CUDA tensors it launches the kernels or raises.
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

# memory positions per tile of the CUDA kernels (BM in csrc/*.cu); the
# Pallas kernel's tile is 512, the result does not depend on it
KERNEL_TILE = 64
_CK = 128  # key width the kernels take
_CV_SLICE = 128  # value columns per block
_FWD_CV = 512  # value width the forward kernel takes
_BWD_CV = (128, 256, 512)  # value widths the backward kernel takes
_QUERY_BLOCK = 64  # query rows per block of the forward
MAX_SPLITS = 8  # memory-tile splits the forward takes (MAX_SPLITS in csrc/flash_read_fwd.cu)
# fixed cost of one split, in tiles of work: loading the query block and
# writing its (64, Cv + 2) float32 partial state
_SPLIT_COST_TILES = 4
_NEG = -1e30
_GRID = 16  # full-resolution pixels per cell of the /16 grid memorize rasterizes on

_REPO = Path(__file__).resolve().parents[2]
_CSRC = _REPO / "rmnet_tpu_torch" / "csrc"
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

    pos_valid = slot_valid[:, :, None].expand(N, S, hw).reshape(N, M)
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


def _listed_positions(order, counts, slot_valid, hw, mt, first=None):
    """(N, M) bool: valid positions inside the tiles listed in
    ``order[n, first[n]:counts[n]]`` (from 0 without ``first``), the
    positions a kernel reads."""
    N, nt = order.shape
    it = torch.arange(nt, device=order.device)[None]
    listed = it < counts[:, None]
    if first is not None:
        listed &= it >= first[:, None]
    active = torch.zeros(N, nt, dtype=torch.int32, device=order.device)
    active = active.scatter_add_(1, order.long(), listed.to(torch.int32)) > 0
    in_tile = active.repeat_interleave(mt, dim=1)[:, :slot_valid.shape[1] * hw]
    return in_tile & slot_valid.repeat_interleave(hw, dim=1)


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
    """Plain PyTorch version of the forward kernel -> (out (N, h, w, Cv),
    lse (N, Q)).

    Reads exactly the positions of the listed active tiles (invalid slots
    masked), adds the closed-form mass of the ``z`` skipped valid positions
    and applies the all-invalid guard, all in float32.
    """
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    M = S * hw
    use = _listed_positions(order, counts, slot_valid, hw, mt)  # (N, M)

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


def fwd_splits(N: int, Q: int, nt: int, sm_count: int) -> int:
    """Memory-tile splits of the forward's grid (query blocks, splits, N),
    from the shapes and the card's SM count only (never from device data):
    the count in 1 .. min(MAX_SPLITS, nt) that minimises the waves of
    one-block-per-SM launches times each block's work, ``nt / splits`` tiles
    at most plus a fixed cost per split. 5 at the engine's read (N = 2,
    Q = 1620, nt = 836) on 132 SMs, 2 at the training read (N = 12,
    Q = 900, nt = 43)."""
    blocks = N * -(-Q // _QUERY_BLOCK)

    def cost(s):
        return -(-blocks * s // sm_count) * (-(-nt // s) + _SPLIT_COST_TILES)

    return min(range(1, min(MAX_SPLITS, nt) + 1), key=cost)


def flash_read_fwd_partials_reference(
    m_key: torch.Tensor,       # (N, S, h, w, Ck)
    m_val: torch.Tensor,       # (N, S, h, w, Cv)
    q_key: torch.Tensor,       # (N, h, w, Ck)
    slot_valid: torch.Tensor,  # (N, S) bool
    order: torch.Tensor,       # (N, nt) int32 compacted active tiles
    counts: torch.Tensor,      # (N,) int32
    splits: int,
    mt: int = KERNEL_TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward's main kernel -> the partial state of
    each split, float32: m (N, splits, Q), l (N, splits, Q), acc (N, splits,
    Q, Cv).

    Split s of row n reads the listed tiles ``order[n, b:e]``, b =
    counts[n]*s // splits, e = counts[n]*(s+1) // splits (its contiguous
    share); m is the largest score of its valid positions, l and acc the
    sums of ``exp(score - m)`` and of ``exp(score - m) * v`` over them. A
    split with no tile has m = -1e30, l = 0, acc = 0.
    """
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    M = S * hw
    qf = q_key.reshape(N, hw, Ck).float()
    kf = m_key.reshape(N, M, Ck).float()
    vf = m_val.reshape(N, M, Cv).float()
    s = torch.einsum("nqc,nmc->nqm", qf, kf) / math.sqrt(Ck)
    cnt = counts.long()
    ms, ls, accs = [], [], []
    for split in range(splits):
        use = _listed_positions(order, cnt * (split + 1) // splits, slot_valid, hw, mt,
                                first=cnt * split // splits)  # (N, M)
        ss = s.masked_fill(~use[:, None, :], -math.inf)
        m = ss.amax(dim=2)                                   # (N, Q)
        m = torch.where(torch.isfinite(m), m, torch.full_like(m, _NEG))
        p = torch.exp(ss - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=2))
        accs.append(torch.einsum("nqm,nmc->nqc", p, vf))
    return torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)


def flash_read_fwd_merge_reference(
    m: torch.Tensor,     # (N, splits, Q) float32
    l: torch.Tensor,     # (N, splits, Q)
    acc: torch.Tensor,   # (N, splits, Q, Cv)
    z: torch.Tensor,     # (N,) int32
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward's merge kernel -> (out (N, Q, Cv) in
    ``dtype``, lse (N, Q) float32): the splits rescaled to one maximum m2
    (at least 0 where z > 0), the z skipped valid positions' mass
    ``z * exp(-m2)`` added once, and the all-invalid guard (out = 0,
    lse = +inf where nothing has weight), as flash_attention.py:98-114."""
    zf = z.float()[:, None]                                   # (N, 1)
    mx = m.amax(dim=1)                                        # (N, Q)
    m2 = torch.where(zf > 0, torch.clamp(mx, min=0.0), mx)
    wgt = torch.exp(m - m2[:, None])                          # (N, splits, Q)
    l_raw = (wgt * l).sum(dim=1) + zf * torch.exp(-m2)
    l_safe = torch.where(l_raw > 0, l_raw, torch.ones_like(l_raw))
    out = (wgt[..., None] * acc).sum(dim=1) / l_safe[..., None]
    lse = torch.where(l_raw > 0, m2 + torch.log(l_safe), torch.full_like(l_raw, math.inf))
    return out.to(dtype), lse


def flash_read_bwd_reference(
    m_key: torch.Tensor,       # (N, S, h, w, Ck)
    m_val: torch.Tensor,       # (N, S, h, w, Cv)
    q_key: torch.Tensor,       # (N, h, w, Ck)
    slot_valid: torch.Tensor,  # (N, S) bool
    order: torch.Tensor,       # (N, nt) int32 compacted active tiles
    counts: torch.Tensor,      # (N,) int32
    d_out: torch.Tensor,       # (N, h, w, Cv) cotangent of out
    lse: torch.Tensor,         # (N, Q) float32, from the forward
    delta: torch.Tensor,       # (N, Q) float32, rowsum(d_out * out)
    mt: int = KERNEL_TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dq (N, h, w, Ck),
    dk_t (N, nt*mt, Ck), dv_t (N, nt*mt, Cv)), all float32.

    Works over exactly the valid positions of the listed active tiles:
    ``p = exp(s - lse)``, ``dV = p^T dO``, ``dS = p * (dO V^T - delta)``,
    ``dK = dS^T q * scale``, ``dQ = dS K * scale``. dk_t / dv_t are zero at
    the positions of unlisted tiles and past M, as the kernel's are.
    """
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    hw = h * w
    M = S * hw
    Mp = order.shape[1] * mt
    scale = 1.0 / math.sqrt(Ck)
    use = _listed_positions(order, counts, slot_valid, hw, mt)  # (N, M)

    qf = q_key.reshape(N, hw, Ck).float()
    kf = m_key.reshape(N, M, Ck).float()
    vf = m_val.reshape(N, M, Cv).float()
    do = d_out.reshape(N, hw, Cv).float()
    s = torch.einsum("nqc,nmc->nqm", qf, kf) * scale
    # lse = +inf rows give exp(-inf) = 0
    p = torch.where(use[:, None, :], torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.einsum("nqm,nqc->nmc", p, do)
    ds = p * (torch.einsum("nqc,nmc->nqm", do, vf) - delta[..., None])
    dk = torch.einsum("nqm,nqc->nmc", ds, qf) * scale
    dq = torch.einsum("nqm,nmc->nqc", ds, kf) * scale
    pad = (0, 0, 0, Mp - M)
    return (dq.reshape(N, h, w, Ck), torch.nn.functional.pad(dk, pad),
            torch.nn.functional.pad(dv, pad))


def merge_skipped_tiles(dk_t, dv_t, tile_active, slot_valid, q_key, d_out, lse,
                        delta, m_shape, mt: int = KERNEL_TILE):
    """dK/dV of the whole bank (flash_attention.py:346-372), float32: the
    kernel's rows on active tiles, the exact closed form on the valid
    positions of skipped tiles, zero on invalid positions.

    A skipped tile's valid positions have k = v = 0 and probability
    exp(-lse_q), so each gets dV = sum_q exp(-lse_q) dO_q and
    dK = -scale sum_q exp(-lse_q) D_q q_q (one vector per row)."""
    N, S, h, w, Ck = m_shape
    hw = h * w
    M = S * hw
    Cv = dv_t.shape[-1]
    scale = 1.0 / math.sqrt(Ck)
    c = torch.exp(-lse)                                   # (N, Q); 0 where lse = +inf
    dv_skip = torch.einsum("nq,nqv->nv", c, d_out.reshape(N, hw, Cv).float())
    dk_skip = -scale * torch.einsum("nq,nqc->nc", c * delta,
                                    q_key.reshape(N, hw, Ck).float())
    act_pos = tile_active.repeat_interleave(mt, dim=1)[:, :M, None]
    pos_valid = slot_valid.repeat_interleave(hw, dim=1)[:, :, None]
    zero = torch.zeros((), device=dk_t.device)
    dk = torch.where(act_pos, dk_t[:, :M].float(),
                     torch.where(pos_valid, dk_skip[:, None], zero))
    dv = torch.where(act_pos, dv_t[:, :M].float(),
                     torch.where(pos_valid, dv_skip[:, None], zero))
    return dk.reshape(N, S, h, w, Ck), dv.reshape(N, S, h, w, Cv)


class _Library:
    """One kernel's shared library, built from the checkout at first use."""

    def __init__(self, name: str, argtypes, csrc: Path = _CSRC):
        self.name = name
        self.source = csrc / f"{name}.cu"
        self.argtypes = argtypes
        self.lib = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def tag(self) -> str:
        """Hash of what the build reads: the source, every header beside it
        (``csrc/*.cuh``) and the nvcc flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(_NVCC_FLAGS).encode())
        return h.hexdigest()[:12]

    def load(self, force_build: bool = False):
        """Load the library, building it first if this source and its
        headers have no build yet (or always, with ``force_build``)."""
        if self.lib is not None and not force_build:
            return self.lib
        path = _BUILD_DIR / f"lib{self.name}_{self.tag()}.so"
        if force_build or not path.exists():
            cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
            nvcc = str(Path(cuda_home) / "bin" / "nvcc")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n{self.build_log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        tile, smem = getattr(lib, f"{self.name}_tile"), getattr(lib, f"{self.name}_smem_bytes")
        for const in (tile, smem):
            const.argtypes = []
            const.restype = ctypes.c_int
        if tile() != KERNEL_TILE:
            raise RuntimeError(f"{self.name}: kernel tile size disagrees with KERNEL_TILE")
        if hasattr(lib, f"{self.name}_init"):
            # one-time kernel attributes, so that a CUDA graph capture of a
            # launch records the launch only
            init = getattr(lib, f"{self.name}_init")
            init.argtypes, init.restype = [], ctypes.c_int
            err = init()
            if err != 0:
                raise RuntimeError(f"{self.name}_init failed: CUDA error {err}")
        self.lib, self.path = lib, path
        return lib

    def smem_bytes(self) -> int:
        return getattr(self.load(), f"{self.name}_smem_bytes")()


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = _Library("flash_read_fwd", [_I] + [_P] * 11 + [_I] * 7 + [_L] * 6
                   + [ctypes.c_float, _P])
BWD_LIBRARY = _Library("flash_read_bwd", [_I] + [_P] * 14 + [_I] * 6 + [_L] * 6
                       + [ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_inputs(m_key, m_val, q_key, slot_valid, order, counts):
    dev = q_key.device
    if dev.type != "cuda":
        raise ValueError(f"the flash read kernels take CUDA tensors, not {dev}")
    named = (("m_key", m_key), ("m_val", m_val), ("slot_valid", slot_valid),
             ("order", order), ("counts", counts))
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
    _check_meta("order", order, torch.int32, (N, nt))
    _check_meta("counts", counts, torch.int32, (N,))
    for name, t in (("m_key", m_key), ("m_val", m_val)):
        st = t.stride()
        # channels contiguous, (h, w) one linear position axis, 16-byte
        # aligned rows for the vector loads
        if st[4] != 1 or st[2] != w * st[3]:
            raise ValueError(f"{name} needs contiguous channels and a linear "
                             f"(h, w) position axis, got strides {st}")
        if any(s % 8 for s in st[:4]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {st} / pointer not 16-byte aligned")
    _check_meta("q_key", q_key, q_key.dtype, (N, h, w, Ck), align=True)


def _check_meta(name, t, dtype, shape, align=False):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or (align and t.data_ptr() % 16)):
        raise ValueError(f"{name} must be contiguous{' 16-byte aligned' if align else ''} "
                         f"{dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


class FlashMemoryRead(torch.autograd.Function):
    """The block-sparse read with its recompute-based flash backward
    (``jax.custom_vjp`` of flash_attention.py:375-407). Forward and backward
    each make one call of their kernels' wrapper on the card (two and three
    CUDA kernels), their plain versions on the CPU;
    ``slot_valid`` and ``bboxes`` get no gradient."""

    @staticmethod
    def forward(ctx, m_key, m_val, q_key, slot_valid, bboxes):
        h, w = m_key.shape[2:4]
        tile_active, z, order, counts = tile_metadata(slot_valid, bboxes, h, w)
        if q_key.device.type == "cpu":
            out, lse = flash_memory_read_reference(m_key, m_val, q_key, slot_valid,
                                                   order, counts, z)
        else:
            out, lse = flash_read_fwd(m_key, m_val, q_key, slot_valid, order, counts, z)
        ctx.save_for_backward(m_key, m_val, q_key, slot_valid, out, lse, tile_active,
                              order, counts)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        m_key, m_val, q_key, slot_valid, out, lse, tile_active, order, counts = (
            ctx.saved_tensors)
        N = q_key.shape[0]
        d_out = d_out.to(q_key.dtype).contiguous()
        # D = rowsum(dO * O), outside the kernel as in flash_attention.py:309-311
        delta = (d_out.float() * out.float()).sum(dim=-1).reshape(N, -1)
        args = (m_key, m_val, q_key, slot_valid, order, counts, d_out, lse, delta)
        if q_key.device.type == "cpu":
            dq, dk_t, dv_t = flash_read_bwd_reference(*args)
        else:
            dq, dk_t, dv_t = flash_read_bwd(*args)
        dmk, dmv = merge_skipped_tiles(dk_t, dv_t, tile_active, slot_valid, q_key, d_out,
                                       lse, delta, m_key.shape)
        return (dmk.to(m_key.dtype), dmv.to(m_val.dtype), dq.to(q_key.dtype), None, None)


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
    CPU this runs the plain versions; on CUDA it launches the kernels.
    Differentiable in ``m_key``, ``m_val`` and ``q_key`` (``lse`` is not).
    """
    return FlashMemoryRead.apply(m_key, m_val, q_key, slot_valid, bboxes)


def fwd_splits_for(m_key, device) -> int:
    """:func:`fwd_splits` for a read of bank ``m_key`` on CUDA ``device``."""
    N, S, h, w, _ = m_key.shape
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return fwd_splits(N, h * w, -(-S * h * w // KERNEL_TILE), sm_count)


def flash_read_fwd(m_key, m_val, q_key, slot_valid, order, counts, z):
    """Launch the forward's kernels (main, then merge) on tile metadata from
    :func:`tile_metadata` (at ``KERNEL_TILE``) -> (out (N, h, w, Cv), lse
    (N, h*w) f32). Takes CUDA tensors only and Cv = 512; adds one to
    ``flash_memory_read.launches`` per call, or to
    ``flash_memory_read.captured`` when the call is recorded into a CUDA
    graph (whoever replays the graph counts its launches in
    ``flash_memory_read.replayed``). Allocates the splits' float32
    scratch, N * splits * Qp * (Cv + 2) * 4 bytes (Qp = Q rounded up to 64,
    splits from :func:`fwd_splits`)."""
    _check_cuda_inputs(m_key, m_val, q_key, slot_valid, order, counts)
    _check_meta("z", z, torch.int32, (m_key.shape[0],))
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    if Cv != _FWD_CV:
        raise ValueError(f"the forward kernel takes Cv == {_FWD_CV}, got {Cv}")
    lib = LIBRARY.load()
    Q = h * w
    dev = q_key.device
    splits = fwd_splits_for(m_key, dev)
    Qp = -(-Q // _QUERY_BLOCK) * _QUERY_BLOCK
    out = torch.empty((N, h, w, Cv), dtype=q_key.dtype, device=dev)
    lse = torch.empty((N, Q), dtype=torch.float32, device=dev)
    part_acc = torch.empty((N, splits, Qp, Cv), dtype=torch.float32, device=dev)
    part_ml = torch.empty((N, splits, Qp, 2), dtype=torch.float32, device=dev)
    valid_u8 = slot_valid.to(torch.uint8).contiguous()
    ks, vs = m_key.stride(), m_val.stride()
    err = lib.flash_read_fwd(
        _DTYPE_CODE[q_key.dtype], q_key.data_ptr(), m_key.data_ptr(),
        m_val.data_ptr(), valid_u8.data_ptr(), order.data_ptr(),
        counts.data_ptr(), z.data_ptr(), out.data_ptr(), lse.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        N, Q, S, Q, Cv, order.shape[1], splits,
        ks[0], ks[1], ks[3], vs[0], vs[1], vs[3],
        1.0 / math.sqrt(Ck), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_read_fwd launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        flash_memory_read.captured += 1
    else:
        flash_memory_read.launches += 1
    return out, lse


def flash_read_bwd(m_key, m_val, q_key, slot_valid, order, counts, d_out, lse, delta):
    """Launch the backward kernels (P and dS of the listed active tiles, then
    their dK/dV, then dQ) -> (dq (N, h, w, Ck), dk_t (N, nt*64, Ck), dv_t
    (N, nt*64, Cv)) in the inputs' dtype, zero outside the listed tiles, like
    :func:`flash_read_bwd_reference`. Takes CUDA tensors only; adds one to
    ``flash_read_bwd.launches`` per call. Allocates two float32 scratch
    tensors of (N, nt, Q rounded up to 64, 64) for P and dS."""
    _check_cuda_inputs(m_key, m_val, q_key, slot_valid, order, counts)
    N, S, h, w, Ck = m_key.shape
    Cv = m_val.shape[-1]
    Q = h * w
    if Cv not in _BWD_CV:
        raise ValueError(f"the backward kernel takes Cv in {_BWD_CV}, got {Cv}")
    _check_meta("d_out", d_out, q_key.dtype, (N, h, w, Cv), align=True)
    _check_meta("lse", lse, torch.float32, (N, Q))
    _check_meta("delta", delta, torch.float32, (N, Q))
    lib = BWD_LIBRARY.load()
    nt = order.shape[1]
    dq = torch.empty((N, h, w, Ck), dtype=q_key.dtype, device=q_key.device)
    dk_t = torch.zeros((N, nt * KERNEL_TILE, Ck), dtype=q_key.dtype, device=q_key.device)
    dv_t = torch.zeros((N, nt * KERNEL_TILE, Cv), dtype=q_key.dtype, device=q_key.device)
    scratch = (N, nt, -(-Q // KERNEL_TILE) * KERNEL_TILE, KERNEL_TILE)
    p_buf = torch.empty(scratch, dtype=torch.float32, device=q_key.device)
    ds_buf = torch.empty(scratch, dtype=torch.float32, device=q_key.device)
    valid_u8 = slot_valid.to(torch.uint8).contiguous()
    ks, vs = m_key.stride(), m_val.stride()
    err = lib.flash_read_bwd(
        _DTYPE_CODE[q_key.dtype], q_key.data_ptr(), m_key.data_ptr(), m_val.data_ptr(),
        valid_u8.data_ptr(), order.data_ptr(), counts.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(),
        p_buf.data_ptr(), ds_buf.data_ptr(),
        N, Q, S, Q, Cv, nt, ks[0], ks[1], ks[3], vs[0], vs[1], vs[3],
        1.0 / math.sqrt(Ck), torch.cuda.current_stream(q_key.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_read_bwd launch failed: CUDA error {err}")
    flash_read_bwd.launches += 1
    return dq, dk_t, dv_t


flash_memory_read.launches = 0   # forward calls launched eagerly
flash_memory_read.captured = 0   # forward calls recorded into CUDA graphs
flash_memory_read.replayed = 0   # forward launches replayed from CUDA graphs
flash_read_bwd.launches = 0
