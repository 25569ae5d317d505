"""Width-sharded whole-clip inference (counterpart of
rmnet_tpu/parallel/mesh.py's ``spatial_forward_video``).

Under the JAX mesh the clip's width axis is sharded along "space" and GSPMD
inserts every halo exchange and global reduction into one program. Here each
rank is a process with a replica of the weights that holds only its slice of
the frame width, and every value that crosses a shard edge is an explicit
collective of the rank's :class:`~rmnet_tpu_torch.parallel.mesh.DataMesh`:

  * the working layout: each rank holds whole /16 columns of the frame padded
    to a multiple of 16 (``divide_pads``), as evenly as the ranks divide them,
    so every stride of the trunks (2, 4, 8, 16) divides each shard's first
    column and a strided layer keeps the columns that it keeps in the single
    forward; only the two edge ranks hold padding;
  * halo exchanges (``halo``: one all-gather of every rank's edge columns,
    which has no ordering to deadlock on) before each convolution wider than
    1 (``conv2d``), the stem's max pool (``max_pool``) and each bilinear
    upsample (``upsample``), which then run on the extended slice with no
    width padding;
  * all-reduces SUM and MIN for the regional boxes (ops/att_map.py) and MAX
    for the objects present;
  * all-gathers along the width of each frame's memory keys and values (every
    rank's bank is the single forward's) and of each frame's estimate (the
    next frame's warp samples it wherever its flow points, and every rank
    returns the whole clip).

The modules take the width mesh as ``space``, a module attribute set for the
call and cleared after it (:meth:`WidthMesh.installed`); without it they run
as they do in the single forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rmnet_tpu_torch.ops.att_map import ColumnShard
from rmnet_tpu_torch.ops.pad import divide_pads

_GRID = 16  # full-resolution columns per column of the coarsest (/16) grid


def column_split(n_columns: int, size: int) -> List[Tuple[int, int]]:
    """[start, end) of each of ``size`` ranks' share of ``n_columns``, in
    rank order, as even as possible (the first ``n_columns % size`` ranks
    hold one more)."""
    if n_columns < size:
        raise ValueError(f"{n_columns} columns of the /16 grid cannot be split over "
                         f"{size} ranks")
    base, extra = divmod(n_columns, size)
    bounds = [r * base + min(r, extra) for r in range(size + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass(eq=False)
class WidthMesh:
    """One rank of a width mesh over frames of H x W: the rank's mesh, the
    (lw, uw, lh, uh) padding to a multiple of 16 and every
    rank's [start, end) on the /16 grid of the padded frame."""

    mesh: "DataMesh"  # noqa: F821  (parallel/mesh.py, which imports this module)
    height: int
    width: int
    pads: Tuple[int, int, int, int]
    grid: Tuple[Tuple[int, int], ...]

    @classmethod
    def build(cls, mesh, height: int, width: int) -> "WidthMesh":
        pads = divide_pads(height, width, _GRID)
        n_columns = (width + pads[0] + pads[1]) // _GRID
        return cls(mesh, height, width, pads, tuple(column_split(n_columns, mesh.size)))

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def padded_width(self) -> int:
        return self.grid[-1][1] * _GRID

    def columns(self, scale: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """[start, end) of a rank's columns (default: this rank's) at
        resolution /``scale`` (1, 2, 4, 8 or 16) of the padded frame."""
        lo, hi = self.grid[self.rank if rank is None else rank]
        return lo * _GRID // scale, hi * _GRID // scale

    def unpadded_columns(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """[start, end) of a rank's columns of the frame before padding."""
        lo, hi = self.columns(1, rank)
        lw = self.pads[0]
        return max(lo - lw, 0), min(hi - lw, self.width)

    def own_pads(self, pads: Sequence[int]) -> Tuple[int, int, int, int]:
        """``pads`` (lw, uw, lh, uh) as this rank's slice holds them: the
        width padding at the global edges only."""
        lw, uw, lh, uh = pads
        return (lw if self.rank == 0 else 0, uw if self.rank == self.size - 1 else 0, lh, uh)

    def padded_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns (last axis) of a tensor of the padded width."""
        lo, hi = self.columns(1)
        return x[..., lo:hi]

    def unpadded_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns (last axis) of a tensor of the frame's width."""
        lo, hi = self.unpadded_columns()
        return x[..., lo:hi]

    def box_shard(self, padded: bool) -> ColumnShard:
        """The regional box ops' view of this rank's columns of a mask in
        padded (``memorize``) or unpadded (the warped mask) coordinates."""
        if padded:
            return ColumnShard(self.columns(1)[0], self.padded_width, self.grid[self.rank][0],
                               self)
        return ColumnShard(self.unpadded_columns()[0], self.width, self.grid[self.rank][0],
                           self)

    # ------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op: str, kind: str) -> torch.Tensor:
        """``t`` reduced over the ranks with ``op`` ("sum", "min", "max"),
        a new tensor."""
        return self.mesh.all_reduce_(t.clone(memory_format=torch.contiguous_format), kind, op)

    def gather(self, x: torch.Tensor, widths: Sequence[int], kind: str) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last axis in rank order;
        rank r's holds ``widths[r]`` columns (one all-gather of pieces
        padded to the widest)."""
        wide = max(widths)
        piece = F.pad(x, (0, wide - x.shape[-1])) if x.shape[-1] < wide else x
        every = self.mesh.all_gather(piece, kind)
        return torch.cat([every[r][..., :w] for r, w in enumerate(widths)], dim=-1)

    def gather_unpadded(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The whole frame's width of ``x`` (.., rank's unpadded columns)."""
        widths = [hi - lo for lo, hi in map(self.unpadded_columns, range(self.size))]
        return self.gather(x, widths, kind)

    def gather_grid(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The whole /16 grid's width of ``x`` (.., rank's /16 columns)."""
        return self.gather(x, [hi - lo for lo, hi in self.grid], kind)

    def _per_column(self, x: torch.Tensor) -> int:
        """Columns of ``x`` (..., the rank's columns at some resolution) per
        column of the /16 grid; raises for a tensor not in the layout."""
        lo, hi = self.grid[self.rank]
        per, rest = divmod(x.shape[-1], hi - lo)
        if rest or per == 0:
            raise ValueError(f"{x.shape[-1]} columns are not this rank's {hi - lo} columns "
                             f"of the /16 grid at any resolution")
        return per

    def _check_stride(self, x: torch.Tensor, stride: int) -> None:
        first = self.grid[self.rank][0] * self._per_column(x)
        if first % stride:
            raise ValueError(f"stride {stride} does not divide the shard's first column "
                             f"{first}")

    def halo(self, x: torch.Tensor, left: int, right: int,
             fill: Optional[float]) -> torch.Tensor:
        """``x`` (..., w), the rank's columns at some resolution, extended by
        ``left`` columns of the left neighbour and ``right`` of the right
        one. At a global edge: ``fill`` columns, or none where ``fill`` is
        None. Raises where a halo is wider than the narrowest shard: it would
        need columns from beyond the neighbour."""
        if left == right == 0:
            return x
        w = x.shape[-1]
        narrowest = min(hi - lo for lo, hi in self.grid) * self._per_column(x)
        if max(left, right) > narrowest:
            raise ValueError(f"a halo of ({left}, {right}) columns on shards as narrow as "
                             f"{narrowest} (this rank's: {w})")
        edges = torch.cat([x[..., :right], x[..., w - left:]], dim=-1)
        every = self.mesh.all_gather(edges, "halo")
        parts = []
        if self.rank > 0:
            parts.append(every[self.rank - 1][..., right:])
        elif fill is not None and left:
            parts.append(x.new_full(x.shape[:-1] + (left,), fill))
        parts.append(x)
        if self.rank < self.size - 1:
            parts.append(every[self.rank + 1][..., :right])
        elif fill is not None and right:
            parts.append(x.new_full(x.shape[:-1] + (right,), fill))
        return torch.cat(parts, dim=-1)

    # ------------------------------------------------------ halo ops
    def conv_halo(self, x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
        """``x`` with the width halo that a convolution of width ``kernel``,
        ``stride`` and ``padding`` reads beyond the shard: ``padding`` columns
        on the left, ``kernel - padding - stride`` on the right (zeros at the
        global edges)."""
        self._check_stride(x, stride)
        return self.halo(x, padding, max(0, kernel - padding - stride), 0.0)

    def conv2d(self, x, weight, bias, stride, padding, dilation=(1, 1), groups=1):
        """``F.conv2d`` of the rank's columns."""
        stride, padding, dilation = (_pair(v) for v in (stride, padding, dilation))
        if dilation[1] != 1:
            raise ValueError("a width-sharded convolution takes no dilation along the width")
        x = self.conv_halo(x, weight.shape[-1], stride[1], padding[1])
        return F.conv2d(x, weight, bias, stride, (padding[0], 0), dilation, groups)

    def max_pool(self, x, kernel: int, stride: int, padding: int):
        """``F.max_pool2d`` of the rank's columns; -inf beyond the global
        edges, as the pool pads."""
        self._check_stride(x, stride)
        x = self.halo(x, padding, max(0, kernel - padding - stride), -math.inf)
        return F.max_pool2d(x, kernel, stride, (padding, 0))

    def upsample(self, x, factor: int):
        """Bilinear ``F.interpolate`` by ``factor`` (align_corners=False) of
        the rank's columns: one input column of each neighbour, the
        extended slice upsampled, ``factor`` output columns cropped where a
        halo was added. A global edge gets no halo, so torch's own clamp
        applies there as in the single forward."""
        w = x.shape[-1]
        x = self.halo(x, 1, 1, None)
        left = factor if self.rank > 0 else 0
        up = F.interpolate(x, size=(x.shape[-2] * factor, x.shape[-1] * factor),
                           mode="bilinear", align_corners=False)
        return up[..., left:left + w * factor]

    @contextlib.contextmanager
    def installed(self, module: torch.nn.Module):
        """Every submodule of ``module`` whose class takes a width mesh
        (``space``) runs on this rank's columns for the block."""
        hooked = [m for m in module.modules() if hasattr(type(m), "space")]
        for m in hooked:
            m.space = self
        try:
            yield self
        finally:
            for m in hooked:
                m.space = None


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


# what a call builds, keyed by (the mesh, the frame size): the width mesh,
# with its column ranges at every resolution and, through its DataMesh, the
# pinned staging buffers. It holds no weights: a repeated call on the same
# mesh and geometry builds nothing, and a model is not kept alive by it
_SPATIAL_PLANS: dict = {}


def spatial_forward_video(apply, frames, masks, flows, n_objects, mesh):
    """Width-sharded whole-clip inference on this rank of ``mesh`` (a
    DataMesh whose ranks split the width): ``apply.forward_video`` with every activation
    of the trunks, the heads and the decoder held as the rank's columns,
    under ``torch.no_grad()``.

    frames (B, T, H, W, 3), masks (B, T, K, H, W), flows (B, T, H, W, 2),
    n_objects (B, T): the global clip, as ``RMNetApply.forward_video``
    takes it, on every rank -> est (B, T, K, H, W), the whole clip, on every
    rank (the JAX version's ``out_shardings=P()``). Weights are the
    replica's own. Raises for trainable BatchNorm or a data-parallel mesh on
    ``apply``: BatchNorm statistics over both axes belong to the hybrid
    (data x space) training slice, which is not ported yet."""
    if apply.train_bn or apply.mesh is not None:
        raise ValueError("spatial_forward_video runs inference with frozen BatchNorm; "
                         "training under a width mesh (BatchNorm over both axes) is the "
                         "hybrid data x space slice, not ported yet")
    frames, masks, flows = (torch.as_tensor(x, device=mesh.device)
                            for x in (frames, masks, flows))
    H, W = masks.shape[-2:]
    key = (mesh, (H, W))
    width = _SPATIAL_PLANS.get(key)
    if width is None:
        width = _SPATIAL_PLANS[key] = WidthMesh.build(mesh, H, W)
    with torch.no_grad(), width.installed(apply.model):
        return dataclasses.replace(apply, space=width).forward_video(frames, masks, flows,
                                                                     n_objects)
