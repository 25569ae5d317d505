"""Width-sharded RMNet and TinyFlowNet: whole-clip inference (counterpart of
rmnet_tpu/parallel/mesh.py's ``spatial_forward_video``) and the width axis of
hybrid batch x width training (``make_hybrid_mesh``, parallel/mesh.py).

Under the JAX mesh the clip's width axis is sharded along "space" and GSPMD
inserts every halo exchange and global reduction into one program, and
differentiates it. Here each rank is a process with a replica of the weights
that holds only its slice of the frame width, and every value that crosses a
shard edge is an explicit collective of the rank's
:class:`~rmnet_tpu_torch.parallel.mesh.DataMesh`, with its transpose written
out for the backward pass:

  * the working layout: each rank holds whole columns of the network's
    coarsest grid, /16 for RMNet and /64 for TinyFlowNet (``cell``), of the
    frame padded to a multiple of ``cell`` (``divide_pads``), as evenly as the
    ranks divide them, so every stride of the network (2 to 16, or 2 to 64)
    divides each shard's first column and a strided layer keeps the columns
    that it keeps in the single forward; only the two edge ranks hold
    padding. Where the grid has fewer columns than ranks, the last ranks hold
    none: they take part in every collective, and the halos and the edges
    count only the ranks that hold columns. An op of such a rank returns an
    empty tensor that depends on the op's input and weights with a zero
    gradient (``_NoColumns``), so that its backward reaches the same
    collectives and gives the same parameters a gradient as a holder's;
  * halo exchanges (``halo``: one all-gather of every rank's edge columns,
    which has no ordering to deadlock on) before each convolution wider than
    1 (``conv2d``), each transposed convolution (``conv_transpose2d``), the
    stem's max pool (``max_pool``) and each bilinear upsample (``upsample``),
    which then run on the extended slice with no width padding; the /2
    bilinear resize (``downsample2``) reads only its own columns. The
    backward is the all-gather's transpose: one all-gather of the halos'
    gradients, each added to the columns its owner holds (the pool's
    gradient reaches the argmax, which may lie in a halo);
  * all-reduces SUM and MIN for the regional boxes (ops/att_map.py) and MAX
    for the objects present; the boxes' gradient is the constant ones of
    their straight-through rule, so their backward has no collective;
  * all-gathers along the width of each frame's memory keys and values (every
    rank's bank is the single forward's) and of each frame's estimate (the
    next frame's warp samples it wherever its flow points). Every rank reads
    its copy of them with its own columns, so a rank's gradient there is
    partial: the backward is a reduce-scatter, the sum over the ranks of
    which the rank keeps its columns (``gather``);
  * the loss's gather of the estimate (``gather_unpadded(..., summed=False)``):
    every rank computes the same loss from it, so the backward keeps the
    rank's columns of the gradient and sums nothing.

Every rank issues the same collectives in the same order, forward and
backward, a rematerialised encoder's recomputed halos included: the graph is
the same on every rank, and autograd runs it in one order.

The modules take the width mesh as ``space``, a module attribute set for the
call (:meth:`WidthMesh.installed`, which ``RMNetApply.forward_video`` enters,
and again around each recompute of a checkpoint); without it they run as they
do in the single forward.
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

_GRID = 16  # RMNet's cell: full-resolution columns per column of its coarsest (/16) grid


def column_split(n_columns: int, size: int) -> List[Tuple[int, int]]:
    """[start, end) of each of ``size`` ranks' share of ``n_columns``, in
    rank order, as even as possible (the first ``n_columns % size`` ranks
    hold one more; with fewer columns than ranks the last ranks hold
    none)."""
    base, extra = divmod(n_columns, size)
    bounds = [r * base + min(r, extra) for r in range(size + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass(eq=False)
class WidthMesh:
    """One rank of a width mesh over frames of H x W: the rank's mesh, the
    (lw, uw, lh, uh) padding to a multiple of ``cell`` and every rank's
    [start, end) on the coarsest grid of the padded frame, whose columns are
    ``cell`` full-resolution columns wide (16 for RMNet, 64 for
    TinyFlowNet)."""

    mesh: "DataMesh"  # noqa: F821  (parallel/mesh.py, which imports this module)
    height: int
    width: int
    pads: Tuple[int, int, int, int]
    grid: Tuple[Tuple[int, int], ...]
    cell: int = _GRID

    @classmethod
    def build(cls, mesh, height: int, width: int, cell: int = _GRID) -> "WidthMesh":
        pads = divide_pads(height, width, cell)
        n_columns = (width + pads[0] + pads[1]) // cell
        return cls(mesh, height, width, pads, tuple(column_split(n_columns, mesh.size)), cell)

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def holders(self) -> int:
        """The ranks that hold columns: the first ``holders`` of the mesh."""
        return sum(hi > lo for lo, hi in self.grid)

    @property
    def padded_width(self) -> int:
        return self.grid[-1][1] * self.cell

    def _neighbours(self) -> Tuple[bool, bool]:
        """Whether this rank has a left and a right neighbour that holds
        columns (False at the frame's edges and on a rank without columns)."""
        holds = self.rank < self.holders
        return holds and self.rank > 0, holds and self.rank < self.holders - 1

    def columns(self, scale: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """[start, end) of a rank's columns (default: this rank's) at
        resolution /``scale`` (a divisor of ``cell``) of the padded frame."""
        lo, hi = self.grid[self.rank if rank is None else rank]
        return lo * self.cell // scale, hi * self.cell // scale

    def unpadded_columns(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """[start, end) of a rank's columns of the frame before padding."""
        lo, hi = self.columns(1, rank)
        lw = self.pads[0]
        start = min(max(lo - lw, 0), self.width)
        return start, max(min(hi - lw, self.width), start)

    def own_pads(self, pads: Sequence[int]) -> Tuple[int, int, int, int]:
        """``pads`` (lw, uw, lh, uh) as this rank's slice holds them: the
        width padding at the global edges only."""
        lw, uw, lh, uh = pads
        return (lw if self.rank == 0 else 0, uw if self.rank == self.holders - 1 else 0,
                lh, uh)

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

    def gather(self, x: torch.Tensor, widths: Sequence[int], kind: str,
               summed: bool = True) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last axis in rank order;
        rank r's holds ``widths[r]`` columns (one all-gather of pieces
        padded to the widest). The backward takes the rank's columns of the
        gradient summed over the ranks (``summed``: each rank's copy feeds
        its own part of the result) or of its own (every rank computes the
        same value from the copy)."""
        return _GatherColumns.apply(x, self, tuple(widths), kind, summed)

    def gather_unpadded(self, x: torch.Tensor, kind: str, summed: bool = True) -> torch.Tensor:
        """The whole frame's width of ``x`` (.., rank's unpadded columns)."""
        widths = [hi - lo for lo, hi in map(self.unpadded_columns, range(self.size))]
        return self.gather(x, widths, kind, summed)

    def gather_grid(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """The whole grid's width of ``x`` (.., rank's columns of the grid)."""
        return self.gather(x, [hi - lo for lo, hi in self.grid], kind)

    def _per_column(self, x: torch.Tensor) -> int:
        """Columns of ``x`` (..., the rank's columns at some resolution) per
        column of the grid; raises for a tensor not in the layout. A rank
        without columns takes the scale from the rows: every tensor of the
        model is at one scale along both axes."""
        lo, hi = self.grid[self.rank]
        if hi == lo:
            per, rest = divmod(x.shape[-2] * self.cell, self.height + self.pads[2] + self.pads[3])
        else:
            per, rest = divmod(x.shape[-1], hi - lo)
        if rest or per == 0:
            raise ValueError(f"{x.shape[-1]} columns are not this rank's {hi - lo} columns "
                             f"of the /{self.cell} grid at any resolution")
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
        None; a rank without columns keeps none. Raises where a halo is
        wider than the narrowest shard: it would need columns from beyond
        the neighbour. Differentiable in ``x``."""
        if left == right == 0:
            return x
        narrowest = min(hi - lo for lo, hi in self.grid if hi > lo) * self._per_column(x)
        if max(left, right) > narrowest:
            raise ValueError(f"a halo of ({left}, {right}) columns on shards as narrow as "
                             f"{narrowest} (this rank's: {x.shape[-1]})")
        return _Halo.apply(x, self, left, right, fill)

    def _halo_forward(self, x, left, right, fill) -> Tuple[torch.Tensor, int]:
        """The halo's value -> (the extended ``x``, the columns put before it)."""
        w = x.shape[-1]
        has_left, has_right = self._neighbours()
        holds = self.rank < self.holders
        if holds:
            edges = torch.cat([x[..., :right], x[..., w - left:]], dim=-1)
        else:
            edges = x.new_zeros(x.shape[:-1] + (left + right,))
        every = self.mesh.all_gather(edges, "halo")
        parts = []
        if has_left:
            parts.append(every[self.rank - 1][..., right:])
        elif holds and fill is not None and left:
            parts.append(x.new_full(x.shape[:-1] + (left,), fill))
        before = parts[0].shape[-1] if parts else 0
        parts.append(x)
        if has_right:
            parts.append(every[self.rank + 1][..., :right])
        elif holds and fill is not None and right:
            parts.append(x.new_full(x.shape[:-1] + (right,), fill))
        return torch.cat(parts, dim=-1), before

    def _halo_backward(self, g, w, left, right, before) -> torch.Tensor:
        """The halo's transpose: the gradient of the rank's own columns plus
        what its neighbours' halos read of them (one all-gather of every
        rank's halo gradients; a fill's gradient is dropped)."""
        has_left, has_right = self._neighbours()
        # the gradients of the right neighbour's first ``right`` columns and
        # of the left neighbour's last ``left`` ones, as the forward's edges
        to_right = g[..., before + w:before + w + right] if has_right else \
            g.new_zeros(g.shape[:-1] + (right,))
        to_left = g[..., :left] if has_left else g.new_zeros(g.shape[:-1] + (left,))
        every = self.mesh.all_gather(torch.cat([to_right, to_left], dim=-1), "halo backward")
        gx = g[..., before:before + w].clone()
        if has_left:
            gx[..., :right] += every[self.rank - 1][..., :right]
        if has_right:
            gx[..., w - left:] += every[self.rank + 1][..., right:]
        return gx

    # ------------------------------------------------------ halo ops
    def conv_halo(self, x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
        """``x`` with the width halo that a convolution of width ``kernel``,
        ``stride`` and ``padding`` reads beyond the shard: ``padding`` columns
        on the left, ``kernel - padding - stride`` on the right (zeros at the
        global edges)."""
        self._check_stride(x, stride)
        return self.halo(x, padding, max(0, kernel - padding - stride), 0.0)

    @staticmethod
    def conv_extended(x, weight, bias, stride, pad_rows: int, dilation=(1, 1), groups=1):
        """``F.conv2d`` of a slice extended by its halo (no width padding);
        a rank without columns gets the conv's rows and no column."""
        stride, dilation = _pair(stride), _pair(dilation)
        if x.shape[-1] == 0:
            rows = (x.shape[-2] + 2 * pad_rows - dilation[0] * (weight.shape[-2] - 1) - 1) \
                // stride[0] + 1
            return _NoColumns.apply((x.shape[0], weight.shape[0], rows, 0), x, weight, bias)
        return F.conv2d(x, weight, bias, stride, (pad_rows, 0), dilation, groups)

    def conv2d(self, x, weight, bias, stride, padding, dilation=(1, 1), groups=1):
        """``F.conv2d`` of the rank's columns."""
        stride, padding, dilation = (_pair(v) for v in (stride, padding, dilation))
        if dilation[1] != 1:
            raise ValueError("a width-sharded convolution takes no dilation along the width")
        x = self.conv_halo(x, weight.shape[-1], stride[1], padding[1])
        return self.conv_extended(x, weight, bias, stride, padding[0], dilation, groups)

    def max_pool(self, x, kernel: int, stride: int, padding: int):
        """``F.max_pool2d`` of the rank's columns; -inf beyond the global
        edges, as the pool pads."""
        self._check_stride(x, stride)
        x = self.halo(x, padding, max(0, kernel - padding - stride), -math.inf)
        if x.shape[-1] == 0:
            rows = (x.shape[-2] + 2 * padding - kernel) // stride + 1
            return _NoColumns.apply(x.shape[:-2] + (rows, 0), x)
        return F.max_pool2d(x, kernel, stride, (padding, 0))

    def conv_transpose2d(self, x, weight, bias, stride, padding, output_padding=(0, 0),
                         groups=1, dilation=(1, 1)):
        """``F.conv_transpose2d`` of the rank's columns. Output column o
        reads input columns i with 0 <= o + p - s i < k, so the shard's
        outputs [s lo, s hi) read ceil((k - 1 - p) / s) columns of the left
        neighbour and (s - 1 + p) // s of the right one (1 and 1 at k = 4,
        s = 2, p = 1), zeros beyond the global edges, as the transposed
        conv's own padding has no input there; the extended slice is
        convolved with no width padding and its outputs cropped to the
        shard's s * w columns."""
        stride, padding, output_padding, dilation = (
            _pair(v) for v in (stride, padding, output_padding, dilation))
        if output_padding[1] or dilation[1] != 1:
            raise ValueError("a width-sharded transposed convolution takes no output padding "
                             "or dilation along the width")
        k, s, p = weight.shape[-1], stride[1], padding[1]
        left = -(-(k - 1 - p) // s)
        w = x.shape[-1]
        x = self.halo(x, left, (s - 1 + p) // s, 0.0)
        if w == 0:
            rows = ((x.shape[-2] - 1) * stride[0] - 2 * padding[0]
                    + dilation[0] * (weight.shape[-2] - 1) + output_padding[0] + 1)
            return _NoColumns.apply((x.shape[0], weight.shape[1] * groups, rows, 0), x, weight,
                                    bias)
        y = F.conv_transpose2d(x, weight, bias, stride, (padding[0], 0), (output_padding[0], 0),
                               groups, dilation)
        first = s * left + p
        return y[..., first:first + s * w]

    def downsample2(self, x):
        """The /2 bilinear ``F.interpolate`` (align_corners=False) of the
        rank's columns: output column j is the mean of input columns 2j and
        2j + 1, so a shard whose first column is even needs no halo."""
        self._check_stride(x, 2)
        rows = x.shape[-2] // 2
        if x.shape[-1] == 0:
            return _NoColumns.apply(x.shape[:-2] + (rows, 0), x)
        return F.interpolate(x, size=(rows, x.shape[-1] // 2), mode="bilinear",
                             align_corners=False)

    def upsample(self, x, factor: int):
        """Bilinear ``F.interpolate`` by ``factor`` (align_corners=False) of
        the rank's columns: one input column of each neighbour, the
        extended slice upsampled, ``factor`` output columns cropped where a
        halo was added. A global edge gets no halo, so torch's own clamp
        applies there as in the single forward."""
        w = x.shape[-1]
        x = self.halo(x, 1, 1, None)
        if w == 0:
            return _NoColumns.apply(x.shape[:-2] + (x.shape[-2] * factor, 0), x)
        left = factor if self._neighbours()[0] else 0
        up = F.interpolate(x, size=(x.shape[-2] * factor, x.shape[-1] * factor),
                           mode="bilinear", align_corners=False)
        return up[..., left:left + w * factor]

    @contextlib.contextmanager
    def installed(self, module: torch.nn.Module):
        """Every submodule of ``module`` whose class takes a width mesh
        (``space``) runs on this rank's columns for the block; what they held
        before comes back after it."""
        hooked = [(m, m.space) for m in module.modules() if hasattr(type(m), "space")]
        for m, _ in hooked:
            m.space = self
        try:
            yield self
        finally:
            for m, before in hooked:
                m.space = before

    def within(self, module: torch.nn.Module, fn):
        """``fn`` that runs with this mesh installed in ``module``: the
        function a checkpoint recomputes in the backward pass, after the
        forward's installation has ended."""
        def run(*args):
            with self.installed(module):
                return fn(*args)

        return run


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _NoColumns(torch.autograd.Function):
    """The output of an op on a rank without columns: zeros of ``shape`` (no
    column), in the dtype of the first input, that depend on the op's
    ``inputs`` (None for an absent bias) with a zero gradient. The rank's
    graph then holds every op and every weight that a holder's does: its
    backward issues the same collectives, and the same parameters get a
    gradient (zeros), so the gradient bucket is the same on every rank."""

    @staticmethod
    def forward(ctx, shape, *inputs):
        ctx.metas = [None if t is None else (t.shape, t.dtype, t.device) for t in inputs]
        return inputs[0].new_zeros(shape)

    @staticmethod
    def backward(ctx, g):
        return (None, *(None if m is None else torch.zeros(m[0], dtype=m[1], device=m[2])
                        for m in ctx.metas))


class _Halo(torch.autograd.Function):
    """``WidthMesh.halo`` with its transpose as the backward."""

    @staticmethod
    def forward(ctx, x, width, left, right, fill):
        y, before = width._halo_forward(x, left, right, fill)
        ctx.width, ctx.args = width, (x.shape[-1], left, right, before)
        return y

    @staticmethod
    def backward(ctx, g):
        return ctx.width._halo_backward(g, *ctx.args), None, None, None, None


class _GatherColumns(torch.autograd.Function):
    """``WidthMesh.gather``; the backward keeps the rank's columns of the
    gradient, summed over the ranks first when ``summed``."""

    @staticmethod
    def forward(ctx, x, width, widths, kind, summed):
        wide = max(widths)
        piece = F.pad(x, (0, wide - x.shape[-1])) if x.shape[-1] < wide else x
        every = width.mesh.all_gather(piece, kind)
        lo = sum(widths[:width.rank])
        ctx.width, ctx.kind, ctx.summed = width, kind, summed
        ctx.span = (lo, lo + widths[width.rank])
        return torch.cat([every[r][..., :w] for r, w in enumerate(widths)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.width.all_reduce(g, "sum", ctx.kind + " backward")
        lo, hi = ctx.span
        return g[..., lo:hi], None, None, None, None


# the width meshes that calls build, keyed by (the mesh, the frame size, the cell):
# each with its column ranges at every resolution and, through its DataMesh,
# the pinned staging buffers. It holds no weights: a repeated call on the
# same mesh and geometry builds nothing, and a model is not kept alive by it
_SPATIAL_PLANS: dict = {}


def width_mesh(mesh, height: int, width: int, cell: int = _GRID) -> WidthMesh:
    """The width mesh of ``mesh``'s ranks over frames of height x width on
    the grid of ``cell`` columns, built once per mesh, size and cell."""
    key = (mesh, (height, width), cell)
    plan = _SPATIAL_PLANS.get(key)
    if plan is None:
        plan = _SPATIAL_PLANS[key] = WidthMesh.build(mesh, height, width, cell)
    return plan


def spatial_forward_video(apply, frames, masks, flows, n_objects, mesh):
    """Width-sharded whole-clip inference on this rank of ``mesh`` (a
    DataMesh whose ranks split the width): ``apply.forward_video`` with every activation
    of the trunks, the heads and the decoder held as the rank's columns,
    under ``torch.no_grad()``.

    frames (B, T, H, W, 3), masks (B, T, K, H, W), flows (B, T, H, W, 2),
    n_objects (B, T): the global clip, as ``RMNetApply.forward_video``
    takes it, on every rank -> est (B, T, K, H, W), the whole clip, on every
    rank (the JAX version's ``out_shardings=P()``); with ``apply.train_bn``
    -> (est, the running statistics after the clip), BatchNorm on the
    statistics of the whole frames. Weights are the replica's own. Raises
    for a data-parallel mesh on ``apply``: splitting the batch too is the
    hybrid grid's training step (``make_hybrid_mesh``)."""
    if apply.mesh is not None:
        raise ValueError("spatial_forward_video splits the width of the clip over its mesh; "
                         "to split the batch too, train on a hybrid grid (make_hybrid_mesh "
                         "and the train step)")
    frames, masks, flows = (torch.as_tensor(x, device=mesh.device)
                            for x in (frames, masks, flows))
    width = width_mesh(mesh, *masks.shape[-2:])
    run = dataclasses.replace(apply, space=width, mesh=mesh if apply.train_bn else None)
    with torch.no_grad():
        return run.forward_video(frames, masks, flows, n_objects, gathered=True)
