"""Data parallelism over processes (counterpart of rmnet_tpu/parallel/mesh.py's
``make_mesh``, ``data_parallel_sharding``, ``replicate`` and ``shard_batch``).

Under the JAX mesh a data-parallel step is one logical program: GSPMD shards
the batch along the axis "data" and inserts every cross-device reduction, so
the step computes the gradient of ONE loss over the global batch. Here each
rank is a process with its own copy of the model, and every value that
crosses ranks is an explicit collective:

  * the loss: ``all_gather_rows`` of the estimate and the labels, then the
    Lovász and NLL terms over the gathered global batch on every rank (its
    backward keeps the rank's own rows of the gradient: every rank holds the
    same loss, so nothing is summed);
  * trainable BatchNorm: ``all_reduce_sum`` of the per-channel sums, forward
    and backward (SyncBatchNorm);
  * the parameters' gradients: one all-reduce SUM over a flat bucket after the
    backward (``all_reduce_grads``), so every rank holds the gradient of the
    global loss and Adam keeps the replicas bit-identical;
  * the parameters at the start (``broadcast_tensors`` from rank 0).

Every collective of data parallelism is an all-reduce or a broadcast. A gloo
group is never handed CUDA tensors: by design, ``DataMesh`` stages a CUDA
tensor of a gloo group through pinned host memory (gloo's transport is the
host's in any case), in buffers it keeps by shape and type and reuses, and
hands host tensors to gloo as they are. An NCCL group works on the device.

The same 1-D mesh serves the width mesh of ``spatial_forward_video``
(parallel/space.py, re-exported here), which adds an all-gather along the
width (``all_gather``) and all-reduces with MIN and MAX (``all_reduce_``'s
``op``). A hybrid grid (``make_hybrid_mesh``) holds three: the world's, and
the rank's row and column of the grid as process groups of their own
(``group``); ``hybrid_shard_batch`` places a batch on it.

``rank_rows`` is the rank's share of a global batch in the layout of
TRAIN.GRAD_ACCUM_STEPS: micro-batch j is global rows [j B/A, (j+1) B/A), as
the JAX package reshapes the batch (rmnet_tpu/core/train.py:155-158), and
rank r holds the r-th B/(A n) of each micro-batch.

``launch`` runs a function on n ranks, each a process started with the
``spawn`` method (no CUDA state is inherited), with a deadline; a rank that
fails, or a collective that waits past the group's timeout, fails the launch,
and every rank is stopped.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import multiprocessing
import os
import queue
import signal
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0  # a rank waits this long in a collective, validation included
_LOG_FORMAT = "[%(levelname)s] %(asctime)s %(message)s"


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(eq=False)
class DataMesh:
    """One rank of a 1-D mesh, along the batch or the width: its rank, the
    number of ranks, its device and the process group's backend; ``group``
    the process group (None: the world's), a row or a column of a hybrid
    grid (:func:`make_hybrid_mesh`). ``counts`` holds the collectives it ran
    by kind: [calls, bytes of their results, seconds]; the seconds run from
    the moment the collective's input is on the host (a gloo group's CUDA
    tensor staged) to the moment its result is back. ``staging`` holds the
    pinned host buffers of a gloo group's CUDA tensors, by (shape, dtype,
    role)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    counts: Dict[str, list] = dataclasses.field(default_factory=dict)
    staging: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict)
    group: Optional[Any] = None

    @property
    def comm_device(self) -> torch.device:
        """Where a tensor goes to a collective without staging."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _pinned(self, like: torch.Tensor, role: str) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype, role)
        buf = self.staging.get(key)
        if buf is None:
            buf = self.staging[key] = torch.empty(like.shape, dtype=like.dtype,
                                                  pin_memory=True)
        return buf

    def _run(self, op: Callable, t: torch.Tensor, kind: str,
             out: Optional[torch.Tensor] = None) -> None:
        """``op(t)`` in place, or ``op(t, out)`` into ``out``: CUDA tensors of
        a gloo group go through pinned host buffers and back."""
        result = t if out is None else out
        staged = self.backend == "gloo" and t.is_cuda
        src = self._pinned(t, "in").copy_(t) if staged else t
        t0 = time.perf_counter()
        if out is None:
            op(src)
            dst = src
        else:
            dst = self._pinned(out, "out") if staged else out
            op(src, dst)
        if staged:
            result.copy_(dst)
        calls = self.counts.setdefault(kind, [0, 0, 0.0])
        calls[0] += 1
        calls[1] += result.numel() * result.element_size()
        calls[2] += time.perf_counter() - t0

    def all_reduce_(self, t: torch.Tensor, kind: str, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` (contiguous) over the ranks with ``op`` ("sum",
        "min" or "max"), in place."""
        reduce_op = _REDUCE_OPS[op]
        self._run(lambda x: dist.all_reduce(x, op=reduce_op, group=self.group), t, kind)
        return t

    def all_gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) -> (size, *t.shape) in rank
        order, on ``t``'s device."""
        t = t.contiguous()
        out = t.new_empty((self.size,) + tuple(t.shape))
        self._run(lambda x, y: dist.all_gather(list(y.unbind(0)), x, group=self.group), t,
                  kind, out)
        return out

    def broadcast_(self, t: torch.Tensor, kind: str, src: int = 0) -> torch.Tensor:
        """``t`` (contiguous) of rank ``src`` (of this mesh) on every rank,
        in place."""
        root = src if self.group is None else dist.get_global_rank(self.group, src)
        self._run(lambda x: dist.broadcast(x, root, group=self.group), t, kind)
        return t

    def close(self) -> None:
        """Leave the process group: the world's ends every group of it."""
        if self.group is None:
            dist.destroy_process_group()


def init_mesh(rank: int, size: int, init_method: str, backend: str, device,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """Join the process group as ``rank`` of ``size`` on ``device`` ->
    the rank's DataMesh. NCCL needs a CUDA device per rank; gloo takes the
    CPU or CUDA devices (several ranks may share one)."""
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DataMesh(rank, size, device, backend)


def mesh_devices(n: int, device=None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of ``n`` ranks: ``devices`` as given (one per rank), or
    ``n`` times the CPU when ``device`` is the CPU, else ``cuda:0`` ..
    ``cuda:n-1``; raises when fewer CUDA devices are present (as
    rmnet_tpu/parallel/mesh.py:22-26 does)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices given for {n} ranks")
        return devices
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > present:
        raise ValueError(f"requested {n} devices, only {present} CUDA devices present")
    return [torch.device("cuda", i) for i in range(n)]


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    cuda = [d for d in devices if d.type == "cuda"]
    return "nccl" if len(cuda) == len(devices) == len(set(cuda)) else "gloo"


# --------------------------------------------------------------- the batch
def rank_rows(batch_size: int, size: int, accum: int, rank: int) -> List[int]:
    """The global rows of ``rank``'s share, in micro-batch order: of each of
    the ``accum`` micro-batches of ``batch_size / accum`` consecutive rows,
    the rank-th of ``size`` equal parts."""
    if batch_size % (accum * size):
        raise ValueError(f"{size} ranks x {accum} micro-batches do not divide a batch of "
                         f"{batch_size}")
    micro = batch_size // accum
    part = micro // size
    return [j * micro + rank * part + i for j in range(accum) for i in range(part)]


def shard_batch(batch: Mapping[str, Any], mesh: DataMesh, accum: int = 1) -> Dict[str, Any]:
    """The rank's rows (``rank_rows``) of every array of a global batch:
    tensors stay on their device, numpy arrays stay numpy."""
    n_rows = len(next(iter(batch.values())))
    rows = rank_rows(n_rows, mesh.size, accum, mesh.rank)
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        else:
            out[k] = np.asarray(v)[rows]
    return out


# ------------------------------------------------------------ the hybrid grid
@dataclasses.dataclass(eq=False)
class HybridMesh:
    """One rank of an n_data x n_space grid of ranks (the counterpart of
    rmnet_tpu/parallel/mesh.py's ``make_hybrid_mesh``): ``world``, every
    rank (BatchNorm's statistics, the parameters' gradients); ``data``, the
    ranks of this rank's space index, which split the batch; ``space``, the
    ranks of its data index, which split the frame width. World rank r sits
    at (r // n_space, r % n_space), as the JAX mesh reshapes its devices."""

    world: DataMesh
    data: DataMesh
    space: DataMesh

    @property
    def device(self) -> torch.device:
        return self.world.device

    def meshes(self) -> Dict[str, DataMesh]:
        return {"world": self.world, "data": self.data, "space": self.space}


def make_hybrid_mesh(n_data: int, n_space: int, world: DataMesh,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> HybridMesh:
    """This rank's place in an n_data x n_space grid of the ``world``'s
    ranks (a DataMesh of the default group, as :func:`launch` and
    :func:`init_mesh` make it). Every rank makes every row and column group,
    in one order (a collective call on each). Raises unless the grid takes
    exactly the world's ranks."""
    need = n_data * n_space
    if need > world.size:
        raise ValueError(f"requested {need} devices, only {world.size} ranks present")
    if need != world.size or world.group is not None:
        raise ValueError(f"a {n_data} x {n_space} grid takes all ranks of a world, got "
                         f"{world.size}{'' if world.group is None else ' of a subgroup'}")
    timeout = datetime.timedelta(seconds=timeout_s)
    rows = [dist.new_group(list(range(d * n_space, (d + 1) * n_space)), timeout=timeout)
            for d in range(n_data)]
    cols = [dist.new_group(list(range(s, need, n_space)), timeout=timeout)
            for s in range(n_space)]
    d, s = divmod(world.rank, n_space)
    return HybridMesh(world,
                      DataMesh(d, n_data, world.device, world.backend, group=cols[s]),
                      DataMesh(s, n_space, world.device, world.backend, group=rows[d]))


def hybrid_shard_batch(batch: Mapping[str, Any], mesh: HybridMesh,
                       accum: int = 1) -> Dict[str, Any]:
    """The rank's share of a global training batch on a hybrid grid (the
    counterpart of rmnet_tpu/parallel/mesh.py's ``hybrid_shard_batch``):
    its rows along "data" in the layout of :func:`rank_rows` (micro-batches
    of TRAIN.GRAD_ACCUM_STEPS as data parallelism takes them), the same on
    every rank of a space group. Frames, masks and flows keep the whole
    width: ``RMNetApply.forward_video`` under the width mesh takes the
    rank's columns of them itself (whole /16 columns of the padded frame,
    ``WidthMesh``), as the inference path does, since the next frame's warp
    reads the whole previous estimate; n_objects splits over "data" only, as
    in the JAX layout."""
    return shard_batch(batch, mesh.data, accum)


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    by: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by.setdefault(t.dtype, []).append(t)
    return by


def broadcast_tensors(tensors: Iterable[torch.Tensor], mesh: DataMesh, kind: str,
                      src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place: one
    broadcast of a flat bucket per dtype, on the group's device."""
    for group in _buckets(tensors).values():
        flat = torch.cat([t.detach().reshape(-1) for t in group]).to(mesh.comm_device)
        mesh.broadcast_(flat, kind, src)
        off = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: DataMesh) -> None:
    """Sum the gradients of ``params`` over the ranks, in place: one
    all-reduce of a flat bucket per dtype (parameters without a gradient
    have none on any rank: every rank runs the same graph, a rank of a width
    mesh that holds no column too, whose ops give its weights a zero
    gradient; parallel/space.py)."""
    grads = [p.grad for p in params if p.grad is not None]
    for group in _buckets(grads).values():
        flat = torch.cat([g.reshape(-1) for g in group])
        mesh.all_reduce_(flat, "gradients")
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


def any_rank(flag: bool, mesh: DataMesh, kind: str = "stop") -> bool:
    """True on every rank when ``flag`` is True on any."""
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.comm_device)
    return bool(mesh.all_reduce_(t, kind).item() > 0)


def barrier(mesh: DataMesh) -> None:
    """Wait for every rank (within the group's timeout)."""
    mesh.all_reduce_(torch.zeros(1, device=mesh.comm_device), "barrier")


# ---------------------------------------------------- autograd collectives
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format), kind)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce_(grad, ctx.kind + " backward"), None, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, kind):
        rows = x.shape[0]
        ctx.lo, ctx.hi = mesh.rank * rows, (mesh.rank + 1) * rows
        out = x.new_zeros((mesh.size * rows,) + tuple(x.shape[1:]))
        out[ctx.lo:ctx.hi] = x
        return mesh.all_reduce_(out, kind)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.hi], None, None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh, kind: str = "sum") -> torch.Tensor:
    """The sum of ``x`` over the ranks; its backward sums the gradient over
    the ranks too (a collective inside the model, whose every rank
    contributes to the one global loss)."""
    return _AllReduceSum.apply(x, mesh, kind)


def all_gather_rows(x: torch.Tensor, mesh: DataMesh, kind: str = "gather") -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, as an all-reduce of a zero buffer that holds the rank's rows; the
    backward keeps the rank's rows of the gradient (every rank computes the
    same loss from the gathered tensor, so nothing is summed)."""
    return _AllGatherRows.apply(x, mesh, kind)


# ------------------------------------------------------------------ launch
def _rank_main(rank, size, init_method, backend, device, timeout_s, fn, args, results,
               log_level):
    logging.basicConfig(format=_LOG_FORMAT,
                        level=log_level if rank == 0 else max(log_level, logging.WARNING))
    try:
        mesh = init_mesh(rank, size, init_method, backend, device, timeout_s)
        try:
            value = fn(mesh, *args)
        finally:
            mesh.close()
    except BaseException:  # noqa: B902  (reported to the parent, then exit 1)
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def launch(fn: Callable, args: tuple, devices: Sequence, backend: str,
           timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: Optional[float] = None,
           init_method: Optional[str] = None) -> List[Any]:
    """``fn(mesh, *args)`` on one rank per entry of ``devices``, each in a
    process started with ``spawn`` -> the ranks' results in rank order.
    ``fn`` and ``args`` are pickled (``fn`` by its import path). The group
    meets at ``init_method`` (default: a file store in a new temporary
    directory). SIGTERM and SIGINT to this process go on to the ranks. Raises
    when a rank fails (with its traceback) or ``deadline_s`` passes; every
    rank still running is then killed."""
    n = len(devices)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rmnet_mesh_") as tmp:
        init_method = init_method or f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, init_method, backend, str(devices[r]), timeout_s, fn,
                                   args, results, logging.getLogger().getEffectiveLevel()))
                 for r in range(n)]
        previous = {}

        def forward(signum, frame):
            for p in procs:
                if p.pid is not None and p.exitcode is None:
                    os.kill(p.pid, signum)

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, forward)
        try:
            for p in procs:
                p.start()
            return _collect(procs, results, deadline_s)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.exitcode is None:
                    p.kill()
                p.join(10)


def _collect(procs, results, deadline_s) -> List[Any]:
    """Every rank's result from the queue (read before the ranks are
    joined); raises on the first failure, a rank that died without a result,
    or the deadline."""
    t_end = None if deadline_s is None else time.monotonic() + deadline_s
    done: Dict[int, Any] = {}
    while len(done) < len(procs):
        try:
            rank, ok, value = results.get(timeout=0.5)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in done]
            if dead:
                # its result may still be in the pipe: one more look
                try:
                    rank, ok, value = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
            elif t_end is not None and time.monotonic() > t_end:
                raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(done))} did "
                                   f"not finish within {deadline_s} s")
            else:
                continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        done[rank] = value
    return [done[r] for r in range(len(procs))]


# the width mesh's counterpart of rmnet_tpu/parallel/mesh.py:100-149, here
# where its JAX counterpart lives (parallel/space.py imports nothing of this
# module)
from rmnet_tpu_torch.parallel.space import (WidthMesh, column_split,  # noqa: E402
                                            spatial_forward_video, width_mesh)
