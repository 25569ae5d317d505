"""Parallelism of the port (counterpart of rmnet_tpu/parallel): data-parallel
training over ranks with the JAX mesh's semantics (``mesh``: TRAIN.DATA_PARALLEL,
one loss over the global batch, BatchNorm on global statistics), width-sharded
whole-clip inference (``spatial_forward_video``, parallel/space.py, re-exported
by ``mesh``) and the per-device evaluation farm. The JAX package's hybrid
(data x width) training is not ported yet (ROADMAP queue 1)."""

from rmnet_tpu_torch.parallel.eval_farm import AsyncDeviceFarm, DeviceFarm, cuda_devices
from rmnet_tpu_torch.parallel.mesh import (DataMesh, all_gather_rows, all_reduce_grads,
                                           all_reduce_sum, any_rank, barrier,
                                           broadcast_tensors, init_mesh, launch,
                                           mesh_devices, rank_rows, shard_batch,
                                           spatial_forward_video, WidthMesh)

__all__ = ["AsyncDeviceFarm", "DeviceFarm", "cuda_devices", "DataMesh", "all_gather_rows",
           "all_reduce_grads", "all_reduce_sum", "any_rank", "barrier", "broadcast_tensors",
           "init_mesh", "launch", "mesh_devices", "rank_rows", "shard_batch",
           "spatial_forward_video", "WidthMesh"]
