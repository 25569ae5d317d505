"""Parallelism of the port (counterpart of rmnet_tpu/parallel): data-parallel
training over ranks with the JAX mesh's semantics (``mesh``: TRAIN.DATA_PARALLEL,
one loss over the global batch, BatchNorm on global statistics), width-sharded
whole-clip inference (``spatial_forward_video``, parallel/space.py, re-exported
by ``mesh``), hybrid batch x width training on a grid of ranks
(``make_hybrid_mesh``, ``hybrid_shard_batch``) and the per-device evaluation
farm."""

from rmnet_tpu_torch.parallel.eval_farm import AsyncDeviceFarm, DeviceFarm, cuda_devices
from rmnet_tpu_torch.parallel.mesh import (DataMesh, HybridMesh, all_gather_rows,
                                           all_reduce_grads, all_reduce_sum, any_rank, barrier,
                                           broadcast_tensors, hybrid_shard_batch, init_mesh,
                                           launch, make_hybrid_mesh, mesh_devices, rank_rows,
                                           shard_batch, spatial_forward_video, WidthMesh)

__all__ = ["AsyncDeviceFarm", "DeviceFarm", "cuda_devices", "DataMesh", "HybridMesh",
           "all_gather_rows", "all_reduce_grads", "all_reduce_sum", "any_rank", "barrier",
           "broadcast_tensors", "hybrid_shard_batch", "init_mesh", "launch",
           "make_hybrid_mesh", "mesh_devices", "rank_rows", "shard_batch",
           "spatial_forward_video", "WidthMesh"]
