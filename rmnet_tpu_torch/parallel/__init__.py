"""Parallelism of the port: the per-device evaluation farm (counterpart of
rmnet_tpu/parallel). Data-parallel training is not ported yet (ROADMAP
queue 1 item 4)."""

from rmnet_tpu_torch.parallel.eval_farm import AsyncDeviceFarm, DeviceFarm, cuda_devices

__all__ = ["AsyncDeviceFarm", "DeviceFarm", "cuda_devices"]
