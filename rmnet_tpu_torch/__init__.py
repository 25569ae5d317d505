"""rmnet_tpu_torch: PyTorch + CUDA port of rmnet_tpu for NVIDIA Hopper.

Imports torch and numpy only: never JAX, never the rmnet_tpu package.
Entry point: :class:`rmnet_tpu_torch.engine.InferenceEngine`.
"""
