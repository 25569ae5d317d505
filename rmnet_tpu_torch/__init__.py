"""rmnet_tpu_torch: PyTorch + CUDA port of rmnet_tpu for NVIDIA Hopper.

Imports torch, numpy, scipy and Pillow only: never JAX, never the rmnet_tpu
package. Entry points: :class:`rmnet_tpu_torch.engine.InferenceEngine`,
:func:`rmnet_tpu_torch.test.test_net`,
:func:`rmnet_tpu_torch.inference.inference_net`,
:func:`rmnet_tpu_torch.train.train_net`, :class:`rmnet_tpu_torch.train.Trainer` and the
CLI ``python -m rmnet_tpu_torch.runner``.
"""
