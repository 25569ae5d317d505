"""Tensor ops of the port (counterparts of rmnet_tpu/ops).

  pad.pad_divide_by / unpad / divide_pads   <- rmnet_tpu/ops/pad.py
  resize.resize_bilinear / resize_nearest   <- rmnet_tpu/ops/resize.py
  warp.backward_warp                        <- rmnet_tpu/ops/warp.py
  att_map.regional_attention_small          <- rmnet_tpu/ops/att_map.py
  aggregation.soft_aggregation              <- rmnet_tpu/ops/aggregation.py
  flash_attention.flash_memory_read         <- rmnet_tpu/ops/flash_attention.py
"""

from rmnet_tpu_torch.ops.pad import divide_pads, pad_divide_by, unpad
from rmnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest, scale_hw
from rmnet_tpu_torch.ops.warp import backward_warp
from rmnet_tpu_torch.ops.att_map import regional_attention_small
from rmnet_tpu_torch.ops.aggregation import soft_aggregation
from rmnet_tpu_torch.ops.flash_attention import flash_memory_read

__all__ = [
    "divide_pads",
    "pad_divide_by",
    "unpad",
    "resize_bilinear",
    "resize_nearest",
    "scale_hw",
    "backward_warp",
    "regional_attention_small",
    "soft_aggregation",
    "flash_memory_read",
]
