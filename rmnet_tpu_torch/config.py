"""Configuration read by the port (the fields it needs of rmnet_tpu/config.py,
same section and field names)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class Const:
    DATASET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    DATASET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    IGNORE_IDX: int = 255


@dataclass
class Augmentation:
    # the training crop (reference configs: 465 x 465)
    CROP_HSIZE: int = 465
    CROP_WSIZE: int = 465


@dataclass
class Train:
    BATCH_SIZE: int = 4
    N_EPOCHS: int = 200
    N_MAX_OBJECTS: int = 3
    N_MAX_FRAMES: int = 3
    NETWORK: str = "RMNet"  # 'RMNet' or 'TinyFlowNet'
    LEARNING_RATE: float = 1e-5
    BETAS: Tuple[float, float] = (0.9, 0.999)
    WEIGHT_DECAY: float = 0.0
    MEMORIZE_EVERY: int = 1
    # the block-sparse flash read with its backward kernel; False reads the
    # bank densely (the JAX default is False only because Mosaic kernels
    # cannot compile on a CPU)
    FLASH_ATTENTION: bool = True
    AUGMENTATION: Augmentation = field(default_factory=Augmentation)


@dataclass
class Test:
    MEMORIZE_EVERY: int = 5
    # test-time augmentation (InferenceEngine.multi_scale_inference): the
    # left-right flip and the frame scales whose probabilities are averaged
    FLIP_LR: bool = False
    FRAME_SCALES: Tuple[float, ...] = (1.0,)
    # bank slots; 0 = AUTO: sized per video from its commit count so the
    # bank never evicts, matching the reference's unbounded bank
    MEMORY_CAPACITY: int = 0


@dataclass
class Config:
    CONST: Const = field(default_factory=Const)
    TRAIN: Train = field(default_factory=Train)
    TEST: Test = field(default_factory=Test)
