"""Configuration read by the port (the fields it needs of rmnet_tpu/config.py,
same section and field names)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class Const:
    DATASET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    DATASET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclass
class Test:
    MEMORIZE_EVERY: int = 5
    # bank slots; 0 = AUTO: sized per video from its commit count so the
    # bank never evicts, matching the reference's unbounded bank
    MEMORY_CAPACITY: int = 0


@dataclass
class Config:
    CONST: Const = field(default_factory=Const)
    TEST: Test = field(default_factory=Test)
