"""Weighted running averages of scalars or metric lists (counterpart of
rmnet_tpu/utils/average_meter.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Union


class AverageMeter:
    """Tracks the current value, weighted sum, count and average per item."""

    def __init__(self, items: Optional[Sequence[str]] = None):
        self.items = list(items) if items is not None else None
        self.n_items = 1 if items is None else len(items)
        self.reset()

    def reset(self) -> None:
        self._val = [0.0] * self.n_items
        self._sum = [0.0] * self.n_items
        self._count = [0.0] * self.n_items

    def update(self, values: Union[float, Sequence[float]], weight: float = 1) -> None:
        if isinstance(values, (list, tuple)):
            for idx, v in enumerate(values):
                self._val[idx] = v
                self._sum[idx] += v * weight
                self._count[idx] += weight
        else:
            self._val[0] = values
            self._sum[0] += values * weight
            self._count[0] += weight

    def val(self, idx: Optional[int] = None):
        if idx is None:
            return self._val[0] if self.items is None else list(self._val)
        return self._val[idx]

    def count(self, idx: Optional[int] = None):
        if idx is None:
            return self._count[0] if self.items is None else list(self._count)
        return self._count[idx]

    def avg(self, idx: Optional[int] = None):
        def _avg(i):
            return self._sum[i] / self._count[i] if self._count[i] else 0.0

        if idx is None:
            return _avg(0) if self.items is None else [_avg(i) for i in range(self.n_items)]
        return _avg(idx)
