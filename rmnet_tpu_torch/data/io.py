"""File IO (counterpart of rmnet_tpu/data/io.py): images through Pillow,
Middlebury .flo optical flow, an optional in-process LRU byte cache."""

from __future__ import annotations

import io as _io
import os
import struct
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
from PIL import Image

_FLO_MAGIC = b"PIEH"


def read_flo(data: bytes) -> np.ndarray:
    """Parse a Middlebury .flo buffer -> (H, W, 2) float32."""
    if data[:4] != _FLO_MAGIC:
        raise ValueError("Invalid .flo file format.")
    w = int.from_bytes(data[4:8], byteorder="little")
    h = int.from_bytes(data[8:12], byteorder="little")
    return np.frombuffer(data[12:], dtype=np.float32).reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write a (H, W, 2) float32 flow as .flo."""
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(_FLO_MAGIC)
        f.write(struct.pack("<ii", w, h))
        f.write(flow.tobytes())


class _LRUBytes:
    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.size = 0
        self._od: "OrderedDict[str, bytes]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return self._od[key]
        return None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            if key in self._od:
                return
            self._od[key] = data
            self.size += len(data)
            while self.size > self.capacity and self._od:
                _, evicted = self._od.popitem(last=False)
                self.size -= len(evicted)


class IO:
    """File reader with per-extension dispatch and an optional byte cache."""

    cache: Optional[_LRUBytes] = None

    @classmethod
    def enable_cache(cls, capacity_bytes: int = 4 << 30) -> None:
        cls.cache = _LRUBytes(capacity_bytes)

    @classmethod
    def _read_bytes(cls, file_path: str) -> bytes:
        if cls.cache is not None:
            data = cls.cache.get(file_path)
            if data is not None:
                return data
        with open(file_path, "rb") as f:
            data = f.read()
        if cls.cache is not None:
            cls.cache.put(file_path, data)
        return data

    @classmethod
    def get(cls, file_path: str):
        """PIL.Image for .png/.jpg, (H, W, 2) ndarray for .flo, None for a
        missing file."""
        if not os.path.exists(file_path):
            return None
        ext = os.path.splitext(file_path)[1].lower()
        if ext in (".png", ".jpg", ".jpeg"):
            return Image.open(_io.BytesIO(cls._read_bytes(file_path)))
        if ext == ".flo":
            return read_flo(cls._read_bytes(file_path))
        raise ValueError(f"Unsupported file extension: {ext}")
