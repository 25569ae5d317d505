"""The training augmentation's host-side op: flow re-computation after a
per-frame affine warp, and the affine warp itself (counterpart of
rmnet_tpu/ops/flow_affine.py and rmnet_tpu/native/__init__.py; reference
extensions/flow_affine_transformation/flow_affine_transformation.cpp:39-85).

rmnet_tpu_torch/csrc/flow_affine.cpp holds both ops behind a C ABI. It is
built with g++ at first use into build/native/ (the file name carries a hash
of the source, the flags and the CPU model) and bound with ctypes. A failed build raises:
there is no fallback. ``-ffp-contract=off`` keeps the float rounding of the
numpy versions (an FMA flips nearest-neighbour ties at exact .5
coordinates), so :func:`update_optical_flow` equals
:func:`update_optical_flow_numpy` and :func:`affine_warp` agrees with
:func:`affine_warp_numpy` to float rounding (the bilinear taps are summed in
another order). The numpy versions are the plain versions the tests hold the
op against.

The reference's quirk is kept in both: y1 is computed from the already
transformed x1 (flow_affine_transformation.cpp:72-73).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "rmnet_tpu_torch" / "csrc" / "flow_affine.cpp"
_BUILD_DIR = _REPO / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")


def update_optical_flow_numpy(flow: np.ndarray, m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """flow (H, W, 2) float32 (dx, dy) from frame t to t-1; m1, m2 (2, 3) the
    affines applied to frames t-1 and t -> the (H, W, 2) flow between the
    warped frames."""
    h, w = flow.shape[:2]
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x2 = np.round(m2[0, 0] * jj + m2[0, 1] * ii + m2[0, 2])
    y2 = np.round(m2[1, 0] * jj + m2[1, 1] * ii + m2[1, 2])
    x1 = jj + flow[..., 0]
    y1 = ii + flow[..., 1]
    # the reference's order: y1 reads the new x1
    x1_new = np.round(m1[0, 0] * x1 + m1[0, 1] * y1 + m1[0, 2])
    y1_new = np.round(m1[1, 0] * x1_new + m1[1, 1] * y1 + m1[1, 2])
    out = np.empty_like(flow)
    out[..., 0] = np.clip(x1_new, 0, w - 1) - np.clip(x2, 0, w - 1)
    out[..., 1] = np.clip(y1_new, 0, h - 1) - np.clip(y2, 0, h - 1)
    return out.astype(np.float32)


def affine_warp_numpy(img, matrix, fill, nearest=False) -> np.ndarray:
    """Inverse-mapping warp: out(y, x) = img(matrix . (x, y, 1)), ``matrix``
    the (2, 3) dst -> src map; bilinear or nearest (half away from zero)
    sampling, ``fill`` for sources outside the image. (H, W) or (H, W, C)
    in, float32 out."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    fill = np.broadcast_to(np.asarray(fill, np.float32), (c,))
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    sx = matrix[0, 0] * xs + matrix[0, 1] * ys + matrix[0, 2]
    sy = matrix[1, 0] * xs + matrix[1, 1] * ys + matrix[1, 2]
    imgf = img.astype(np.float32)
    if nearest:
        ix = np.floor(sx + 0.5).astype(np.int64)
        iy = np.floor(sy + 0.5).astype(np.int64)
        oob = (ix < 0) | (iy < 0) | (ix >= w) | (iy >= h)
        out = imgf[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        out[oob] = fill
    else:
        x0 = np.floor(sx).astype(np.int64)
        y0 = np.floor(sy).astype(np.int64)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]

        def tap(yy, xx):
            oob = (xx < 0) | (yy < 0) | (xx >= w) | (yy >= h)
            v = imgf[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            v[oob] = fill
            return v

        out = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
               + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)
    return out[..., 0] if squeeze else out


_lock = threading.Lock()
_lib = None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` builds for this CPU only."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return platform.processor()


def library_path() -> Path:
    """build/native/libflow_affine_<tag>.so, the tag a hash of the source,
    the flags and the CPU model."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode() + _cpu_model().encode())
    return _BUILD_DIR / f"libflow_affine_{h.hexdigest()[:12]}.so"


def load():
    """The op's library, built first when this source has no build yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}) on {_SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        f32p, size = ctypes.POINTER(ctypes.c_float), ctypes.c_size_t
        lib.update_optical_flow.argtypes = [f32p, f32p, f32p, f32p, size, size]
        lib.update_optical_flow.restype = None
        lib.affine_warp.argtypes = [f32p, f32p, f32p, f32p, size, size, size, ctypes.c_int]
        lib.affine_warp.restype = None
        _lib = lib
        return lib


def update_optical_flow(flow: np.ndarray, m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """:func:`update_optical_flow_numpy` through the native op."""
    lib = load()
    flow = np.ascontiguousarray(flow, np.float32)
    m1 = np.ascontiguousarray(m1, np.float32)
    m2 = np.ascontiguousarray(m2, np.float32)
    out = np.empty_like(flow)
    lib.update_optical_flow(_f32p(flow), _f32p(m1), _f32p(m2), _f32p(out),
                            flow.shape[0], flow.shape[1])
    return out


def affine_warp(img, matrix, fill, nearest=False) -> np.ndarray:
    """:func:`affine_warp_numpy` through the native op."""
    lib = load()
    squeeze = img.ndim == 2
    img = np.ascontiguousarray(img[..., None] if squeeze else img, np.float32)
    h, w, c = img.shape
    matrix = np.ascontiguousarray(matrix, np.float32)
    fill = np.ascontiguousarray(np.broadcast_to(np.asarray(fill, np.float32), (c,)))
    out = np.empty_like(img)
    lib.affine_warp(_f32p(img), _f32p(matrix), _f32p(fill), _f32p(out), h, w, c,
                    1 if nearest else 0)
    return out[..., 0] if squeeze else out
