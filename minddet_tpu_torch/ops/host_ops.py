"""Host ops: rotated IoU matrices, greedy NMS and point-in-rotated-box tests
on the CPU (counterpart of ``minddet_tpu/ops/host_ops.py``:
``rotated_iou_matrix``, ``rotated_nms``, ``nms_2d``, ``points_in_rboxes``
and ``available``).

The C++ is the port's own copy, ``csrc/host/host_ops.cpp``, compiled at
first use with the host's C++ compiler (``g++ -O3 -fPIC -std=c++17 -shared
-pthread``, as the JAX package's ``native/Makefile``, without
``-march=native``) into ``_build/`` under a name keyed on a hash of the
source and the flags, and bound with ``ctypes``. A failed build raises:
there is no fallback, because the GT-database sampler and the per-object
noise accept or reject a candidate on ``iou.max() > 1e-3`` and ``<= 0.0``,
and another IoU would flip those decisions at tangent boxes. ``ctypes``
releases the GIL for each call, and each call spreads its rows over the
host's cores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "host_ops.cpp"
BUILD = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"host_ops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    cxx = os.environ.get("CXX", "g++")
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE.name} (exit "
                           f"{p.returncode}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64, f32 = ctypes.c_int64, ctypes.c_float
        lib.rotated_iou_matrix.argtypes = [f32p, i64, f32p, i64, ctypes.c_int,
                                           f32p]
        lib.rotated_iou_matrix.restype = None
        for name in ("rotated_nms", "nms_2d"):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [f32p, f32p, i64, f32, f32, i64, i64p]
        lib.points_in_rboxes.argtypes = [f32p, i64, f32p, i64, u8p]
        lib.points_in_rboxes.restype = None
        lib.host_ops_version.restype = ctypes.c_int
        _LIB = lib
        return lib


def available() -> bool:
    """True where the library builds and loads."""
    try:
        return _load().host_ops_version() >= 1
    except Exception:
        return False


def rotated_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray,
                       criterion: int = -1) -> np.ndarray:
    """(N, 5) x (M, 5) [x, y, w, l, yaw] -> (N, M) f32: the intersection
    over the union (``criterion`` -1), over area(box1) (0) or over
    area(box2) (1), 0 where that is at most 1e-8."""
    lib = _load()
    b1 = np.ascontiguousarray(boxes1, np.float32)
    b2 = np.ascontiguousarray(boxes2, np.float32)
    out = np.empty((len(b1), len(b2)), np.float32)
    lib.rotated_iou_matrix(b1, len(b1), b2, len(b2), criterion, out)
    return out


def _greedy(fn, boxes, scores, iou_threshold, score_threshold, max_outputs
            ) -> np.ndarray:
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    b = np.ascontiguousarray(np.asarray(boxes, np.float32)[order])
    s = np.ascontiguousarray(scores[order])
    m = len(b) if max_outputs is None else max_outputs
    keep = np.empty(min(m, len(b)), np.int64)
    thr = score_threshold if np.isfinite(score_threshold) else -3.4e38
    n = fn(b, s, len(b), iou_threshold, thr, len(keep), keep)
    return order[keep[:n]]


def rotated_nms(boxes: np.ndarray, scores: np.ndarray,
                iou_threshold: float = 0.1,
                score_threshold: float = -np.inf,
                max_outputs: Optional[int] = None) -> np.ndarray:
    """Greedy rotated NMS of (N, 5) boxes -> the kept indices into
    ``boxes``, by descending score (ties in index order)."""
    return _greedy(_load().rotated_nms, boxes, scores, iou_threshold,
                   score_threshold, max_outputs)


def nms_2d(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5,
           score_threshold: float = -np.inf,
           max_outputs: Optional[int] = None) -> np.ndarray:
    """Greedy NMS of (N, 4) corner boxes, as ``rotated_nms``."""
    return _greedy(_load().nms_2d, boxes, scores, iou_threshold,
                   score_threshold, max_outputs)


def points_in_rboxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, >= 2) points x (M, 5) rotated boxes -> (N, M) bool: the point's
    (x, y) on or inside the box."""
    lib = _load()
    p = np.ascontiguousarray(np.asarray(points)[:, :2], np.float32)
    b = np.ascontiguousarray(boxes, np.float32)
    out = np.empty((len(p), len(b)), np.uint8)
    lib.points_in_rboxes(p, len(p), b, len(b), out)
    return out.astype(bool)
