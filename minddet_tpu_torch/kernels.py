"""The port's hand-written CUDA kernels: build, binding and launch counts.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` (listed in
``.gitignore``) at first use, under a name keyed on a hash of the source and
the flags, and bound with ``ctypes``: pointers from ``data_ptr()``, the
stream from ``torch.cuda.current_stream().cuda_stream``, and the C function
returns ``cudaGetLastError()``, which :meth:`CudaKernel.check` turns into an
exception. Nothing here runs at import time.

:data:`KERNELS` lists every kernel; ``chip_smoke.py`` builds them all at once
with :func:`build_all` and reads their ``launches`` counts, which each
wrapper bumps exactly where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the port's CUDA kernels are built on the GPU host")


class CudaKernel:
    """One ``csrc`` source with one exported C function.

    ``argtypes`` are the ctypes types of the C function's arguments; the
    function returns an ``int`` (a ``cudaError_t``).
    """

    def __init__(self, name: str, source: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.source = CSRC / source
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _compile_cmd(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _bind(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def fn(self):
        """The bound C function, built first if needed."""
        if self._fn is None:
            build_all([self])
        return self._fn

    def check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError_t {err}")


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, str]:
    """Build (one ``nvcc`` per source, all started together) and bind every
    kernel not built yet; kernels that share a source share its library.
    Returns each built kernel's compiler log."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [k for k in kernels if k._fn is None]
    builds = {}  # library path -> (tmp, nvcc process), None where built
    for k in todo:
        path = k.library_path()
        if path in builds:
            continue
        if path.exists():
            builds[path] = None
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        builds[path] = (tmp, subprocess.Popen(
            k._compile_cmd(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built_logs = {}
    failed = []
    for path, build in builds.items():
        if build is None:
            continue
        tmp, p = build
        log, _ = p.communicate()
        built_logs[path] = log
        if p.returncode != 0:
            failed.append(f"{path.name} (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for k in todo:
        path = k.library_path()
        k.build_log = built_logs.get(path, k.build_log)
        logs[k.name] = k.build_log
        k._bind(path)
    return logs


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def device_kind(x: torch.Tensor) -> str:
    """"cuda" or "cpu": where a wrapper launches its kernel and where it
    runs the plain version. Any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def cuda_stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_P = ctypes.c_void_p
_I = ctypes.c_int

HAT_SAMPLE_TAPS_FWD = CudaKernel(
    "hat_sample_taps_fwd", "hat_sample_taps.cu",
    # x, ys, xs, scale, out, stats, B, H, W, C, K, P, tile, rows, blocks,
    # dtype, stream
    [_P] * 6 + [_I] * 10 + [_P],
    replaces="minddet_tpu/ops/hat_sample.py:312 _fwd_taps_kernel",
)

HAT_SAMPLE_TAPS_BWD = CudaKernel(
    "hat_sample_taps_bwd", "hat_sample_taps_bwd.cu",
    # g, x, ys, xs, scale, acc, dx, dys, dxs, dscale, stats, B, H, W, C, K,
    # P, tile, rows, smem, dtype, stream
    [_P] * 11 + [_I] * 10 + [_P],
    replaces="minddet_tpu/ops/hat_sample.py:363 _bwd_taps_kernel",
)

ROTATED_IOU = CudaKernel(
    "rotated_iou_intersect", "rotated_iou.cu",
    # boxes1, boxes2, out, B, N, M, tile_rows, stream
    [_P, _P, _P, _I, _I, _I, _I, _P],
    replaces="minddet_tpu/ops/rotated_iou_pallas.py:55 _intersect_kernel",
)

SEG_FULL_MAX = CudaKernel(
    "seg_full_max", "seg_full_max.cu",
    # x, first, last, out, B, N, C, bound, tile, chunk, smem, dtype, wide,
    # stream
    [_P] * 4 + [_I] * 9 + [_P],
    replaces="minddet_tpu/ops/seg_pallas.py:108 _fwd_kernel",
)

BILINEAR_GATHER_FWD = CudaKernel(
    "bilinear_gather_fwd", "bilinear_gather.cu",
    # x, ci, cw, out, B, HW, C, P, dtype, wide, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    replaces="minddet_tpu/ops/bilinear.py:49 _fwd_kernel",
)

BILINEAR_WARP_AFFINE_FWD = CudaKernel(
    "bilinear_warp_affine_fwd", "bilinear_warp.cu",
    # x, affines, out, B, H, W, C, OH, OW, dtype, stream
    [_P, _P, _P] + [_I] * 7 + [_P],
    replaces="minddet_tpu/ops/bilinear.py:49 _fwd_kernel (through "
             "minddet_tpu/data/transforms.py:130 warp_images)",
)

SEG_FULL_MAX_BWD = CudaKernel(
    "seg_full_max_bwd", "seg_full_max_bwd.cu",
    # x, g, first, last, dx, B, N, C, g's row stride, bound, tile, chunk,
    # smem, dtype, wide, stream
    [_P] * 5 + [_I] * 10 + [_P],
    replaces="minddet_tpu/ops/seg_pallas.py:129 _bwd_kernel",
)

BILINEAR_GATHER_BWD_DX = CudaKernel(
    "bilinear_gather_bwd_dx", "bilinear_gather_bwd_dx.cu",
    # g, ci, cw, scratch, dx, B, HW, C, P, tile_rows, cap, smem, dtype,
    # stream
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    replaces="minddet_tpu/ops/bilinear.py:83 _bwd_dx_kernel",
)

BILINEAR_GATHER_BWD_DCW = CudaKernel(
    "bilinear_gather_bwd_dcw", "bilinear_gather_bwd_dcw.cu",
    # g, x, ci, dcw, B, HW, C, P, dtype, wide, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    replaces="minddet_tpu/ops/bilinear.py:115 _bwd_dcw_kernel",
)

# K2f is K1f's kernel with one tap: a second entry of the same source
HAT_SAMPLE_FLAT_FWD = CudaKernel(
    "hat_sample_flat_fwd", "hat_sample_taps.cu",
    # x, ys, xs, scale, out, stats, B, H, W, C, N, tile, rows, blocks,
    # dtype, vec, stream
    [_P] * 6 + [_I] * 10 + [_P],
    replaces="minddet_tpu/ops/hat_sample.py:171 _fwd_kernel",
)

# K2b is K1b's kernel with one tap: a second entry of the same source
HAT_SAMPLE_FLAT_BWD = CudaKernel(
    "hat_sample_flat_bwd", "hat_sample_taps_bwd.cu",
    # g, x, ys, xs, scale, acc, dx, dys, dxs, dscale, stats, B, H, W, C, N,
    # tile, rows, smem, dtype, vec, stream
    [_P] * 11 + [_I] * 10 + [_P],
    replaces="minddet_tpu/ops/hat_sample.py:207 _bwd_kernel",
)

KERNELS: List[CudaKernel] = [HAT_SAMPLE_TAPS_FWD, HAT_SAMPLE_TAPS_BWD,
                             ROTATED_IOU, SEG_FULL_MAX, SEG_FULL_MAX_BWD,
                             BILINEAR_GATHER_FWD, BILINEAR_GATHER_BWD_DX,
                             BILINEAR_GATHER_BWD_DCW, HAT_SAMPLE_FLAT_FWD,
                             HAT_SAMPLE_FLAT_BWD, BILINEAR_WARP_AFFINE_FWD]
