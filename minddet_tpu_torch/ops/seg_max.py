"""Bounded segment max of a sorted point stream, at every row of the segment
(counterpart of ``minddet_tpu/ops/seg_pallas.py``: ``seg_full_max_bounded``).

The stream PFN's non-last layers concatenate each pillar's max back onto
every point of the pillar. ``x`` (B, N, C) is the stream sorted by pillar,
``first`` (B, N) flags each segment's head and ``last`` each segment's last
kept row, at most ``bound`` rows after the head (the voxelizer's per-pillar
point cap). At every row from a segment's head to its last kept row the
result is the max of ``x`` over exactly those rows; everywhere else (rows
past their segment's last kept row, segments with none, the invalid tail)
it is 0. The reference leaves those rows to whatever its shift levels
produce, and its callers read kept rows only; ``seg_covered`` gives the mask
of the rows where the two agree.

On a CUDA tensor ``seg_full_max_bounded`` launches ``csrc/seg_full_max.cu``,
the port of the TPU kernel ``seg_pallas.py:_fwd_kernel``; on a CPU tensor it
runs the plain version ``seg_full_max_bounded_plain``, the reference's
shift-level form (``seg_running_max``, then the last row's value broadcast
back). Forward only: the backward kernel (``seg_pallas.py:_bwd_kernel``) is
not ported, so a tensor that requires grad raises.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import SEG_FULL_MAX, cuda_stream
from minddet_tpu_torch.ops.voxelize import _seg_bcast_bounded, seg_running_max

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte vector
_INT32_MAX = 2 ** 31 - 1


def _next_flag(flag: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> at each row the index of the nearest flagged row at or
    after it, N where there is none."""
    n = flag.shape[1]
    idx = torch.arange(n, device=flag.device).expand_as(flag)
    marked = torch.where(flag, idx, torch.full_like(idx, n))
    return marked.flip(1).cummin(dim=1).values.flip(1)


def seg_covered(first: torch.Tensor, last: torch.Tensor,
                bound: int) -> torch.Tensor:
    """(B, N) bool: the rows from a segment's head to its last kept row,
    i.e. with a ``last`` row at or after them, fewer than ``bound`` rows
    away, and no segment head in between. For a voxelizer stream these are
    its kept rows."""
    n = first.shape[1]
    idx = torch.arange(n, device=first.device).expand_as(first)
    nl = _next_flag(last)
    nf = _next_flag(first)
    nf_after = torch.cat([nf[:, 1:], torch.full_like(nf[:, :1], n)], dim=1)
    return (nl < n) & (nl - idx < bound) & (nl < nf_after)


def seg_full_max_bounded_plain(first: torch.Tensor, last: torch.Tensor,
                               x: torch.Tensor, bound: int) -> torch.Tensor:
    """Plain PyTorch version of the K5f kernel, on any device: the running
    max within each segment (ceil(log2(bound)) shift levels), the value at
    each ``last`` row broadcast back over the rows before it (as many
    levels again), and 0 outside ``seg_covered``."""
    full = _seg_bcast_bounded(last, seg_running_max(first, x, bound), bound)
    return torch.where(seg_covered(first, last, bound)[..., None], full,
                       torch.zeros_like(full))


def _check(first, last, x, bound) -> None:
    if x.dim() != 3 or first.shape != x.shape[:2] or last.shape != first.shape:
        raise ValueError(f"expected x (B, N, C) and first, last (B, N); got "
                         f"{tuple(x.shape)}, {tuple(first.shape)}, "
                         f"{tuple(last.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.shape[2] % _VEC[x.dtype]:
        raise ValueError(f"C={x.shape[2]} must be a multiple of "
                         f"{_VEC[x.dtype]} for {x.dtype} (16-byte vectors)")
    if bound < 1:
        raise ValueError(f"bound must be >= 1, got {bound}")
    for name, t in (("first", first), ("last", last)):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("first", first), ("last", last)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.numel() > _INT32_MAX:
        raise ValueError("x is too large for the kernel's grid")


def _seg_full_max_cuda(first, last, x, bound) -> torch.Tensor:
    _check(first, last, x, bound)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, n, c = x.shape
    fn = SEG_FULL_MAX.fn()
    SEG_FULL_MAX.launches += 1
    err = fn(x.data_ptr(), first.data_ptr(), last.data_ptr(), out.data_ptr(),
             b, n, c, bound, _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    SEG_FULL_MAX.check(err)
    return out


def seg_full_max_bounded(first: torch.Tensor, last: torch.Tensor,
                         x: torch.Tensor, bound: int) -> torch.Tensor:
    """The max of ``x`` (B, N, C) over each segment's rows from its head to
    its last kept row, at every one of those rows; 0 at every other row.
    ``first`` / ``last`` (B, N) bool flag the heads and the last kept rows;
    a last kept row lies fewer than ``bound`` rows after its head.

    A CUDA ``x`` launches the ``seg_full_max`` kernel (f32 or bf16,
    contiguous, C a multiple of 4 or 8) and raises on what it does not
    take; a CPU ``x`` runs the plain version. No gradient yet."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "seg_full_max_bounded has no backward yet: its kernel "
            "(minddet_tpu/ops/seg_pallas.py:_bwd_kernel) is not ported")
    if x.device.type == "cuda":
        return _seg_full_max_cuda(first, last, x, bound)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return seg_full_max_bounded_plain(first, last, x, bound)
