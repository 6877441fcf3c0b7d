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
the port of the TPU kernel ``seg_pallas.py:_fwd_kernel``, and in the
backward ``csrc/seg_full_max_bwd.cu``, the port of ``_bwd_kernel``; on a CPU
tensor it runs the plain versions ``seg_full_max_bounded_plain`` (the
reference's shift-level form: ``seg_running_max``, then the last row's
value broadcast back) and ``seg_full_max_bounded_bwd_plain``.

The gradient follows the reference's Pallas backward, the reduce-max
convention: within a segment the summed gradient of the covered rows goes to
the rows that hold the max, shared evenly among ties. (The reference's
default XLA path differentiates its shift levels instead and splits a tie
half and half at every ``maximum``, so three tied rows get 1/2, 1/4, 1/4
there.) Outside ``seg_covered`` the forward is the constant 0: dx is 0 there
and the gradient arriving at such rows is not summed.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import (SEG_FULL_MAX, SEG_FULL_MAX_BWD,
                                       cuda_stream, device_kind)
from minddet_tpu_torch.ops.voxelize import (_seg_bcast_bounded,
                                            _seg_sum_bounded,
                                            seg_running_max)

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


def seg_full_max_bounded_bwd_plain(first: torch.Tensor, last: torch.Tensor,
                                   x: torch.Tensor, m: torch.Tensor,
                                   g: torch.Tensor, bound: int
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the K5b kernel, on any device: ``m`` is the
    forward's output and ``g`` its gradient. Per segment and channel the sum
    of ``g`` and the count of the rows with ``x == m``, both over the
    covered rows (a running sum to each ``last`` row, broadcast back, in
    f32 or x's type where that is wider); ``dx = tie * gsum / max(count,
    1)``, 0 outside ``seg_covered``; rounded once to x's type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    cov = seg_covered(first, last, bound)[..., None]
    tie = ((x == m) & cov).to(acc)
    gz = torch.where(cov, g.to(acc), torch.zeros((), dtype=acc,
                                                 device=x.device))

    def over_segment(z):
        return _seg_bcast_bounded(last, _seg_sum_bounded(first, z, bound),
                                  bound)

    dx = tie * over_segment(gz) / over_segment(tie).clamp(min=1.0)
    return torch.where(cov, dx, torch.zeros_like(dx)).to(x.dtype)


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


def _seg_full_max_bwd_cuda(first, last, x, m, g, bound) -> torch.Tensor:
    _check(first, last, x, bound)
    for name, t in (("m", m), ("g", g)):
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{x.dtype} {tuple(x.shape)} tensor on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    b, n, c = x.shape
    fn = SEG_FULL_MAX_BWD.fn()
    SEG_FULL_MAX_BWD.launches += 1
    err = fn(x.data_ptr(), m.data_ptr(), g.data_ptr(), first.data_ptr(),
             last.data_ptr(), dx.data_ptr(), b, n, c, bound,
             _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    SEG_FULL_MAX_BWD.check(err)
    return dx


def _forward(first, last, x, bound) -> torch.Tensor:
    if device_kind(x) == "cuda":
        return _seg_full_max_cuda(first, last, x, bound)
    return seg_full_max_bounded_plain(first, last, x, bound)


def seg_full_max_bounded_bwd(first: torch.Tensor, last: torch.Tensor,
                             x: torch.Tensor, m: torch.Tensor,
                             g: torch.Tensor, bound: int) -> torch.Tensor:
    """The gradient of ``seg_full_max_bounded`` with respect to ``x``, from
    the forward's output ``m`` and its gradient ``g`` (see
    ``seg_full_max_bounded_bwd_plain``): a CUDA ``x`` launches the
    ``seg_full_max_bwd`` kernel (m and g contiguous, in x's type) and raises
    on what it does not take; a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _seg_full_max_bwd_cuda(first, last, x, m, g, bound)
    return seg_full_max_bounded_bwd_plain(first, last, x, m, g, bound)


class _SegFullMax(torch.autograd.Function):
    """``seg_full_max_bounded`` with its backward; saves (first, last, x,
    out) as the reference's ``_op_fwd`` does."""

    @staticmethod
    def forward(ctx, first, last, x, bound):
        out = _forward(first, last, x, bound)
        ctx.save_for_backward(first, last, x, out)
        ctx.bound = bound
        return out

    @staticmethod
    def backward(ctx, g):
        first, last, x, out = ctx.saved_tensors
        dx = seg_full_max_bounded_bwd(first, last, x, out, g.contiguous(),
                                      ctx.bound)
        return None, None, dx, None


def seg_full_max_bounded(first: torch.Tensor, last: torch.Tensor,
                         x: torch.Tensor, bound: int) -> torch.Tensor:
    """The max of ``x`` (B, N, C) over each segment's rows from its head to
    its last kept row, at every one of those rows; 0 at every other row.
    ``first`` / ``last`` (B, N) bool flag the heads and the last kept rows;
    a last kept row lies fewer than ``bound`` rows after its head.

    Differentiable with respect to ``x`` (ties share the gradient evenly).
    A CUDA ``x`` launches the ``seg_full_max`` kernel, and
    ``seg_full_max_bwd`` in the backward (f32 or bf16, contiguous, C a
    multiple of 4 or 8), and raises on what they do not take; a CPU ``x``
    runs the plain versions."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SegFullMax.apply(first, last, x, bound)
    return _forward(first, last, x, bound)
