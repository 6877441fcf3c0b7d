"""Batched weighted row gather and the bilinear sampling built on it
(counterpart of ``minddet_tpu/ops/bilinear.py``: ``bilinear_gather``,
``bilinear_sample_2d``).

    out[b, p, :] = sum_{c < 4} cw[b, p, c] * x[b, ci[b, p, c], :]

with x (B, HW, C), ci (B, P, 4) int32 row indices and cw (B, P, 4) f32
weights. A corner with ``ci < 0`` is skipped whatever its weight; an index
past the last row reads the last row (the reference's clipped gather). The
sum is taken in f32 and rounded once to x's type.

``bilinear_gather`` is differentiable with respect to ``x`` and ``cw``
through a ``torch.autograd.Function``, and ``bilinear_sample_2d`` with
respect to the map and, through the weights, the coordinates:

    dx[b, q, :]  = sum_{p, c: ci[b, p, c] = q} cw[b, p, c] * g[b, p, :]
    dcw[b, p, c] = <g[b, p, :], x[b, ci[b, p, c], :]>

with skipped corners (``ci < 0``) adding nothing to dx and getting a zero
dcw. dx is summed in f32 and rounded once to x's type.

On a CUDA tensor ``bilinear_gather`` launches ``csrc/bilinear_gather.cu``,
the port of the TPU kernel ``bilinear.py:_fwd_kernel``, and in the backward
``csrc/bilinear_gather_bwd_dx.cu`` (``_bwd_dx_kernel``) for a map that needs
a gradient and ``csrc/bilinear_gather_bwd_dcw.cu`` (``_bwd_dcw_kernel``) for
weights that do; on a CPU tensor it runs the plain versions
``bilinear_gather_plain``, ``bilinear_gather_bwd_dx_plain`` and
``bilinear_gather_bwd_dcw_plain``, the reference's XLA forms.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import (BILINEAR_GATHER_BWD_DCW,
                                       BILINEAR_GATHER_BWD_DX,
                                       BILINEAR_GATHER_FWD, cuda_stream,
                                       device_kind)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte vector
_INT32_MAX = 2 ** 31 - 1


def bilinear_gather_plain(x: torch.Tensor, ci: torch.Tensor,
                          cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K3f kernel, on any device: gather the
    four (clipped) rows, weight them (zero where ``ci < 0``), sum in f32
    (or x's type where that is wider), round once."""
    b, p, _ = ci.shape
    hw, ch = x.shape[1], x.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    idx = ci.clamp(0, hw - 1).long().reshape(b, p * 4, 1).expand(-1, -1, ch)
    rows = torch.gather(x, 1, idx).reshape(b, p, 4, ch).to(acc)
    w = (cw * (ci >= 0)).to(acc)
    return (rows * w[..., None]).sum(dim=2).to(x.dtype)


def _clipped_rows(ci: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, P, 4) indices -> (B, P * 4) int64 rows, clipped into [0, hw)."""
    return ci.clamp(0, hw - 1).long().reshape(ci.shape[0], -1)


def bilinear_gather_bwd_dx_plain(g: torch.Tensor, ci: torch.Tensor,
                                 cw: torch.Tensor, hw: int) -> torch.Tensor:
    """Plain PyTorch version of the K3dx kernel, on any device: g (B, P, C)
    -> dx (B, hw, C) in g's type. Each corner's ``cw * g`` (zero where
    ``ci < 0``) is added into its (clipped) row with ``index_add_``, in f32
    (or g's type where that is wider), and the sum is rounded once."""
    b, p, ch = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    w = (cw * (ci >= 0)).to(acc)
    contrib = w[..., None] * g.to(acc)[:, :, None, :]  # (B, P, 4, C)
    base = torch.arange(b, device=g.device)[:, None] * hw
    dx = torch.zeros(b * hw, ch, dtype=acc, device=g.device)
    dx.index_add_(0, (_clipped_rows(ci, hw) + base).reshape(-1),
                  contrib.reshape(-1, ch))
    return dx.reshape(b, hw, ch).to(g.dtype)


def bilinear_gather_bwd_dcw_plain(g: torch.Tensor, x: torch.Tensor,
                                  ci: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K3dcw kernel, on any device: g (B, P,
    C) and x (B, HW, C) -> dcw (B, P, 4) f32: the dot product of g's row
    with each of its four (clipped) rows of x, in f32 (or x's type where
    that is wider), 0 where ``ci < 0``."""
    b, p, ch = g.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    idx = _clipped_rows(ci, x.shape[1])[..., None].expand(-1, -1, ch)
    rows = torch.gather(x, 1, idx).reshape(b, p, 4, ch).to(acc)
    dots = (rows * g.to(acc)[:, :, None, :]).sum(-1)
    return (dots * (ci >= 0)).float()


def _check(x, ci, cw) -> None:
    if x.dim() != 3 or ci.dim() != 3 or ci.shape[2] != 4 \
            or cw.shape != ci.shape or ci.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (B, HW, C) and ci, cw (B, P, 4); got "
                         f"{tuple(x.shape)}, {tuple(ci.shape)}, "
                         f"{tuple(cw.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if ci.dtype != torch.int32 or cw.dtype != torch.float32:
        raise TypeError(f"ci must be int32 and cw float32, got {ci.dtype} "
                        f"and {cw.dtype}")
    if x.shape[2] % _VEC[x.dtype]:
        raise ValueError(f"C={x.shape[2]} must be a multiple of "
                         f"{_VEC[x.dtype]} for {x.dtype} (16-byte vectors)")
    if x.shape[1] < 1:
        raise ValueError("x has no rows to gather")
    for name, t in (("x", x), ("ci", ci), ("cw", cw)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_int32(x, ci) -> None:
    """K3f and K3dcw index x and their (B, P, C) side with 32-bit values."""
    if max(x.numel(), ci.shape[0] * ci.shape[1] * x.shape[2]) > _INT32_MAX:
        raise ValueError("tensors too large for the kernel's 32-bit indices")


def _bilinear_gather_cuda(x, ci, cw) -> torch.Tensor:
    _check(x, ci, cw)
    _check_int32(x, ci)
    b, hw, ch = x.shape
    p = ci.shape[1]
    out = torch.empty(b, p, ch, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = BILINEAR_GATHER_FWD.fn()
    BILINEAR_GATHER_FWD.launches += 1
    err = fn(x.data_ptr(), ci.data_ptr(), cw.data_ptr(), out.data_ptr(), b,
             hw, ch, p, _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    BILINEAR_GATHER_FWD.check(err)
    return out


def _check_g(g, x, ci) -> None:
    want = (ci.shape[0], ci.shape[1], x.shape[2])
    if (g.shape != want or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous() or g.data_ptr() % 16):
        raise ValueError(f"g must be a contiguous, 16-byte aligned {x.dtype} "
                         f"(B, P, C) = {want} tensor on {x.device}; got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


# K3dx's launch plan: the f32 row tile in shared memory takes at most this
# many bytes; the sort of one window of a bucket holds SORT_CAP 8-byte keys
DX_TILE_BYTES = 32 * 1024
DX_MAX_TILE_ROWS = 64
DX_SORT_CAP = 1024
DX_HIST_BINS = 256
SMEM_PER_BLOCK = 232_448  # an H100 block's most dynamic shared memory


def gather_bwd_dx_plan(b: int, hw: int, c: int, p: int) -> dict:
    """K3dx's launch plan for dx (b, hw, c) from p points per image:
    ``tile_rows`` (TQ, a power of two: the most rows, up to 64, whose f32
    sums fit in ``DX_TILE_BYTES``, or one), ``tiles`` (b * ceil(hw / TQ),
    one block each), ``cap`` (keys sorted at once), ``smem_bytes`` per
    block and ``scratch_ints`` (the corners' bucket ids, the tiles' counts
    and starts). Raises where the kernel cannot take the shape."""
    if b < 1 or hw < 1 or c < 1:
        raise ValueError(f"empty map ({b}, {hw}, {c})")
    if 4 * b * p > _INT32_MAX:
        raise ValueError(f"4 * B * P = {4 * b * p} corner ids pass 2**31")
    tq = DX_MAX_TILE_ROWS
    while tq > 1 and tq * c * 4 > DX_TILE_BYTES:
        tq //= 2
    tiles = b * -(-hw // tq)
    smem = tq * c * 4 + DX_SORT_CAP * 8 + (tq + 1 + DX_HIST_BINS) * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"C={c}: one row's f32 sums do not fit in shared "
                         f"memory ({smem} > {SMEM_PER_BLOCK} bytes)")
    return dict(tile_rows=tq, tiles=tiles, cap=DX_SORT_CAP, smem_bytes=smem,
                scratch_ints=4 * b * p + 2 * tiles + 1)


def _bwd_dx_cuda(g, x, ci, cw) -> torch.Tensor:
    _check(x, ci, cw)
    _check_g(g, x, ci)
    b, hw, ch = x.shape
    p = ci.shape[1]
    plan = gather_bwd_dx_plan(b, hw, ch, p)
    dx = torch.empty(b, hw, ch, dtype=x.dtype, device=x.device)
    scratch = torch.empty(plan["scratch_ints"], dtype=torch.int32,
                          device=x.device)
    fn = BILINEAR_GATHER_BWD_DX.fn()
    BILINEAR_GATHER_BWD_DX.launches += 1
    err = fn(g.data_ptr(), ci.data_ptr(), cw.data_ptr(), scratch.data_ptr(),
             dx.data_ptr(), b, hw, ch, p, plan["tile_rows"], plan["cap"],
             plan["smem_bytes"], _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    BILINEAR_GATHER_BWD_DX.check(err)
    return dx


def _bwd_dcw_cuda(g, x, ci, cw) -> torch.Tensor:
    _check(x, ci, cw)
    _check_int32(x, ci)
    _check_g(g, x, ci)
    b, hw, ch = x.shape
    p = ci.shape[1]
    if b * p * 4 > _INT32_MAX:
        raise ValueError("too many corners for the kernel's grid")
    dcw = torch.empty(b, p, 4, dtype=torch.float32, device=x.device)
    if dcw.numel() == 0:
        return dcw
    fn = BILINEAR_GATHER_BWD_DCW.fn()
    BILINEAR_GATHER_BWD_DCW.launches += 1
    err = fn(g.data_ptr(), x.data_ptr(), ci.data_ptr(), dcw.data_ptr(), b,
             hw, ch, p, _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    BILINEAR_GATHER_BWD_DCW.check(err)
    return dcw


def _forward(x, ci, cw) -> torch.Tensor:
    if device_kind(x) == "cuda":
        return _bilinear_gather_cuda(x, ci, cw)
    return bilinear_gather_plain(x, ci, cw)


def bilinear_gather_bwd_dx(g: torch.Tensor, x: torch.Tensor,
                           ci: torch.Tensor, cw: torch.Tensor
                           ) -> torch.Tensor:
    """The gradient of ``bilinear_gather`` with respect to ``x`` (only its
    shape, type and device are read), from the output's gradient ``g`` (B,
    P, C): a CUDA ``x`` launches the ``bilinear_gather_bwd_dx`` kernel (g
    contiguous, in x's type) and raises on what it does not take; a CPU
    ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _bwd_dx_cuda(g, x, ci, cw)
    return bilinear_gather_bwd_dx_plain(g, ci, cw, x.shape[1])


def bilinear_gather_bwd_dcw(g: torch.Tensor, x: torch.Tensor,
                            ci: torch.Tensor, cw: torch.Tensor
                            ) -> torch.Tensor:
    """The gradient of ``bilinear_gather`` with respect to ``cw`` (B, P, 4)
    f32 (only its shape and type are read): a CUDA ``x`` launches the
    ``bilinear_gather_bwd_dcw`` kernel and raises on what it does not take;
    a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _bwd_dcw_cuda(g, x, ci, cw)
    return bilinear_gather_bwd_dcw_plain(g, x, ci)


class _BilinearGather(torch.autograd.Function):
    """``bilinear_gather`` with its backward; saves (x, ci, cw) as the
    reference's ``_vjp_fwd`` does, and computes only the gradients that are
    asked for."""

    @staticmethod
    def forward(ctx, x, ci, cw):
        ctx.save_for_backward(x, ci, cw)
        return _forward(x, ci, cw)

    @staticmethod
    def backward(ctx, g):
        x, ci, cw = ctx.saved_tensors
        g = g.contiguous()
        dx = dcw = None
        if ctx.needs_input_grad[0]:
            dx = bilinear_gather_bwd_dx(g, x, ci, cw)
        if ctx.needs_input_grad[2]:
            dcw = bilinear_gather_bwd_dcw(g, x, ci, cw)
        return dx, None, dcw


def bilinear_gather(x: torch.Tensor, ci: torch.Tensor,
                    cw: torch.Tensor) -> torch.Tensor:
    """``out[b, p] = sum_{c<4} cw[b, p, c] * x[b, ci[b, p, c], :]``: x
    (B, HW, C), ci (B, P, 4) int32 (negative = skip), cw (B, P, 4) f32 ->
    (B, P, C) in x's type. Differentiable with respect to x and cw.

    A CUDA ``x`` launches the ``bilinear_gather_fwd`` kernel, and in the
    backward ``bilinear_gather_bwd_dx`` and / or ``bilinear_gather_bwd_dcw``
    (f32 or bf16, contiguous, C a multiple of 4 or 8), and raises on what
    they do not take; a CPU ``x`` runs the plain versions."""
    if torch.is_grad_enabled() and (x.requires_grad or cw.requires_grad):
        return _BilinearGather.apply(x, ci, cw)
    return _forward(x, ci, cw)


def bilinear_corners(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Float coordinates (B, P) on an (h, w) map -> (ci (B, P, 4) int32, cw
    (B, P, 4) f32): the four corners' flat row indices, -1 for a corner
    outside the map, and their bilinear weights (left as they are at
    corners outside the map: the gather skips on the index). The weights
    carry the gradient to ``ys`` and ``xs``, with ``floor`` held fixed."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = (ys - y0).float()
    dx = (xs - x0).float()
    cis, cws = [], []
    for cy, cx, wgt in ((y0, x0, (1 - dy) * (1 - dx)),
                        (y0, x0 + 1, (1 - dy) * dx),
                        (y0 + 1, x0, dy * (1 - dx)),
                        (y0 + 1, x0 + 1, dy * dx)):
        inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        # clamped before the int conversion, so far-out coordinates never
        # reach it
        idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).to(torch.int32)
        cis.append(torch.where(inb, idx, torch.full_like(idx, -1)))
        cws.append(wgt)
    return torch.stack(cis, dim=-1), torch.stack(cws, dim=-1)


def bilinear_sample_2d(x: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at float coordinates ys / xs (B, P) -> (B, P,
    C); corners outside the map contribute zero. Gradients flow to ``x``
    and, through the bilinear weights, to ``ys`` and ``xs``. ``x`` must be
    contiguous
    (the NHWC view of a ``channels_last`` NCHW map is): it is read in place
    as (B, H*W, C), never copied."""
    b, h, w, ch = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (the NHWC view "
                         "of a channels_last NCHW map is)")
    ci, cw = bilinear_corners(ys, xs, h, w)
    return bilinear_gather(x.view(b, h * w, ch), ci, cw)
