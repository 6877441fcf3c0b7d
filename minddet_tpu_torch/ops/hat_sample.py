"""Modulated bilinear sampling, the DCNv2 gather, and its backward.

Counterpart of ``minddet_tpu/ops/hat_sample.py``:

    out[b, p, :] = scale[b, p] * bilinear(x[b], ys[b, p], xs[b, p])

with every corner outside the image contributing zero.

``hat_sample_2d_taps`` is the tap-grouped form the DCN layers use: x (B, H,
W, C) sampled at tap-major coordinates (B, K, P) into (B, P, K*C), tap k in
channels [k*C, (k+1)*C). It is differentiable wrt x, ys, xs and scale
through a ``torch.autograd.Function``. On a CUDA tensor the forward launches
``csrc/hat_sample_taps.cu`` and the backward ``csrc/hat_sample_taps_bwd.cu``;
on a CPU tensor they run the plain versions ``hat_sample_2d_taps_plain`` and
``hat_sample_2d_taps_bwd_plain``.

The gradient is that of the reference's XLA path, the corner gather
(``bilinear.py:bilinear_sample_2d`` + ``_fwd_xla``, i.e. ``_xla_taps``):
the bilinear weights are differentiated with ``floor`` held fixed, so at an
integer coordinate dys and dxs are forward differences x[y0+1] - x[y0].
The reference's Pallas backward (``_bwd_taps_kernel``) takes the hat
function's subgradient on the open support instead and returns zero there,
which leaves zero-initialised offset convs at zero for good; the port does
not copy that.

``hat_sample_2d`` is the flat form, the sampler of DCN layers whose Cin is
not a multiple of 128: x (B, H, W, C) sampled at (B, N) coordinates into
(B, N, C), any C >= 1. It has the same gradient and the same dispatch: a
CUDA tensor launches ``csrc/hat_sample_flat.cu`` and, in the backward,
``csrc/hat_sample_flat_bwd.cu``; a CPU tensor runs ``hat_sample_2d_plain``
and ``hat_sample_2d_bwd_plain``. Neither form falls back: on a CUDA tensor
a wrapper launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from minddet_tpu_torch.kernels import (HAT_SAMPLE_FLAT_BWD,
                                       HAT_SAMPLE_FLAT_FWD,
                                       HAT_SAMPLE_TAPS_BWD,
                                       HAT_SAMPLE_TAPS_FWD, cuda_stream,
                                       device_kind)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte vector
_INT32_MAX = 2 ** 31 - 1
_THREADS = 256  # per block, as the kernels launch them


def _corners(ys: torch.Tensor, xs: torch.Tensor):
    """The four (cy, cx, weight) corners of f32 coordinates, from floor."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0
    return ((y0, x0, (1 - dy) * (1 - dx)), (y0, x0 + 1, (1 - dy) * dx),
            (y0 + 1, x0, dy * (1 - dx)), (y0 + 1, x0 + 1, dy * dx))


def _corner_index(cy, cx, h, w):
    """(in-bounds mask, flat H*W index clamped into the image)."""
    inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
    return inb, (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions sum in f32, or in x's type where that is wider."""
    return torch.promote_types(x.dtype, torch.float32)


def hat_sample_2d_plain(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the flat sampler, on any device: (B, H, W,
    C) at coordinates (B, N) -> (B, N, C) in x.dtype.

    Four corners from ``floor``; each in-bounds corner is kept on its own;
    weights in f32 and the sum in f32 (f64 for an f64 x), the scale applied
    last, one rounding to x.dtype at the end. No in-place op, so autograd
    differentiates it.
    """
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c).to(_acc_dtype(x))
    out = 0
    for cy, cx, wgt in _corners(ys.float(), xs.float()):
        inb, idx = _corner_index(cy, cx, h, w)
        rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        out = out + rows * (wgt * inb)[..., None]
    if scale is not None:
        out = out * scale.float()[..., None]
    return out.to(x.dtype)


def hat_sample_2d_taps_plain(x: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor,
                             scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the tap-grouped sampler, on any device."""
    b, k, p = ys.shape
    c = x.shape[-1]
    tap_major = lambda a: None if a is None else a.reshape(b, k * p)
    out = hat_sample_2d_plain(x, tap_major(ys), tap_major(xs),
                              tap_major(scale))
    return out.reshape(b, k, p, c).transpose(1, 2).reshape(b, p, k * c)


def hat_sample_2d_taps_bwd_plain(
        g: torch.Tensor, x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
        scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the sampler's backward, on any device.

    g (B, P, K*C) -> (dx (B, H, W, C) in x.dtype, dys, dxs, dscale, each
    (B, K, P) f32; dscale None when scale is None). With fy = ys - floor(ys),
    fx likewise, v_ij the corner rows (zero out of bounds) and w_ij their
    bilinear weights, summing over channels:

        dscale = sum g * sum_ij w_ij v_ij
        dys    = scale * sum g * ((1-fx)(v10 - v00) + fx (v11 - v01))
        dxs    = scale * sum g * ((1-fy)(v01 - v00) + fy (v11 - v10))
        dx[corner ij] += scale * w_ij * g   (in-bounds corners only)

    All in f32 (f64 for an f64 x; ``index_add_`` into an image of that
    type), dx rounded once. It equals autograd of
    ``hat_sample_2d_taps_plain``.
    """
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    acc = _acc_dtype(x)
    gf = g.to(acc).reshape(b, p, k, c).transpose(1, 2).reshape(b, k * p, c)
    flat = x.reshape(b, h * w, c).to(acc)
    ysf = ys.float().reshape(b, k * p)
    xsf = xs.float().reshape(b, k * p)
    sc = (torch.ones_like(ysf) if scale is None
          else scale.float().reshape(b, k * p))
    image0 = (torch.arange(b, device=x.device) * (h * w))[:, None]
    dx = torch.zeros(b * h * w, c, dtype=acc, device=x.device)
    dots = []
    weights = []
    for cy, cx, wgt in _corners(ysf, xsf):
        inb, idx = _corner_index(cy, cx, h, w)
        rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        dots.append((rows * gf).sum(-1) * inb)
        weights.append(wgt)
        coef = sc.to(acc) * wgt.to(acc) * inb
        dx.index_add_(0, (idx + image0).reshape(-1),
                      (gf * coef[..., None]).reshape(-1, c))
    d00, d01, d10, d11 = dots
    fy = ysf - torch.floor(ysf)
    fx = xsf - torch.floor(xsf)
    dys = sc * ((1 - fx) * (d10 - d00) + fx * (d11 - d01))
    dxs = sc * ((1 - fy) * (d01 - d00) + fy * (d11 - d10))
    dsc = sum(wgt * d for wgt, d in zip(weights, dots))
    shape = (b, k, p)
    return (dx.reshape(b, h, w, c).to(x.dtype), dys.float().reshape(shape),
            dxs.float().reshape(shape),
            None if scale is None else dsc.float().reshape(shape))


def hat_sample_2d_bwd_plain(
        g: torch.Tensor, x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
        scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the flat sampler's backward, on any device:
    g (B, N, C) -> (dx (B, H, W, C) in x.dtype, dys, dxs, dscale, each
    (B, N) f32; dscale None when scale is None). It is
    ``hat_sample_2d_taps_bwd_plain`` with one tap, and equals autograd of
    ``hat_sample_2d_plain``."""
    one_tap = lambda a: None if a is None else a[:, None]
    dx, dys, dxs, dsc = hat_sample_2d_taps_bwd_plain(
        g, x, one_tap(ys), one_tap(xs), one_tap(scale))
    return dx, dys[:, 0], dxs[:, 0], None if dsc is None else dsc[:, 0]


def _check(x, ys, xs, scale, coord_dims: int) -> None:
    """What both samplers' kernels take: x (B, H, W, C) contiguous f32 or
    bf16; ys, xs, scale contiguous f32 of one shape, ``coord_dims``
    dimensions, batch first, on x's device."""
    if x.dim() != 4 or ys.dim() != coord_dims:
        raise ValueError(f"expected x (B,H,W,C) and {coord_dims}-d ys; got "
                         f"{tuple(x.shape)} and {tuple(ys.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if ys.shape[0] != x.shape[0]:
        raise ValueError(f"batch mismatch: x {x.shape[0]}, coordinates "
                         f"{ys.shape[0]}")
    for name, t in (("ys", ys), ("xs", xs), ("scale", scale)):
        if t.shape != ys.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != ys shape "
                             f"{tuple(ys.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (the NHWC view "
                         "of a channels_last NCHW activation is)")


def _check_taps(x, ys, xs, scale) -> None:
    _check(x, ys, xs, scale, 3)
    b, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8 (16-byte rows)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if b * max(ys.shape[1] * ys.shape[2], h * w) * c > _INT32_MAX:
        raise ValueError("tensors too large for the kernels' 32-bit indices")


def _taps_cuda(x, ys, xs, scale) -> torch.Tensor:
    if scale is None:
        scale = torch.ones_like(ys)
    _check_taps(x, ys, xs, scale)
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    out = torch.empty(b, p, k * c, dtype=x.dtype, device=x.device)
    fn = HAT_SAMPLE_TAPS_FWD.fn()
    HAT_SAMPLE_TAPS_FWD.launches += 1
    err = fn(x.data_ptr(), ys.data_ptr(), xs.data_ptr(), scale.data_ptr(),
             out.data_ptr(), b, h, w, c, k, p, _DTYPE_CODE[x.dtype],
             cuda_stream(x.device))
    HAT_SAMPLE_TAPS_FWD.check(err)
    return out


# K1b's launch plan (see taps_bwd_plan): a block's shared memory, at most
# this many bytes, so that two 512-thread blocks fit on an SM (227 KB, less
# 1 KB reserved per block)
TAPS_BWD_SMEM_BYTES = 110 * 1024
TAPS_BWD_WINDOW_SHARE = 3  # the window takes at most 1/3 of it
TAPS_BWD_MAX_TILE = 2048  # positions per block
TAPS_BWD_SLOT_BYTES = 12  # per corner: bucket id, scale * weight, dot


def taps_bwd_plan(b: int, h: int, w: int, c: int, k: int, p: int) -> dict:
    """K1b's launch plan for x (b, h, w, c) and (b, k, p) coordinates, C %
    8 == 0 (a block takes all C channels): ``rows`` R of the dx window
    (whole map rows, as many as fit in 1 / ``TAPS_BWD_WINDOW_SHARE`` of
    ``TAPS_BWD_SMEM_BYTES`` at two int32 per texel, at most ``h``; 0 where
    not one row fits, and then every corner takes the global fallback);
    ``tile`` positions per block, as many as the rest holds at
    ``TAPS_BWD_SLOT_BYTES`` per corner (4 corners per sample, ``k``
    samples per position), evened out over the image's tiles; ``tiles``;
    and ``smem_bytes`` = (2 * R * w + 1) * 4 + tile * k * 48. Raises where
    not one position's corners fit (K > ~2300)."""
    if c % 8 or c < 8:
        raise ValueError(f"C={c} must be a positive multiple of 8")
    rows = min(h, (TAPS_BWD_SMEM_BYTES // TAPS_BWD_WINDOW_SHARE - 4)
               // (8 * w))
    window = (2 * rows * w + 1) * 4
    per_position = 4 * k * TAPS_BWD_SLOT_BYTES
    fit = (TAPS_BWD_SMEM_BYTES - window) // per_position
    if fit < 1:
        raise ValueError(f"K={k}: one position's corners do not fit in "
                         f"{TAPS_BWD_SMEM_BYTES} bytes of shared memory")
    tile = min(max(p, 1), TAPS_BWD_MAX_TILE, fit)
    tile = -(-p // -(-p // tile)) if p else 1  # tiles of (nearly) equal size
    return dict(rows=rows, tile=tile, tiles=b * -(-p // tile),
                smem_bytes=window + tile * per_position)


def _taps_bwd_cuda(g, x, ys, xs, scale, stats=None):
    """``stats``, where given, is a zeroed (2,) int64 CUDA tensor that
    receives the corners added through the global fallback (outside the
    block's window) and all corners added."""
    sc = torch.ones_like(ys) if scale is None else scale
    _check_taps(x, ys, xs, sc)
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    if (g.shape != (b, p, k * c) or g.dtype != x.dtype
            or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {x.dtype} (B, P, K*C) = "
                         f"{(b, p, k * c)} tensor on {x.device}; got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    plan = taps_bwd_plan(b, h, w, c, k, p)
    dcoords = torch.empty(3, b, k, p, dtype=torch.float32, device=x.device)
    # the f32 scatter-add image; for an f32 x it is dx itself
    acc = torch.zeros(b, h, w, c, dtype=torch.float32, device=x.device)
    dx = acc if x.dtype == torch.float32 else torch.empty(
        b, h, w, c, dtype=x.dtype, device=x.device)
    fn = HAT_SAMPLE_TAPS_BWD.fn()
    HAT_SAMPLE_TAPS_BWD.launches += 1
    err = fn(g.data_ptr(), x.data_ptr(), ys.data_ptr(), xs.data_ptr(),
             sc.data_ptr(), acc.data_ptr(), dx.data_ptr(),
             dcoords[0].data_ptr(), dcoords[1].data_ptr(),
             dcoords[2].data_ptr(), 0 if stats is None else stats.data_ptr(),
             b, h, w, c, k, p, plan["tile"], plan["rows"],
             plan["smem_bytes"], _DTYPE_CODE[x.dtype], cuda_stream(x.device))
    HAT_SAMPLE_TAPS_BWD.check(err)
    return dx, dcoords[0], dcoords[1], None if scale is None else dcoords[2]


def hat_sample_2d_taps_bwd(
        g: torch.Tensor, x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
        scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The sampler's backward (see ``hat_sample_2d_taps_bwd_plain``): a
    CUDA ``x`` launches the ``hat_sample_taps_bwd`` kernel (g contiguous in
    x's dtype, the forward's inputs as it takes them) and raises on anything
    it does not take; a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _taps_bwd_cuda(g, x, ys, xs, scale)
    return hat_sample_2d_taps_bwd_plain(g, x, ys, xs, scale)


class _TapsSample(torch.autograd.Function):
    """``hat_sample_2d_taps`` with its backward; saves (x, ys, xs, scale)
    as the reference's ``_hat_taps_fwd`` does."""

    @staticmethod
    def forward(ctx, x, ys, xs, scale):
        ctx.save_for_backward(x, ys, xs, scale)
        if device_kind(x) == "cuda":
            return _taps_cuda(x, ys, xs, scale)
        return hat_sample_2d_taps_plain(x, ys, xs, scale)

    @staticmethod
    def backward(ctx, g):
        x, ys, xs, scale = ctx.saved_tensors
        return hat_sample_2d_taps_bwd(g, x, ys, xs, scale)


def hat_sample_2d_taps(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tap-grouped modulated sampling: (B, H, W, C) at (B, K, P) coords ->
    (B, P, K*C) in x.dtype, tap k in channels [k*C, (k+1)*C).

    Differentiable wrt x, ys, xs and scale (``scale=None`` is ones, with no
    gradient). A CUDA ``x`` launches the ``hat_sample_taps_fwd`` kernel, and
    ``hat_sample_taps_bwd`` in the backward (ys, xs, scale contiguous f32
    on the same device; bf16 or f32 x with C % 8 == 0) and raises on
    anything they do not take; a CPU ``x`` runs the plain versions.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, ys, xs, scale)):
        return _TapsSample.apply(x, ys, xs, scale)
    if device_kind(x) == "cuda":
        return _taps_cuda(x, ys, xs, scale)
    return hat_sample_2d_taps_plain(x, ys, xs, scale)


def _check_flat(x, ys, xs, scale) -> None:
    _check(x, ys, xs, scale, 2)
    # the backward's lane groups take up to 2 C threads per sample, 256 a
    # block, fewer than 2**31 blocks; offsets are 64-bit
    if 2 * ys.numel() * x.shape[3] > _INT32_MAX * _THREADS:
        raise ValueError("too many samples for one launch of the kernels")


def _vec(c: int, *tensors) -> int:
    """1 where the kernels may move 16-byte vectors: C a whole number of
    them and every row pointer 16-byte aligned."""
    dtype = tensors[0].dtype
    return int(c % _VEC[dtype] == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _flat_cuda(x, ys, xs, scale) -> torch.Tensor:
    if scale is None:
        scale = torch.ones_like(ys)
    _check_flat(x, ys, xs, scale)
    b, h, w, c = x.shape
    n = ys.shape[1]
    out = torch.empty(b, n, c, dtype=x.dtype, device=x.device)
    fn = HAT_SAMPLE_FLAT_FWD.fn()
    HAT_SAMPLE_FLAT_FWD.launches += 1
    err = fn(x.data_ptr(), ys.data_ptr(), xs.data_ptr(), scale.data_ptr(),
             out.data_ptr(), b, h, w, c, n, _DTYPE_CODE[x.dtype],
             _vec(c, x, out), cuda_stream(x.device))
    HAT_SAMPLE_FLAT_FWD.check(err)
    return out


def _flat_bwd_cuda(g, x, ys, xs, scale):
    sc = torch.ones_like(ys) if scale is None else scale
    _check_flat(x, ys, xs, sc)
    b, h, w, c = x.shape
    n = ys.shape[1]
    if (g.shape != (b, n, c) or g.dtype != x.dtype
            or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {x.dtype} (B, N, C) = "
                         f"{(b, n, c)} tensor on {x.device}; got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    dcoords = torch.empty(3, b, n, dtype=torch.float32, device=x.device)
    # the f32 scatter-add image; for an f32 x it is dx itself
    acc = torch.zeros(b, h, w, c, dtype=torch.float32, device=x.device)
    dx = acc if x.dtype == torch.float32 else torch.empty(
        b, h, w, c, dtype=x.dtype, device=x.device)
    fn = HAT_SAMPLE_FLAT_BWD.fn()
    HAT_SAMPLE_FLAT_BWD.launches += 1
    err = fn(g.data_ptr(), x.data_ptr(), ys.data_ptr(), xs.data_ptr(),
             sc.data_ptr(), acc.data_ptr(), dx.data_ptr(),
             dcoords[0].data_ptr(), dcoords[1].data_ptr(),
             dcoords[2].data_ptr(), b, h, w, c, n, _DTYPE_CODE[x.dtype],
             _vec(c, g, x), cuda_stream(x.device))
    HAT_SAMPLE_FLAT_BWD.check(err)
    return dx, dcoords[0], dcoords[1], None if scale is None else dcoords[2]


def hat_sample_2d_bwd(
        g: torch.Tensor, x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
        scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The flat sampler's backward (see ``hat_sample_2d_bwd_plain``): a CUDA
    ``x`` launches the ``hat_sample_flat_bwd`` kernel (g contiguous in x's
    dtype, the forward's inputs as it takes them) and raises on anything it
    does not take; a CPU ``x`` runs the plain version."""
    if device_kind(x) == "cuda":
        return _flat_bwd_cuda(g, x, ys, xs, scale)
    return hat_sample_2d_bwd_plain(g, x, ys, xs, scale)


class _FlatSample(torch.autograd.Function):
    """``hat_sample_2d`` with its backward; saves (x, ys, xs, scale) as the
    reference's ``_hat_fwd`` does. One kernel pass gives all four
    gradients; those autograd does not ask for are dropped."""

    @staticmethod
    def forward(ctx, x, ys, xs, scale):
        ctx.save_for_backward(x, ys, xs, scale)
        if device_kind(x) == "cuda":
            return _flat_cuda(x, ys, xs, scale)
        return hat_sample_2d_plain(x, ys, xs, scale)

    @staticmethod
    def backward(ctx, g):
        x, ys, xs, scale = ctx.saved_tensors
        grads = hat_sample_2d_bwd(g.contiguous(), x, ys, xs, scale)
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad))


def hat_sample_2d(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat modulated sampling: (B, H, W, C) at (B, N) coords -> (B, N, C)
    in x.dtype, any C >= 1.

    Differentiable wrt x, ys, xs and scale (``scale=None`` is ones, with no
    gradient). A CUDA ``x`` launches the ``hat_sample_flat_fwd`` kernel, and
    ``hat_sample_flat_bwd`` in the backward (ys, xs, scale contiguous f32
    on the same device; bf16 or f32 x, contiguous) and raises on anything
    they do not take; a CPU ``x`` runs the plain versions.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, ys, xs, scale)):
        return _FlatSample.apply(x, ys, xs, scale)
    if device_kind(x) == "cuda":
        return _flat_cuda(x, ys, xs, scale)
    return hat_sample_2d_plain(x, ys, xs, scale)
