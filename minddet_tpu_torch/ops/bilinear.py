"""Batched weighted row gather and the bilinear sampling built on it
(counterpart of ``minddet_tpu/ops/bilinear.py``: ``bilinear_gather``,
``bilinear_sample_2d``).

    out[b, p, :] = sum_{c < 4} cw[b, p, c] * x[b, ci[b, p, c], :]

with x (B, HW, C), ci (B, P, 4) int32 row indices and cw (B, P, 4) f32
weights. A corner with ``ci < 0`` is skipped whatever its weight; an index
past the last row reads the last row (the reference's clipped gather). The
sum is taken in f32 and rounded once to x's type.

On a CUDA tensor ``bilinear_gather`` launches ``csrc/bilinear_gather.cu``,
the port of the TPU kernel ``bilinear.py:_fwd_kernel``; on a CPU tensor it
runs the plain version ``bilinear_gather_plain``, the reference's XLA form
(``_fwd_xla``). Forward only: the backward kernels (``_bwd_dx_kernel``,
``_bwd_dcw_kernel``) are not ported, so a tensor that requires grad raises.
"""

from __future__ import annotations

import torch

from minddet_tpu_torch.kernels import BILINEAR_GATHER_FWD, cuda_stream

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
    if max(x.numel(), ci.shape[0] * ci.shape[1] * x.shape[2]) > _INT32_MAX:
        raise ValueError("tensors too large for the kernel's 32-bit indices")


def _bilinear_gather_cuda(x, ci, cw) -> torch.Tensor:
    _check(x, ci, cw)
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


def bilinear_gather(x: torch.Tensor, ci: torch.Tensor,
                    cw: torch.Tensor) -> torch.Tensor:
    """``out[b, p] = sum_{c<4} cw[b, p, c] * x[b, ci[b, p, c], :]``: x
    (B, HW, C), ci (B, P, 4) int32 (negative = skip), cw (B, P, 4) f32 ->
    (B, P, C) in x's type.

    A CUDA ``x`` launches the ``bilinear_gather_fwd`` kernel (f32 or bf16,
    contiguous, C a multiple of 4 or 8) and raises on what it does not
    take; a CPU ``x`` runs the plain version. No gradient yet."""
    if torch.is_grad_enabled() and (x.requires_grad or cw.requires_grad):
        raise NotImplementedError(
            "bilinear_gather has no backward yet: its kernels "
            "(minddet_tpu/ops/bilinear.py:_bwd_dx_kernel, _bwd_dcw_kernel) "
            "are not ported")
    if x.device.type == "cuda":
        return _bilinear_gather_cuda(x, ci, cw)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return bilinear_gather_plain(x, ci, cw)


def bilinear_corners(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Float coordinates (B, P) on an (h, w) map -> (ci (B, P, 4) int32, cw
    (B, P, 4) f32): the four corners' flat row indices, -1 for a corner
    outside the map, and their bilinear weights (left as they are at
    corners outside the map: the gather skips on the index)."""
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
    C); corners outside the map contribute zero. ``x`` must be contiguous
    (the NHWC view of a ``channels_last`` NCHW map is): it is read in place
    as (B, H*W, C), never copied."""
    b, h, w, ch = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (the NHWC view "
                         "of a channels_last NCHW map is)")
    ci, cw = bilinear_corners(ys, xs, h, w)
    return bilinear_gather(x.view(b, h * w, ch), ci, cw)
