"""Modulated bilinear sampling, the DCNv2 gather (forward only).

Counterpart of ``minddet_tpu/ops/hat_sample.py``:

    out[b, p, :] = scale[b, p] * bilinear(x[b], ys[b, p], xs[b, p])

with every corner outside the image contributing zero.

``hat_sample_2d_taps`` is the tap-grouped form the DCN layers use: x (B, H,
W, C) sampled at tap-major coordinates (B, K, P) into (B, P, K*C), tap k in
channels [k*C, (k+1)*C). On a CUDA tensor it launches the hand-written
kernel ``csrc/hat_sample_taps.cu``; on a CPU tensor it runs the plain version
``hat_sample_2d_taps_plain``, the corner gather of the reference's XLA path
(``bilinear.py:bilinear_sample_2d`` + ``_fwd_xla``, i.e. ``_xla_taps``).

``hat_sample_2d`` (flat (B, P) coordinates) has only its plain version: its
kernel (``_fwd_kernel``) is not ported, so on a CUDA tensor it raises.

Neither function has a backward yet; the backward kernel comes with the
training step, and both raise when an input requires grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from minddet_tpu_torch.kernels import HAT_SAMPLE_TAPS_FWD, cuda_stream

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1


def _no_grad_inputs(name, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward yet (the backward kernel comes with the "
            "training step); call it under torch.no_grad()/inference_mode()")


def _sample_plain(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  scale: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, W, C) at coordinates (B, N) -> (B, N, C) in x.dtype.

    Four corners from ``floor``; each in-bounds corner is kept on its own;
    weights and the sum in f32, the scale applied last, one rounding to
    x.dtype at the end.
    """
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c).float()
    ys = ys.float()
    xs = xs.float()
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0
    out = torch.zeros(b, ys.shape[1], c, dtype=torch.float32, device=x.device)
    for cy, cx, wgt in (
        (y0, x0, (1 - dy) * (1 - dx)),
        (y0, x0 + 1, (1 - dy) * dx),
        (y0 + 1, x0, dy * (1 - dx)),
        (y0 + 1, x0 + 1, dy * dx),
    ):
        inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
        rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        out += rows * (wgt * inb)[..., None]
    if scale is not None:
        out *= scale.float()[..., None]
    return out.to(x.dtype)


def hat_sample_2d_taps_plain(x: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor,
                             scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the tap-grouped sampler, on any device."""
    b, k, p = ys.shape
    c = x.shape[-1]
    tap_major = lambda a: None if a is None else a.reshape(b, k * p)
    out = _sample_plain(x, tap_major(ys), tap_major(xs), tap_major(scale))
    return out.reshape(b, k, p, c).transpose(1, 2).reshape(b, p, k * c)


def _check_taps(x, ys, xs, scale) -> None:
    if x.dim() != 4 or ys.dim() != 3:
        raise ValueError(f"expected x (B,H,W,C) and ys (B,K,P); got "
                         f"{tuple(x.shape)} and {tuple(ys.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, _, _, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8 (16-byte rows)")
    if ys.shape[0] != b:
        raise ValueError(f"batch mismatch: x {b}, coordinates {ys.shape[0]}")
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
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if b * ys.shape[1] * ys.shape[2] * c > _INT32_MAX:
        raise ValueError("output too large for the kernel's 32-bit indices")


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


def hat_sample_2d_taps(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tap-grouped modulated sampling: (B, H, W, C) at (B, K, P) coords ->
    (B, P, K*C) in x.dtype, tap k in channels [k*C, (k+1)*C).

    A CUDA ``x`` launches the ``hat_sample_taps_fwd`` kernel (ys, xs, scale
    contiguous f32 on the same device; bf16 or f32 x with C % 8 == 0) and
    raises on anything it does not take; a CPU ``x`` runs the plain version.
    """
    _no_grad_inputs("hat_sample_2d_taps", x, ys, xs, scale)
    if x.device.type == "cuda":
        return _taps_cuda(x, ys, xs, scale)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return hat_sample_2d_taps_plain(x, ys, xs, scale)


def hat_sample_2d(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat modulated sampling: (B, H, W, C) at (B, P) coords -> (B, P, C).

    Plain version only: on a CUDA tensor it raises, because the flat kernel
    (``minddet_tpu/ops/hat_sample.py:_fwd_kernel``) is not ported yet.
    """
    _no_grad_inputs("hat_sample_2d", x, ys, xs, scale)
    if x.device.type != "cpu":
        raise NotImplementedError(
            "hat_sample_2d on the GPU needs the flat sampler kernel "
            "(minddet_tpu/ops/hat_sample.py:_fwd_kernel), which is not "
            "ported yet; only C % 128 == 0 layers (hat_sample_2d_taps) run "
            "on the GPU")
    return _sample_plain(x, ys, xs, scale)
