"""Modulated deformable convolution (DCNv2), counterpart of
``minddet_tpu/ops/dcn.py``.

1. Sampling: all K taps' bilinear samples times the modulation mask in one
   call of the tap-grouped sampler (``ops/hat_sample.py``, a CUDA kernel on
   the GPU) when Cin % 128 == 0, else the flat sampler over position-major
   samples (B, P*K), a CUDA kernel too, whose (B, P*K, Cin) output is the
   (B, P, K*Cin) layout the contraction takes.
2. Contraction: samples (B, P, K*Cin) x weights (K*Cin, Cout) as one
   matmul, as the reference leaves it to XLA; with a bias, one
   ``torch.addmm`` that adds it to the f32 accumulator and rounds once, as
   the reference's f32 ``jnp.dot`` + bias does.

Gradients flow to x, offsets, mask, weights and bias: through the
sampler's autograd Function (its backward a CUDA kernel on the GPU) and
autograd of the rest. The backward adds no copy: the contraction's input
gradient reaches the sampler's backward as the contiguous (B, P, K*Cin)
tensor it takes.

Layouts (all NHWC, as in the reference): x (B, H, W, Cin); offsets (B, Ho,
Wo, K, 2) as (dy, dx); mask (B, Ho, Wo, K) already sigmoid-ed; weights (kh,
kw, Cin, Cout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from minddet_tpu_torch.ops.hat_sample import hat_sample_2d, hat_sample_2d_taps


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: Optional[torch.Tensor],
    weights: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """Modulated deformable conv. Returns (B, Ho, Wo, Cout) in x.dtype."""
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weights.shape
    if wcin != cin:
        raise ValueError(f"weight Cin {wcin} != input Cin {cin}")
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    k = kh * kw
    p = ho * wo

    # sample coordinates in f32, position-major (1, P, K): output grid
    # * stride - pad + tap offset; the learned offsets add on top
    f32 = dict(dtype=torch.float32, device=x.device)
    oy = (torch.arange(ho, **f32) * stride - padding)[:, None]
    ox = (torch.arange(wo, **f32) * stride - padding)[None, :]
    taps = torch.arange(k, **f32)
    base_y = oy.expand(ho, wo).reshape(1, p, 1) + torch.div(
        taps, kw, rounding_mode="floor").reshape(1, 1, k)
    base_x = ox.expand(ho, wo).reshape(1, p, 1) + (taps % kw).reshape(1, 1, k)

    offs = offsets.reshape(b, p, k, 2).float()
    wmat = weights.reshape(k * cin, cout)

    if cin % 128 == 0:
        # tap-grouped sampler: coords (B, K, P), samples come out in the
        # (B, P, K*Cin) layout the contraction consumes
        ys = (base_y + offs[..., 0]).transpose(1, 2).contiguous()
        xs = (base_x + offs[..., 1]).transpose(1, 2).contiguous()
        scale = None if mask is None else \
            mask.reshape(b, p, k).float().transpose(1, 2).contiguous()
        samp = hat_sample_2d_taps(x, ys, xs, scale)
    else:
        # flat sampler: position-major coords (B, P*K), samples (B, P*K,
        # Cin), which is (B, P, K*Cin) as it lies
        ys = (base_y + offs[..., 0]).reshape(b, p * k).contiguous()
        xs = (base_x + offs[..., 1]).reshape(b, p * k).contiguous()
        scale = None if mask is None else \
            mask.reshape(b, p * k).float().contiguous()
        samp = hat_sample_2d(x, ys, xs, scale).reshape(b, p, k * cin)

    samp = samp.to(weights.dtype)
    if bias is None:
        out = torch.matmul(samp, wmat)
    else:
        out = torch.addmm(bias.to(weights.dtype), samp.reshape(b * p, k * cin),
                          wmat)
    return out.reshape(b, ho, wo, cout).to(x.dtype)


def dcn_sampling_grid_shapes(h: int, w: int, kernel: int = 3,
                             stride: int = 1, padding: int = 1
                             ) -> Tuple[int, int, int]:
    """(Ho, Wo, K) of a square DCN kernel over an (h, w) map: the offset and
    mask head's output size and its tap count."""
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    return ho, wo, kernel * kernel
