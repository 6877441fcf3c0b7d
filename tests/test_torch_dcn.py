"""Port's deform_conv2d vs the JAX package's, f32 on the CPU.

Random offsets (some large enough to leave the image), mask, weights and
bias, made with numpy from a seed. Tolerance atol 1e-4 / rtol 1e-4: the
contraction sums K*Cin = 1152 f32 products, in another order than XLA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops.dcn import deform_conv2d as jax_dcn
from minddet_tpu_torch.ops.dcn import deform_conv2d as torch_dcn


def _case(b, h, w, cin, cout, stride, spread, bias, seed=0):
    rs = np.random.RandomState(seed)
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    x = rs.randn(b, h, w, cin).astype(np.float32)
    offs = (rs.randn(b, ho, wo, 9, 2) * spread).astype(np.float32)
    mask = rs.rand(b, ho, wo, 9).astype(np.float32)
    wts = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bs = rs.randn(cout).astype(np.float32) if bias else None
    return x, offs, mask, wts, bs


@pytest.mark.parametrize("h,w,cin,cout,stride,spread,bias", [
    (16, 16, 128, 32, 1, 1.5, True),     # tap-grouped sampler
    (16, 12, 128, 16, 2, 1.5, False),    # stride 2, non-square
    (8, 8, 128, 8, 1, 20.0, True),       # samples far outside the image
    (10, 10, 64, 16, 1, 1.5, True),      # Cin % 128 != 0: flat sampler
])
def test_deform_conv2d_matches_jax(h, w, cin, cout, stride, spread, bias):
    x, offs, mask, wts, bs = _case(2, h, w, cin, cout, stride, spread, bias)
    ref = jax_dcn(jnp.asarray(x), jnp.asarray(offs), jnp.asarray(mask),
                  jnp.asarray(wts), None if bs is None else jnp.asarray(bs),
                  stride=stride, implementation="xla")
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = torch_dcn(t(x), t(offs), t(mask), t(wts), t(bs), stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_deform_conv2d_no_mask_zero_offsets_is_plain_conv():
    """mask None and zero offsets reduce to an ordinary 3x3 conv."""
    x, _, _, wts, bs = _case(1, 8, 8, 128, 8, 1, 0.0, True, seed=4)
    offs = np.zeros((1, 8, 8, 9, 2), np.float32)
    got = torch_dcn(torch.from_numpy(x), torch.from_numpy(offs), None,
                    torch.from_numpy(wts), torch.from_numpy(bs))
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(wts).permute(3, 2, 0, 1), torch.from_numpy(bs),
        padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, conv, rtol=1e-4, atol=1e-4)
