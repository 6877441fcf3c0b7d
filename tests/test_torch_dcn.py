"""Port's deform_conv2d vs the JAX package's, f32 on the CPU.

Random offsets (some large enough to leave the image), mask, weights and
bias, made with numpy from a seed. Tolerance atol 1e-4 / rtol 1e-4: the
contraction sums K*Cin = 1152 f32 products, in another order than XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops.dcn import deform_conv2d as jax_dcn
from minddet_tpu_torch.ops import hat_sample as ths
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


@pytest.mark.parametrize("h,w,cin,cout,stride,spread", [
    (12, 12, 128, 16, 1, 1.5),   # tap-grouped sampler
    (10, 10, 128, 8, 1, 0.0),    # zero offsets: integer coordinates
    (9, 11, 128, 8, 2, 3.0),     # stride 2, some samples outside
    (10, 10, 64, 16, 1, 1.5),    # Cin % 128 != 0: flat sampler
])
def test_deform_conv2d_grads_match_jax(h, w, cin, cout, stride, spread,
                                       monkeypatch):
    """Gradients wrt x, offsets, mask, weights and bias equal ``jax.vjp``
    of the reference (XLA path) in f32: atol 2e-4 / rtol 1e-4, the
    backward's sums of up to K*Cin*Cout products in another order. The
    sampler's backward receives g contiguous (no copy on the way)."""
    x, offs, mask, wts, bs = _case(2, h, w, cin, cout, stride, spread, True,
                                   seed=11)
    ho, wo = offs.shape[1:3]
    g = np.random.RandomState(12).randn(2, ho, wo, cout).astype(np.float32)
    fn = lambda *a: jax_dcn(*a, stride=stride, implementation="xla")
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, offs, mask, wts, bs)))
    ref = vjp(jnp.asarray(g))

    seen = []
    bwd = ths.hat_sample_2d_taps_bwd

    def spy(grad, *args):
        seen.append(grad.is_contiguous())
        return bwd(grad, *args)

    monkeypatch.setattr(ths, "hat_sample_2d_taps_bwd", spy)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, offs, mask, wts, bs)]
    got = torch.autograd.grad(torch_dcn(*args, stride=stride), args,
                              torch.from_numpy(g))
    for name, a, r in zip(("x", "offsets", "mask", "weights", "bias"), got,
                          ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=2e-4, err_msg=name)
    assert seen == ([True] if cin % 128 == 0 else [])
    if spread == 0.0:  # zero offsets still get an offset gradient
        assert np.abs(got[1].numpy()).max() > 1e-2
