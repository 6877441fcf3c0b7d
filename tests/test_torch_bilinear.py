"""The port's bilinear row gather and 2D sampling vs the JAX package's, on
the CPU.

``bilinear_gather`` of the port runs its plain version here (f32
accumulation, one rounding). Against the reference's XLA form it agrees to
f32 rounding (1e-5: four products summed in another order); against the
Pallas body in interpret mode to 2e-2, because that body multiplies in bf16
(the tolerance of the reference's own ``tests/test_bilinear.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bilinear import _np_bilinear

from minddet_tpu.ops.bilinear import bilinear_gather as j_gather
from minddet_tpu.ops.bilinear import bilinear_sample_2d as j_sample
from minddet_tpu_torch.ops.bilinear import (bilinear_corners,
                                            bilinear_gather,
                                            bilinear_gather_plain,
                                            bilinear_sample_2d)


def _gather_case(seed, b=2, hw=256, c=128, p=384):
    """Random ``ci`` in [-1, HW), as the reference's interpret-mode test."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, hw, c).astype(np.float32)
    ci = rs.randint(-1, hw, (b, p, 4)).astype(np.int32)
    cw = rs.rand(b, p, 4).astype(np.float32)
    return x, ci, cw


@pytest.mark.parametrize("impl,tol", [("xla", 1e-5), ("pallas", 2e-2)])
def test_gather_matches_jax(impl, tol):
    x, ci, cw = _gather_case(2)
    assert (ci < 0).any()
    ref = np.asarray(j_gather(jnp.asarray(x), jnp.asarray(ci),
                              jnp.asarray(cw), impl, impl == "pallas"),
                     np.float32)
    got = bilinear_gather(torch.from_numpy(x), torch.from_numpy(ci),
                          torch.from_numpy(cw)).numpy()
    assert got.shape == ref.shape == (2, 384, 128)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_gather_skips_on_the_index_not_on_the_weight():
    x = torch.ones(1, 8, 4)
    ci = torch.tensor([[[-1, 0, 1, 2]]], dtype=torch.int32)
    cw = torch.tensor([[[100.0, 1.0, 1.0, 1.0]]])
    np.testing.assert_allclose(bilinear_gather(x, ci, cw).numpy(),
                               np.full((1, 1, 4), 3.0), atol=1e-6)
    # an index past the last row reads the last row, as the clipped gather
    x = torch.arange(8.0).reshape(1, 8, 1).repeat(1, 1, 4)
    ci = torch.tensor([[[9, -1, -1, -1]]], dtype=torch.int32)
    cw = torch.ones(1, 1, 4)
    ref = np.asarray(j_gather(jnp.asarray(x.numpy()), jnp.asarray(ci.numpy()),
                              jnp.asarray(cw.numpy()), "xla"))
    np.testing.assert_array_equal(bilinear_gather(x, ci, cw).numpy(), ref)
    assert ref[0, 0, 0] == 7.0


def test_gather_bf16_rounds_once():
    x, ci, cw = _gather_case(3, c=16, p=64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bilinear_gather(xb, torch.from_numpy(ci), torch.from_numpy(cw))
    assert got.dtype == torch.bfloat16
    exact = bilinear_gather_plain(xb.float(), torch.from_numpy(ci),
                                  torch.from_numpy(cw))
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_sample_2d_matches_jax_and_numpy():
    """Points inside, outside (all four corners dropped), straddling the
    border, and on integer coordinates."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 12, 8).astype(np.float32)
    ys = rs.uniform(-2, 10, (2, 64)).astype(np.float32)
    xs = rs.uniform(-2, 14, (2, 64)).astype(np.float32)
    ys[:, :8] = np.round(ys[:, :8])
    xs[:, 4:12] = np.round(xs[:, 4:12])
    ys[0, 12], xs[0, 12] = 7.0, 11.0      # the last texel, exactly
    ys[0, 13], xs[0, 13] = -1.0, 3.0      # one row above the map
    ys[0, 14], xs[0, 14] = 1e9, -1e9      # far out
    ref = np.asarray(j_sample(jnp.asarray(x), jnp.asarray(ys),
                              jnp.asarray(xs), "xla"))
    got = bilinear_sample_2d(torch.from_numpy(x), torch.from_numpy(ys),
                             torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _np_bilinear(x, ys, xs), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got[0, 12], x[0, 7, 11])
    assert (got[0, 13] == 0).all() and (got[0, 14] == 0).all()
    ci, cw = bilinear_corners(torch.from_numpy(ys), torch.from_numpy(xs), 8,
                              12)
    assert ci.dtype == torch.int32 and (ci[0, 14] == -1).all()
    # the weights stay as they are where the corner is outside the map
    assert (cw[ci < 0] != 0).any()


def test_sample_2d_reads_the_map_in_place():
    """The NHWC view of a channels_last map is taken as it is; any other
    layout raises instead of being copied."""
    rs = np.random.RandomState(1)
    nchw = torch.from_numpy(rs.randn(1, 8, 6, 5).astype(np.float32))
    cl = nchw.contiguous(memory_format=torch.channels_last)
    ys = torch.tensor([[2.5, 0.25]])
    xs = torch.tensor([[1.5, 3.75]])
    got = bilinear_sample_2d(cl.permute(0, 2, 3, 1), ys, xs)
    ref = _np_bilinear(nchw.permute(0, 2, 3, 1).numpy(), ys.numpy(),
                       xs.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        bilinear_sample_2d(nchw.permute(0, 2, 3, 1), ys, xs)


def test_requires_grad_raises_until_the_backward_is_ported():
    x, ci, cw = _gather_case(4, c=8, p=16)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        bilinear_gather(xt, torch.from_numpy(ci), torch.from_numpy(cw))
    with torch.no_grad():
        bilinear_gather(xt, torch.from_numpy(ci), torch.from_numpy(cw))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain(cuda, dtype, tol):
    x, ci, cw = _gather_case(5, c=384, p=2490)
    xt = torch.from_numpy(x).to(cuda, dtype)
    cit, cwt = torch.from_numpy(ci).to(cuda), torch.from_numpy(cw).to(cuda)
    got = bilinear_gather(xt, cit, cwt)
    torch.cuda.synchronize()
    ref = bilinear_gather_plain(xt.float(), cit, cwt)
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)
