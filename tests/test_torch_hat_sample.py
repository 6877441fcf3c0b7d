"""Port's modulated bilinear sampler vs the JAX package's.

The port's plain version (``minddet_tpu_torch.ops.hat_sample``) must equal
the JAX XLA path (the corner gather) in f32 to 1e-5: same corners, same f32
weights, scale applied last. Against the Pallas kernel (run in interpret
mode) the tolerance is 2e-2, because that kernel rounds its hat weights and
x to bf16 before its MXU dot. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops import hat_sample as jhs
from minddet_tpu_torch.ops import hat_sample as ths


def _taps_case(b, h, w, c, p, k, spread, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    # DCN-like: each position's raster point plus noise, per tap
    base_y = np.repeat(np.linspace(0, h - 1, p)[None, None], k, 1)
    base_x = np.tile(np.linspace(0, w - 1, p)[None, None], (1, k, 1))
    ys = (base_y + rs.randn(b, k, p) * spread).astype(np.float32)
    xs = (base_x + rs.randn(b, k, p) * spread).astype(np.float32)
    sc = rs.rand(b, k, p).astype(np.float32)
    return x, ys, xs, sc


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


_CASES = [
    (16, 16, 128, 300, 9, 1.5),   # P not a multiple of 128
    (16, 16, 128, 200, 9, 80.0),  # most samples leave the image
    (64, 64, 128, 700, 9, 1.5),
    (64, 64, 128, 700, 9, 80.0),
]


@pytest.mark.parametrize("h,w,c,p,k,spread", _CASES)
def test_taps_plain_matches_jax_xla(h, w, c, p, k, spread):
    """f32, atol 1e-5: the same arithmetic as the XLA corner gather."""
    x, ys, xs, sc = _taps_case(2, h, w, c, p, k, spread)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(sc),
                                 implementation="xla")
    got = ths.hat_sample_2d_taps(*_port(x, ys, xs, sc))
    assert got.shape == (2, p, k * c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("h,w,c,p,k,spread", _CASES)
def test_taps_plain_matches_pallas_interpret(h, w, c, p, k, spread):
    """atol/rtol 2e-2: the TPU kernel rounds weights and x to bf16."""
    x, ys, xs, sc = _taps_case(2, h, w, c, p, k, spread, seed=1)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), jnp.asarray(sc),
                                 implementation="pallas", interpret=True)
    got = ths.hat_sample_2d_taps(*_port(x, ys, xs, sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)


def test_taps_scale_none_and_bf16():
    """scale=None is scale 1; a bf16 x gives bf16 out, the f32 result
    rounded once (within one bf16 ulp, rtol 2**-7 + atol 1e-2)."""
    x, ys, xs, _ = _taps_case(1, 16, 16, 128, 130, 9, 1.5, seed=2)
    ref = jhs.hat_sample_2d_taps(jnp.asarray(x), jnp.asarray(ys),
                                 jnp.asarray(xs), None, implementation="xla")
    tx, tys, txs = _port(x, ys, xs)
    got = ths.hat_sample_2d_taps(tx, tys, txs, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    got16 = ths.hat_sample_2d_taps(tx.bfloat16(), tys, txs, None)
    assert got16.dtype == torch.bfloat16
    f32 = ths.hat_sample_2d_taps(tx.bfloat16().float(), tys, txs, None)
    np.testing.assert_allclose(got16.float().numpy(), f32.numpy(),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("h,w,c,p,spread", [
    (16, 16, 32, 200, 1.5),
    (8, 16, 8, 130, 80.0),
])
def test_flat_plain_matches_jax_xla(h, w, c, p, spread):
    rs = np.random.RandomState(3)
    x = rs.randn(2, h, w, c).astype(np.float32)
    ys = (rs.rand(2, p) * h + rs.randn(2, p) * spread).astype(np.float32)
    xs = (rs.rand(2, p) * w + rs.randn(2, p) * spread).astype(np.float32)
    sc = rs.rand(2, p).astype(np.float32)
    ref = jhs.hat_sample_2d(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs),
                            jnp.asarray(sc), implementation="xla")
    got = ths.hat_sample_2d(*_port(x, ys, xs, sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sampler_refuses_grad():
    """No backward yet: an input that requires grad raises."""
    x, ys, xs, sc = _port(*_taps_case(1, 8, 8, 8, 10, 9, 1.0))
    with pytest.raises(RuntimeError, match="no backward"):
        ths.hat_sample_2d_taps(x.requires_grad_(), ys, xs, sc)
    with torch.no_grad():
        ths.hat_sample_2d_taps(x, ys, xs, sc)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_taps_kernel_matches_plain(cuda, dtype):
    """Kernel vs plain version on the card: f32 atol 1e-5; bf16 within one
    bf16 ulp of the plain f32 result (atol 1e-2 + rtol 2**-7)."""
    x, ys, xs, sc = _port(*_taps_case(2, 64, 64, 128, 4096, 9, 1.5))
    x, ys, xs, sc = (t.to(cuda) for t in (x, ys, xs, sc))
    got = ths.hat_sample_2d_taps(x.to(dtype), ys, xs, sc)
    torch.cuda.synchronize()
    ref = ths.hat_sample_2d_taps_plain(x.to(dtype).float(), ys, xs, sc)
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
def test_flat_sampler_raises_on_cuda(cuda):
    x = torch.zeros(1, 8, 8, 64, device=cuda)
    ys = torch.zeros(1, 10, device=cuda)
    with pytest.raises(NotImplementedError, match="_fwd_kernel"):
        ths.hat_sample_2d(x, ys, ys)
