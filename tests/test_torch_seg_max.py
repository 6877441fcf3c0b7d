"""The port's bounded segment max vs the JAX package's, on the CPU.

``seg_full_max_bounded`` of the port runs its plain version here (the
shift-level form, zeroed outside ``seg_covered``); the JAX function runs its
Pallas body in interpret mode and its XLA form. The two are compared at the
rows between a segment's head and its last kept row (``seg_covered``; for a
voxelizer stream its kept rows): the reference leaves the other rows to
whatever its shift levels produce, the port puts 0 there. f32 within 1e-6,
bf16 exactly (max and select only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_seg_pallas import _random_stream

from minddet_tpu.ops.seg_pallas import seg_full_max_bounded as j_seg_full_max
from minddet_tpu_torch.models.readers.pillar_encoder import PillarFeatureNet
from minddet_tpu_torch.ops.seg_max import (seg_covered, seg_full_max_bounded,
                                           seg_full_max_bounded_plain)
from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch


def _brute(first, last, x, bound):
    """Per row: the max over [head, last] of its segment, 0 elsewhere."""
    out = np.zeros_like(x)
    covered = np.zeros(first.shape, bool)
    b, n = first.shape
    for bi in range(b):
        head = None
        for i in range(n):
            if first[bi, i]:
                head = i
            if last[bi, i] and head is not None and i - head < bound:
                out[bi, head:i + 1] = x[bi, head:i + 1].max(0)
                covered[bi, head:i + 1] = True
                head = None  # rows past the last kept row are not covered
    return out, covered


@pytest.mark.parametrize("n,tn,bound,c", [(512, 128, 6, 8), (1000, 256, 6, 8),
                                          (900, 256, 20, 32)])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_matches_jax_f32(n, tn, bound, c, impl):
    """N = 1000 and 900 are no multiple of the Pallas tile."""
    first, last, x = _random_stream(np.random.RandomState(0), 2, n, bound,
                                    c=c)
    kw = dict(block_rows=tn, interpret=True) if impl == "pallas_interpret" \
        else dict(implementation="xla")
    ref = np.asarray(j_seg_full_max(jnp.asarray(first), jnp.asarray(last),
                                    jnp.asarray(x), bound, **kw))
    got = seg_full_max_bounded(torch.from_numpy(first),
                               torch.from_numpy(last), torch.from_numpy(x),
                               bound).numpy()
    covered = seg_covered(torch.from_numpy(first), torch.from_numpy(last),
                          bound).numpy()
    assert covered.all()  # these streams have no row outside a segment
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, _brute(first, last, x, bound)[0])


def test_matches_jax_bf16_exactly():
    bound = 20
    first, last, x = _random_stream(np.random.RandomState(1), 2, 900, bound,
                                    c=64)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(j_seg_full_max(jnp.asarray(first), jnp.asarray(last),
                                    xb, bound, block_rows=256,
                                    interpret=True).astype(jnp.float32))
    got = seg_full_max_bounded(torch.from_numpy(first),
                               torch.from_numpy(last),
                               torch.from_numpy(x).to(torch.bfloat16), bound)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_voxelizer_stream_with_overflow_matches_jax_at_kept_rows():
    """A stream from the port's voxelizer: pillars with more points than the
    cap (rows past ``last``), more pillars than ``max_voxels`` (segments with
    no ``last``) and an invalid tail. Compared with JAX at the kept rows;
    everywhere else the port holds 0."""
    rs = np.random.RandomState(2)
    pts = rs.uniform([0, 0, -1, 0], [3.2, 3.2, 1, 1], (2, 700, 4)).astype(
        np.float32)
    mask = rs.uniform(size=(2, 700)) < 0.9
    bound = 4
    sv = voxelize_stream_batch(torch.from_numpy(pts), torch.from_numpy(mask),
                               (0.4, 0.4, 2.0), (0, 0, -1, 3.2, 3.2, 1),
                               max_voxels=40, max_points=bound,
                               drop_order="sorted")
    keep = sv.keep.numpy()
    covered = seg_covered(sv.first, sv.last, bound).numpy()
    np.testing.assert_array_equal(covered, keep)
    assert 0.2 < keep.mean() < 0.8
    x = rs.randn(2, 700, 8).astype(np.float32)
    got = seg_full_max_bounded(sv.first, sv.last, torch.from_numpy(x),
                               bound).numpy()
    ref = np.asarray(j_seg_full_max(jnp.asarray(sv.first.numpy()),
                                    jnp.asarray(sv.last.numpy()),
                                    jnp.asarray(x), bound, block_rows=128,
                                    interpret=True))
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6, atol=1e-6)
    assert (got[~keep] == 0).all()
    want, want_cov = _brute(sv.first.numpy(), sv.last.numpy(), x, bound)
    np.testing.assert_array_equal(want_cov, keep)
    np.testing.assert_array_equal(got, want)


def test_two_layer_pfn_ignores_rows_that_are_not_kept():
    """The two-layer stream PFN's output at each pillar's last kept row does
    not depend on what the rows that are not kept hold."""
    rs = np.random.RandomState(3)
    pts = rs.uniform([0, 0, -1, 0], [3.2, 3.2, 1, 1], (1, 500, 4)).astype(
        np.float32)
    sv = voxelize_stream_batch(torch.from_numpy(pts),
                               torch.ones(1, 500, dtype=torch.bool),
                               (0.4, 0.4, 2.0), (0, 0, -1, 3.2, 3.2, 1),
                               max_voxels=40, max_points=4,
                               drop_order="sorted")
    torch.manual_seed(0)
    pfn = PillarFeatureNet(9, (16, 16)).eval()
    noisy = torch.where(sv.keep[..., None], sv.feats,
                        torch.from_numpy(rs.randn(1, 500, 9).astype(
                            np.float32)) * 50)
    assert not sv.keep.all()
    with torch.no_grad():
        a = pfn.stream(sv.feats, sv.keep, sv.first, sv.last, bound=4)
        b = pfn.stream(noisy, sv.keep, sv.first, sv.last, bound=4)
    assert sv.last.sum() == 40
    np.testing.assert_array_equal(a[sv.last].numpy(), b[sv.last].numpy())
    assert a[sv.last].abs().sum() > 0


def test_requires_grad_raises_until_the_backward_is_ported():
    first, last, x = _random_stream(np.random.RandomState(4), 1, 64, 4)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        seg_full_max_bounded(torch.from_numpy(first), torch.from_numpy(last),
                             xt, 4)
    with torch.no_grad():  # the eval path of a model with parameters
        seg_full_max_bounded(torch.from_numpy(first), torch.from_numpy(last),
                             xt, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype):
    first, last, x = _random_stream(np.random.RandomState(5), 2, 3001, 20,
                                    c=32)
    last[:, ::7] = False  # segments with no last row, rows past it
    f, l = torch.from_numpy(first).to(cuda), torch.from_numpy(last).to(cuda)
    xt = torch.from_numpy(x).to(cuda, dtype)
    got = seg_full_max_bounded(f, l, xt, 20)
    torch.cuda.synchronize()
    assert torch.equal(got, seg_full_max_bounded_plain(f, l, xt, 20))
