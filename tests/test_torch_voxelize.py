"""Port's stream voxelizer vs the JAX package's, on the CPU.

The same numpy-seeded clouds go through ``minddet_tpu.ops.voxelize.
voxelize_stream`` (one cloud at a time, as the reference vmaps it) and the
port's batched ``voxelize_stream_batch``. The integer outputs (``keep``,
``first``, ``last``, ``canvas_idx``, ``num_voxels``) must be equal; the
decorated features within 1e-6 (the same bounded scans in the same order).
Both drop orders, with and without overflow of ``max_voxels`` and of
``max_points``. The bounded segmented operations are held against a brute
force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops import voxelize as jvox
from minddet_tpu_torch.ops import voxelize as tvox

PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
VS = (0.2, 0.2, 4.0)


def _clouds(b, n, seed, clustered):
    """(b, n, 4) clouds over PCR, some points out of range and some
    masked; ``clustered`` piles points into few cells (so pillars overflow
    ``max_points``)."""
    rs = np.random.RandomState(seed)
    lo = np.array(PCR[:3]) - 0.3
    hi = np.array(PCR[3:]) + 0.3
    if clustered:
        centres = rs.uniform(lo + 0.3, hi - 0.3, (b, 12, 3))
        pick = rs.randint(0, 12, (b, n))
        xyz = np.take_along_axis(centres, pick[..., None], 1)
        xyz = xyz + rs.randn(b, n, 3) * [0.15, 0.15, 0.5]
    else:
        xyz = rs.uniform(lo, hi, (b, n, 3))
    pts = np.concatenate([xyz, rs.uniform(0, 1, (b, n, 1))], -1)
    mask = rs.uniform(size=(b, n)) > 0.1
    return pts.astype(np.float32), mask


# (points, max_voxels, max_points, clustered): no overflow; too many
# pillars; too many points per pillar
_CASES = [(300, 1024, 32, False), (600, 200, 32, False),
          (600, 1024, 8, True)]


@pytest.mark.parametrize("drop_order", ["sorted", "first_come"])
@pytest.mark.parametrize("n,max_voxels,max_points,clustered", _CASES)
def test_stream_matches_jax(drop_order, n, max_voxels, max_points,
                            clustered):
    pts, mask = _clouds(2, n, seed=n + max_points, clustered=clustered)
    got = tvox.voxelize_stream_batch(
        torch.from_numpy(pts), torch.from_numpy(mask), VS, PCR, max_voxels,
        max_points, drop_order)
    dropped_pillars = 0
    for i in range(2):
        ref = jvox.voxelize_stream(jnp.asarray(pts[i]), jnp.asarray(mask[i]),
                                   VS, PCR, max_voxels, max_points,
                                   drop_order)
        for name in ("keep", "first", "last", "canvas_idx", "num_voxels"):
            np.testing.assert_array_equal(
                getattr(got, name)[i].numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        np.testing.assert_allclose(got.feats[i].numpy(),
                                   np.asarray(ref.feats), rtol=0, atol=1e-6)
        dropped_pillars += int(np.asarray(ref.first).sum()
                               - np.asarray(ref.num_voxels))
    if max_voxels < 1024:  # the case is meant to overflow the pillar cap
        assert dropped_pillars > 0
    if max_points < 32:  # ... and this one the per-pillar point cap
        lo, hi = np.array(PCR[:3]), np.array(PCR[3:])
        valid = mask & ((pts[..., :3] >= lo) & (pts[..., :3] < hi)).all(-1)
        assert dropped_pillars == 0
        assert int(got.keep.sum()) < int(valid.sum())


def test_batch_keeps_clouds_apart():
    """A cloud's stream is the same alone and in a batch."""
    pts, mask = _clouds(2, 200, seed=3, clustered=False)
    batch = tvox.voxelize_stream_batch(torch.from_numpy(pts),
                                       torch.from_numpy(mask), VS, PCR, 64,
                                       4, "sorted")
    for i in range(2):
        one = tvox.voxelize_stream_batch(torch.from_numpy(pts[i:i + 1]),
                                         torch.from_numpy(mask[i:i + 1]),
                                         VS, PCR, 64, 4, "sorted")
        for a, b in zip(one, batch):
            assert torch.equal(a[0], b[i])
    assert tvox.grid_size(PCR, VS) == jvox.grid_size(PCR, VS) == (32, 32, 1)


def test_bounded_seg_ops_match_bruteforce():
    """Exact at every row within ``bound`` of its segment head (sum, max)
    or of its flagged row (broadcast), with segments longer than the
    bound; batched along dim 1."""
    rs = np.random.RandomState(17)
    b, n, c, bound = 2, 400, 5, 8
    first = np.zeros((b, n), bool)
    for bi in range(b):
        i = 0
        while i < n:
            first[bi, i] = True
            i += rs.randint(1, 20)  # some segments exceed the bound
    x = rs.randn(b, n, c).astype(np.float32)

    seg = np.cumsum(first, 1) - 1
    run_max = np.empty_like(x)
    run_sum = np.empty_like(x)
    for bi in range(b):
        for s in range(seg[bi].max() + 1):
            idx = np.where(seg[bi] == s)[0]
            run_max[bi, idx] = np.maximum.accumulate(x[bi, idx], 0)
            run_sum[bi, idx] = np.cumsum(x[bi, idx], 0)
    pos = np.arange(n)
    head = np.maximum.accumulate(np.where(first, pos, -1), 1)
    ok = pos - head < bound
    assert ok.sum() > b * n // 2 and (~ok).any()

    tf, tx = torch.from_numpy(first), torch.from_numpy(x)
    got_max = tvox.seg_running_max(tf, tx, bound).numpy()
    got_sum = tvox._seg_sum_bounded(tf, tx, bound).numpy()
    np.testing.assert_array_equal(got_max[ok], run_max[ok])
    np.testing.assert_allclose(got_sum[ok], run_sum[ok], rtol=1e-5,
                               atol=1e-5)

    # broadcast: a flagged row's value reaches the bound-1 rows before it
    sel = np.zeros((b, n), bool)
    sel[:, :-1] = first[:, 1:]
    sel[:, -1] = True
    got_b = tvox._seg_bcast_bounded(torch.from_numpy(sel), tx, bound).numpy()
    nxt = np.minimum.accumulate(np.where(sel, pos, n)[:, ::-1], 1)[:, ::-1]
    near = nxt - pos < bound
    for bi in range(b):
        rows = np.where(near[bi])[0]
        np.testing.assert_array_equal(got_b[bi, rows], x[bi, nxt[bi, rows]])

    # the windowed running max over at least `bound` trailing rows
    v = rs.randint(-5, 100, (b, n)).astype(np.int32)
    got_w = tvox._windowed_running_max(torch.from_numpy(v), bound).numpy()
    for i in range(n):
        lo = max(0, i - bound + 1)
        assert (got_w[:, i] >= v[:, lo:i + 1].max(1)).all()
        assert (got_w[:, i] <= v[:, max(0, i - 2 * bound):i + 1].max(1)).all()


def test_bounded_ops_match_jax_bitwise():
    """The port's scans run the reference's levels in the same order."""
    rs = np.random.RandomState(5)
    first = rs.uniform(size=(1, 300)) < 0.2
    first[:, 0] = True
    x = rs.randn(1, 300, 3).astype(np.float32)
    ref = jvox._seg_sum_bounded(jnp.asarray(first[0]), jnp.asarray(x[0]), 16)
    got = tvox._seg_sum_bounded(torch.from_numpy(first), torch.from_numpy(x),
                                16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
