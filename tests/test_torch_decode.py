"""Port's CenterNet decode vs the JAX package's, on heatmaps with plateaus
and exact-zero ties: indices, classes and positions must match exactly
(JAX's top_k puts the lower index first among equal values), scores and
boxes to f32 rounding (atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops import decode as jd
from minddet_tpu_torch.ops import decode as td


def _heads(b, h, w, c, seed, plateau=True, sparse=True):
    rs = np.random.RandomState(seed)
    hm = rs.rand(b, h, w, c).astype(np.float32)
    if plateau:
        # flat 2x2 plateaus of equal values: every cell of one is a peak
        for _ in range(6):
            bi, y, x, ci = (rs.randint(b), rs.randint(h - 1),
                            rs.randint(w - 1), rs.randint(c))
            hm[bi, y:y + 2, x:x + 2, ci] = 0.97
        # equal values in different classes at different positions
        hm[:, 1, 1, :] = 0.99
    if sparse:
        # mostly exact zeros: far fewer than K peaks per class
        hm[rs.rand(b, h, w, c) < 0.9] = 0.0
    wh = (rs.rand(b, h, w, 2) * 10).astype(np.float32)
    reg = rs.rand(b, h, w, 2).astype(np.float32)
    return {"hm": hm, "wh": wh, "reg": reg}


@pytest.mark.parametrize("b,h,w,c,k,seed,plateau,sparse", [
    (2, 16, 16, 4, 100, 0, True, True),
    (2, 16, 12, 3, 100, 1, True, True),
    (1, 8, 8, 2, 50, 2, False, True),     # few peaks, many zero ties
    (2, 32, 32, 5, 40, 3, True, False),   # dense heatmap
])
def test_topk_matches_jax_exactly(b, h, w, c, k, seed, plateau, sparse):
    heads = _heads(b, h, w, c, seed, plateau, sparse)
    jheat = jd.heatmap_peaks(jnp.asarray(heads["hm"]))
    theat = td.heatmap_peaks(torch.from_numpy(heads["hm"]))
    np.testing.assert_array_equal(theat.numpy(), np.asarray(jheat))
    ref = jd.topk_heatmap(jheat, k)
    got = td.topk_heatmap(theat, k)
    for name, r, g in zip(("scores", "inds", "classes", "ys", "xs"), ref,
                          got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("with_reg", [True, False])
def test_centernet_decode_matches_jax(with_reg):
    heads = _heads(2, 16, 16, 4, seed=5)
    if not with_reg:
        del heads["reg"]
    ref = np.asarray(jd.centernet_decode(
        {n: jnp.asarray(a) for n, a in heads.items()}, k=100))
    got = td.centernet_decode(
        {n: torch.from_numpy(a) for n, a in heads.items()}, k=100).numpy()
    assert got.shape == (2, 100, 6)
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # classes
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_gather_feature_matches_jax():
    rs = np.random.RandomState(6)
    feat = rs.randn(2, 8, 8, 3).astype(np.float32)
    inds = rs.randint(0, 64, (2, 10)).astype(np.int32)
    ref = jd.gather_feature(jnp.asarray(feat), jnp.asarray(inds))
    got = td.gather_feature(torch.from_numpy(feat),
                            torch.from_numpy(inds).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
