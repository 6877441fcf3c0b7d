"""The port's decode + rotated-NMS program (``entry.py:chained_decode_nms``)
vs the reference's (``bench.py:bench_decode_nms_p50``), on the CPU.

The reference's program is written out here as ``bench.py`` writes it
(sigmoid, ``lax.top_k``, the gathers and the decode, ``minddet_tpu.ops.nms.
rotated_nms``, the summed scores, a ``fori_loop`` over perturbed heatmaps)
with the map side and the top-k as arguments, and jitted. At 32x32 with the
top 200 (83 kept, IoU 0.2, score 0.1) on ``bench.py``'s draws, both give
the same candidates, the same kept indices in every iteration and the same
summed score (rtol 1e-6: f32 sums of 83 scores in another order); no
candidate pair's IoU lies within NEAR of 0.2, where a rounding difference
could flip a keep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops.nms import rotated_nms as j_rotated_nms
from minddet_tpu.ops.rotated_iou import rotated_iou_bev as j_iou
from minddet_tpu_torch.entry import (DECODE_HW, DECODE_ITERATIONS,
                                     chained_decode_nms,
                                     decode_candidates_bev, decode_nms,
                                     decode_nms_entry, decode_nms_maps)

HW = 32
NMS_PRE = 200
NMS_POST = 83
ITERATIONS = 4
NEAR = 1e-5


def _reference(nms_pre, iterations):
    """``bench.py:bench_decode_nms_p50``'s ``decode_nms`` and ``chained``,
    with the top-k and the iteration count as arguments; also returns each
    iteration's candidates and kept indices."""

    def decode(hm, reg, dim, rot):
        w = hm.shape[1]
        scores = jax.nn.sigmoid(hm).reshape(-1)
        k_scores, k_idx = jax.lax.top_k(scores, nms_pre)
        ys = (k_idx // w).astype(jnp.float32)
        xs = (k_idx % w).astype(jnp.float32)
        r2 = reg.reshape(-1, 2)[k_idx]
        d2 = jnp.exp(dim.reshape(-1, 3)[k_idx]) * 0.8
        rr = rot.reshape(-1, 2)[k_idx]
        yaw = jnp.arctan2(rr[:, 0], rr[:, 1])
        cx = (xs + r2[:, 0]) * 0.8 - 51.2
        cy = (ys + r2[:, 1]) * 0.8 - 51.2
        bev = jnp.stack([cx, cy, d2[:, 0], d2[:, 1], yaw], -1)
        keep, _ = j_rotated_nms(bev, k_scores, iou_threshold=0.2,
                                score_threshold=0.1, max_outputs=NMS_POST)
        return (jnp.sum(k_scores[jnp.clip(keep, 0, nms_pre - 1)]), keep,
                k_scores, k_idx, bev)

    @jax.jit
    def chained(hm, reg, dim, rot):
        def body(i, carry):
            acc, keeps = carry
            total, keep, *_ = decode(hm + 0.01 * i, reg, dim, rot)
            return acc + total, keeps.at[i].set(keep)

        keeps = jnp.zeros((iterations, NMS_POST), jnp.int32)
        return jax.lax.fori_loop(0, iterations, body, (0.0, keeps))

    return chained, jax.jit(decode)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A 200-box NMS is small: one intra-op thread is faster for it than
    many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    maps = decode_nms_maps(HW)
    chained, decode = _reference(NMS_PRE, ITERATIONS)
    j_acc, j_keeps = jax.device_get(chained(*(jnp.asarray(m)
                                              for m in maps)))
    first = jax.device_get(decode(*(jnp.asarray(m) for m in maps)))
    return dict(maps=maps, j_acc=j_acc, j_keeps=j_keeps, j_first=first)


def test_candidates_match_the_reference(case):
    _, _, k_scores, k_idx, bev = case["j_first"]
    scores, got = decode_candidates_bev(
        *(torch.from_numpy(m) for m in case["maps"]), NMS_PRE)
    np.testing.assert_array_equal(scores.numpy(), k_scores)
    np.testing.assert_allclose(got.numpy(), bev, rtol=0, atol=1e-5)
    iou = np.asarray(jax.jit(j_iou)(jnp.asarray(bev), jnp.asarray(bev)))
    valid = k_scores > 0.1
    pair = valid[:, None] & valid[None, :] & ~np.eye(NMS_PRE, dtype=bool)
    assert not (pair & (np.abs(iou - 0.2) < NEAR)).any()
    assert (pair & (iou > 0.2)).sum() > 10  # the NMS suppresses


def test_program_matches_the_reference(case):
    """Every iteration's kept indices equal, and the summed score."""
    maps = tuple(torch.from_numpy(m) for m in case["maps"])
    step = torch.tensor(0.01, dtype=torch.float32)
    for i in range(ITERATIONS):
        _, keep, passes = decode_nms(maps[0] + step * i, *maps[1:],
                                     nms_pre=NMS_PRE, nms_post=NMS_POST)
        np.testing.assert_array_equal(keep.numpy(), case["j_keeps"][i])
        assert passes >= 2
        kept = int((keep >= 0).sum())
        assert 10 < kept <= NMS_POST
    acc, passes = chained_decode_nms(*maps, iterations=ITERATIONS,
                                     nms_pre=NMS_PRE, nms_post=NMS_POST)
    assert len(passes) == ITERATIONS and acc.dtype == torch.float32
    np.testing.assert_allclose(float(acc), float(case["j_acc"]), rtol=1e-6)


def test_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_nms_entry()


def test_entry_builds_bench_maps_on_cpu():
    """``decode_nms_entry`` on the CPU when asked: the program and
    ``bench.py``'s four maps, in its draw order from RandomState(0)."""
    program, maps = decode_nms_entry(device="cpu")
    assert program is chained_decode_nms and DECODE_ITERATIONS == 20
    rs = np.random.RandomState(0)
    ref = (rs.randn(DECODE_HW, DECODE_HW), rs.rand(DECODE_HW, DECODE_HW, 2),
           rs.rand(DECODE_HW, DECODE_HW, 3),
           rs.randn(DECODE_HW, DECODE_HW, 2))
    for got, want in zip(maps, ref):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
