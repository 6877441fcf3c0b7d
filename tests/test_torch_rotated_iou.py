"""Port's rotated-box intersection and IoU vs the JAX package's.

The port's plain version (``rotated_intersection_bev_plain``, the K4
kernel's algorithm) against the JAX XLA form on the CPU
(``rotated_intersection_bev``) with atol 2e-4 on areas, the tolerance that
``tests/test_rotated_iou.py`` holds the Pallas kernel to; against the Pallas
kernel itself in interpret mode on one (16, 512) tile, same tolerance (it
clips in absolute coordinates, the port in pair-relative ones). The exact
cases, the criteria and the batched form; on a card, the kernel against
the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minddet_tpu.ops.rotated_iou import rotated_intersection_bev as j_inter
from minddet_tpu.ops.rotated_iou import rotated_iou_bev as j_iou
from minddet_tpu.ops.rotated_iou_pallas import rotated_intersection_bev_pallas
from minddet_tpu_torch.ops import rotated_iou as ri


def _boxes(rs, n, span, near_duplicates_of=None):
    """(n, 5) boxes with centres in [-span, span]; or jittered copies of
    ``near_duplicates_of`` (centre/size noise 0.05, yaw 0.02 or + pi)."""
    if near_duplicates_of is not None:
        src = near_duplicates_of[rs.randint(0, len(near_duplicates_of), n)]
        out = src + rs.randn(n, 5) * [0.05, 0.05, 0.05, 0.05, 0.02]
        out[:, 4] += np.where(rs.uniform(size=n) < 0.3, math.pi, 0.0)
        return out.astype(np.float32)
    return np.stack([rs.uniform(-span, span, n), rs.uniform(-span, span, n),
                     rs.uniform(0.4, 5, n), rs.uniform(0.4, 7, n),
                     rs.uniform(-math.pi, math.pi, n)], -1).astype(np.float32)


def _kitti(rs, n):
    """Car-sized boxes over the KITTI range, yaws near the axes or free."""
    yaw = np.where(rs.uniform(size=n) < 0.5,
                   rs.randint(-1, 2, n) * math.pi / 2 + rs.randn(n) * 0.05,
                   rs.uniform(-math.pi, math.pi, n))
    return np.stack([rs.uniform(0, 69.12, n), rs.uniform(-39.68, 39.68, n),
                     1.6 * np.exp(rs.randn(n) * 0.1),
                     3.9 * np.exp(rs.randn(n) * 0.1), yaw],
                    -1).astype(np.float32)


def _case(name):
    rs = np.random.RandomState(
        ["small", "spread", "kitti_near_duplicates"].index(name))
    if name == "small":
        return _boxes(rs, 40, 5), _boxes(rs, 70, 5)
    if name == "kitti_near_duplicates":
        a = _kitti(rs, 60)
        return a, np.concatenate([a[:20], _boxes(rs, 80, 0, a)])
    a = _boxes(rs, 50, 30)  # "spread": the Pallas test's distribution
    return a, _boxes(rs, 90, 30)


@pytest.mark.parametrize("name", ["small", "spread",
                                  "kitti_near_duplicates"])
def test_plain_matches_jax_xla(name):
    b1, b2 = _case(name)
    ref = np.asarray(j_inter(jnp.asarray(b1), jnp.asarray(b2)))
    got = ri.rotated_intersection_bev(torch.from_numpy(b1),
                                      torch.from_numpy(b2))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (ref > 0).sum() > 20  # the case has overlaps
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)


def test_plain_matches_pallas_interpret_tile():
    """One (16, 512) tile of the TPU kernel, in interpret mode, on boxes
    and near-duplicates (identical boxes: the next test)."""
    rs = np.random.RandomState(0)
    a = _boxes(rs, 16, 30)
    b = np.concatenate([_boxes(rs, 216, 30), _boxes(rs, 296, 0, a)])
    ref = np.asarray(rotated_intersection_bev_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = ri.rotated_intersection_bev(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()
    assert got.shape == (16, 512) and (ref > 0).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_reference_pallas_loses_area_of_identical_far_boxes():
    """A fault of the reference that the port does not copy: the TPU
    kernel clips in absolute coordinates, so for two identical boxes ~29 m
    from the origin the sides of A's corners against B's edges are
    rounding noise of ~1e-5, beyond its 1e-6 inside tolerance, and the
    clipped polygon loses half the box. The XLA form and the port
    (pair-relative coordinates) give the full area."""
    boxes = np.array([[2.9288101, -28.786896, 2.4982915, 2.481827,
                       -1.9064293],
                      [-4.580712, 28.7171, 3.2156403, 6.9232674, 2.1233704]],
                     np.float32)
    area = boxes[:, 2] * boxes[:, 3]
    pallas = np.diag(np.asarray(rotated_intersection_bev_pallas(
        jnp.asarray(boxes), jnp.asarray(boxes), interpret=True)))
    xla = np.diag(np.asarray(j_inter(jnp.asarray(boxes), jnp.asarray(boxes))))
    port = np.diag(ri.rotated_intersection_bev(
        torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy())
    np.testing.assert_allclose(xla, area, rtol=1e-5)
    np.testing.assert_allclose(port, area, rtol=1e-5)
    np.testing.assert_allclose(pallas, area / 2, rtol=1e-3)


def test_reference_xla_form_misses_nearly_antiparallel_pair():
    """A fault of the reference's XLA form (the CPU path and the tests'
    oracle): for two car boxes whose yaws differ by ~pi - 0.05, its
    angular-successor chain over the 24 candidate points takes a wrong
    boundary and reports IoU 0.699 where a float64 polygon clip gives
    0.463. The port (and the TPU kernel's algorithm) clips correctly."""
    from test_rotated_iou import _np_rotated_iou

    boxes = np.array([[1.2042602, 0.2872574, 1.4994694, 3.5955923,
                       0.08571436],
                      [1.343527, 1.3562694, 1.5517051, 3.6231813,
                       3.0894208]], np.float32)
    golden = _np_rotated_iou(boxes[0].astype(np.float64),
                             boxes[1].astype(np.float64))
    xla = float(np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(boxes)))[0, 1])
    port = float(ri.rotated_iou_bev(torch.from_numpy(boxes),
                                    torch.from_numpy(boxes))[0, 1])
    assert abs(golden - 0.46323) < 1e-4
    assert abs(port - golden) < 1e-5
    assert abs(xla - 0.69905) < 1e-4


_EXACT = np.array([
    [0.0, 0.0, 2.0, 4.0, 0.0],
    [0.0, 0.0, 2.0, 4.0, math.pi / 2],   # the same box turned 90 degrees
    [10.0, 10.0, 2.0, 2.0, 0.3],         # disjoint
    [0.0, 0.0, 1.0, 1.0, 0.0],           # inside box 0
    [1.0, 2.0, 3.0, 4.0, 0.7],           # identical to itself
    [2.0, 0.0, 2.0, 4.0, 0.0],           # shares an edge with box 0
    [0.0, 0.0, 2.0, 2.0, math.pi / 4],   # a 45 degree cross with the next
    [0.0, 0.0, 2.0, 2.0, 0.0],
], np.float32)


def test_exact_cases():
    a = ri.rotated_intersection_bev(torch.from_numpy(_EXACT),
                                    torch.from_numpy(_EXACT)).numpy()
    np.testing.assert_allclose(np.diag(a), _EXACT[:, 2] * _EXACT[:, 3],
                               atol=1e-5)
    assert abs(a[0, 1] - 4.0) < 1e-5          # cross of 2x4 and 4x2
    assert a[0, 2] == 0.0 and a[2, 0] == 0.0  # disjoint
    assert abs(a[0, 3] - 1.0) < 1e-5 and abs(a[3, 0] - 1.0) < 1e-5
    assert abs(a[0, 5]) < 1e-5                # touching along an edge
    # 45 degree cross of two 2x2 squares: an octagon of 8 (sqrt(2) - 1)
    assert abs(a[6, 7] - 8 * (math.sqrt(2) - 1)) < 1e-5
    iou = ri.rotated_iou_bev(torch.from_numpy(_EXACT),
                             torch.from_numpy(_EXACT)).numpy()
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-6)
    ref = np.asarray(j_iou(jnp.asarray(_EXACT), jnp.asarray(_EXACT)))
    np.testing.assert_allclose(iou, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_criteria_match_jax(criterion):
    b1, b2 = _case("small")
    ref = np.asarray(j_iou(jnp.asarray(b1), jnp.asarray(b2), criterion))
    got = ri.rotated_iou_bev(torch.from_numpy(b1), torch.from_numpy(b2),
                             criterion).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="criterion"):
        ri.rotated_iou_bev(torch.from_numpy(b1), torch.from_numpy(b2), 2)


def test_batched_and_chunked_forms():
    rs = np.random.RandomState(3)
    b1 = np.stack([_boxes(rs, 37, 4) for _ in range(3)])
    b2 = np.stack([_boxes(rs, 29, 4) for _ in range(3)])
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    batched = ri.rotated_intersection_bev(t1, t2)
    chunked = ri.rotated_intersection_bev_plain(t1, t2, row_chunk=5)
    assert batched.shape == (3, 37, 29)
    assert torch.equal(batched, chunked)
    for i in range(3):
        assert torch.equal(batched[i], ri.rotated_intersection_bev(t1[i],
                                                                   t2[i]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_matches_plain(cuda, b):
    rs = np.random.RandomState(b)
    boxes = np.stack([np.concatenate([_kitti(rs, 600), _boxes(
        rs, 300, 0, _kitti(rs, 300))]) for _ in range(b)])
    t = torch.from_numpy(boxes).to(cuda)
    got = ri.rotated_intersection_bev(t, t)
    torch.cuda.synchronize()
    ref = ri.rotated_intersection_bev_plain(t, t)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
