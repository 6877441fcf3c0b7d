"""The port's kernels as ``torch.library`` custom ops, on the CPU.

- ``torch.library.opcheck`` of every ``minddet::`` op (schema, autograd
  registration, the fake implementation against the real one, the op
  under AOT dispatch with dynamic shapes, gradients included) at one tiny
  shape each.
- Every op's CPU implementation is its plain version: the public wrappers
  give the plain versions' results bit for bit, and their gradients equal
  the plain backwards' (``*_bwd_plain``) bit for bit.
- The fake implementations (meta tensors) give the real outputs' shapes
  and types.
- The greedy NMS's fixed point as the exported program runs it
  (``_fixed_point_traced``, a ``while_loop``) gives the eager loop's keep
  mask and passes, and the reference's ``_greedy_keep_from_iou`` mask
  sample by sample, on random and tie-heavy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_seg_pallas import _random_stream

from minddet_tpu.ops.nms import _greedy_keep_from_iou as j_greedy
from minddet_tpu_torch.kernels import OP_MODULES
from minddet_tpu_torch.ops import bilinear as bl
from minddet_tpu_torch.ops import hat_sample as hs
from minddet_tpu_torch.ops import nms
from minddet_tpu_torch.ops import rotated_iou as ri
from minddet_tpu_torch.ops import seg_max as sm

OPS = ("TapsSample", "TapsSampleBwd", "FlatSample", "FlatSampleBwd",
       "BilinearGather", "BilinearGatherBwdDx", "BilinearGatherBwdDcw",
       "BilinearWarpAffine", "RotatedIntersectionBev", "SegFullMax",
       "SegFullMaxBwd")


def _coords(rs, shape, hi):
    return torch.from_numpy(rs.uniform(-1.5, hi + 0.5, shape)
                            .astype(np.float32))


def _cases():
    """Each op's arguments at a tiny shape (x's and the weights' gradients
    asked for where the op has one)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 6, 7, 8).astype(np.float32))
    ys, xs = _coords(rs, (2, 3, 10), 6), _coords(rs, (2, 3, 10), 7)
    sc = torch.from_numpy(rs.rand(2, 3, 10).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 10, 24).astype(np.float32))
    xf = torch.from_numpy(rs.randn(2, 6, 7, 5).astype(np.float32))
    yf, xf_, sf = ys.reshape(2, 30), xs.reshape(2, 30), sc.reshape(2, 30)
    gf = torch.from_numpy(rs.randn(2, 30, 5).astype(np.float32))
    xg = torch.from_numpy(rs.randn(2, 20, 6).astype(np.float32))
    ci = torch.from_numpy(rs.randint(-1, 22, (2, 9, 4)).astype(np.int32))
    cw = torch.from_numpy(rs.rand(2, 9, 4).astype(np.float32))
    gg = torch.from_numpy(rs.randn(2, 9, 6).astype(np.float32))
    img = torch.from_numpy(rs.rand(2, 10, 12, 3).astype(np.float32))
    aff = torch.tensor([[[0.9, 0.1, 1.0], [-0.1, 1.1, 0.5]],
                        [[1.3, 0.0, -2.0], [0.0, 1.3, -1.0]]])
    b1 = torch.from_numpy(np.concatenate(
        [rs.uniform(-3, 3, (2, 7, 2)), rs.uniform(0.5, 3, (2, 7, 2)),
         rs.uniform(-3, 3, (2, 7, 1))], -1).astype(np.float32))
    b2 = b1[:, :5].clone() + 0.3
    first, last, xs_seg = _random_stream(rs, 2, 30, 4, c=6)
    first, last = torch.from_numpy(first), torch.from_numpy(last)
    xseg = torch.from_numpy(xs_seg)
    m = sm.seg_full_max_bounded_plain(first, last, xseg, 4)
    gseg = torch.from_numpy(rs.randn(2, 30, 6).astype(np.float32))
    grad = lambda t: t.clone().requires_grad_()
    op = lambda name: getattr(torch.ops.minddet, name).default
    return {
        "TapsSample": (grad(x), grad(ys), grad(xs), grad(sc)),
        "TapsSampleBwd": (g, x, ys, xs, sc),
        "FlatSample": (grad(xf), grad(yf), grad(xf_), None),
        "FlatSampleBwd": (gf, xf, yf, xf_, sf),
        "BilinearGather": (grad(xg), ci, grad(cw)),
        "BilinearGatherBwdDx": (gg, xg, ci, cw),
        "BilinearGatherBwdDcw": (gg, xg, ci, cw),
        "BilinearWarpAffine": (img, aff, [8, 9]),
        "RotatedIntersectionBev": (b1, b2),
        "SegFullMax": (first, last, grad(xseg), 4),
        "SegFullMaxBwd": (first, last, xseg, m, gseg, 4),
    }, op


def test_every_kernel_is_an_op():
    """The eleven ops, one per hand-written kernel, registered by the
    modules ``OP_MODULES`` names."""
    import importlib

    for name in OP_MODULES:
        importlib.import_module(name)
    for name in OPS:
        assert hasattr(torch.ops.minddet, name), name


@pytest.mark.parametrize("name", OPS)
def test_opcheck_cpu(name):
    cases, op = _cases()
    torch.library.opcheck(op(name), cases[name])


def test_ops_are_the_plain_versions_bit_for_bit():
    cases, _ = _cases()
    x, ys, xs, sc = (t.detach() for t in cases["TapsSample"])
    assert torch.equal(hs.hat_sample_2d_taps(x, ys, xs, sc),
                       hs.hat_sample_2d_taps_plain(x, ys, xs, sc))
    assert torch.equal(hs.hat_sample_2d_taps(x, ys, xs),
                       hs.hat_sample_2d_taps_plain(x, ys, xs))
    g = cases["TapsSampleBwd"][0]
    for scale in (sc, None):
        got = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, scale)
        want = hs.hat_sample_2d_taps_bwd_plain(g, x, ys, xs, scale)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    xf, yf, xf_, _ = (t if t is None else t.detach()
                      for t in cases["FlatSample"])
    sf = cases["FlatSampleBwd"][4]
    assert torch.equal(hs.hat_sample_2d(xf, yf, xf_, sf),
                       hs.hat_sample_2d_plain(xf, yf, xf_, sf))
    gf = cases["FlatSampleBwd"][0]
    for a, b in zip(hs.hat_sample_2d_bwd(gf, xf, yf, xf_, sf),
                    hs.hat_sample_2d_bwd_plain(gf, xf, yf, xf_, sf)):
        assert torch.equal(a, b)
    gg, xg, ci, cw = cases["BilinearGatherBwdDx"]
    assert torch.equal(bl.bilinear_gather(xg, ci, cw),
                       bl.bilinear_gather_plain(xg, ci, cw))
    assert torch.equal(bl.bilinear_gather_bwd_dx(gg, xg, ci, cw),
                       bl.bilinear_gather_bwd_dx_plain(gg, ci, cw, 20))
    assert torch.equal(bl.bilinear_gather_bwd_dcw(gg, xg, ci, cw),
                       bl.bilinear_gather_bwd_dcw_plain(gg, xg, ci))
    img, aff, hw = cases["BilinearWarpAffine"]
    assert torch.equal(bl.bilinear_warp_affine(img, aff, tuple(hw)),
                       bl.bilinear_warp_affine_plain(img, aff, tuple(hw)))
    b1, b2 = cases["RotatedIntersectionBev"]
    assert torch.equal(ri.rotated_intersection_bev(b1, b2),
                       ri.rotated_intersection_bev_plain(b1, b2))
    assert torch.equal(ri.rotated_intersection_bev(b1[0], b2[0]),
                       ri.rotated_intersection_bev_plain(b1[0], b2[0]))
    first, last, xseg, m, gseg, bound = cases["SegFullMaxBwd"]
    assert torch.equal(sm.seg_full_max_bounded(first, last, xseg, bound), m)
    assert torch.equal(
        sm.seg_full_max_bounded_bwd(first, last, xseg, m, gseg, bound),
        sm.seg_full_max_bounded_bwd_plain(first, last, xseg, m, gseg, bound))


def _grads(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_() if t is not None
              and t.is_floating_point() else t for t in inputs]
    fn(*leaves).backward(g)
    return [t.grad if t is not None and t.is_floating_point() else None
            for t in leaves]


def test_gradients_through_the_ops_are_the_plain_backwards():
    cases, _ = _cases()
    x, ys, xs, sc = (t.detach() for t in cases["TapsSample"])
    g = cases["TapsSampleBwd"][0]
    got = _grads(hs.hat_sample_2d_taps, (x, ys, xs, sc), g)
    for a, b in zip(got, hs.hat_sample_2d_taps_bwd_plain(g, x, ys, xs, sc)):
        assert torch.equal(a, b)
    got = _grads(lambda *a: hs.hat_sample_2d_taps(*a), (x, ys, xs), g)
    for a, b in zip(got, hs.hat_sample_2d_taps_bwd_plain(g, x, ys, xs)):
        assert torch.equal(a, b)
    _, xf, yf, xf_, sf = cases["FlatSampleBwd"]
    gf = cases["FlatSampleBwd"][0]
    got = _grads(hs.hat_sample_2d, (xf, yf, xf_, sf), gf)
    for a, b in zip(got, hs.hat_sample_2d_bwd_plain(gf, xf, yf, xf_, sf)):
        assert torch.equal(a, b)
    gg, xg, ci, cw = cases["BilinearGatherBwdDx"]
    dx, _, dcw = _grads(bl.bilinear_gather, (xg, ci, cw), gg)
    assert torch.equal(dx, bl.bilinear_gather_bwd_dx_plain(gg, ci, cw, 20))
    assert torch.equal(dcw, bl.bilinear_gather_bwd_dcw_plain(gg, xg, ci))
    first, last, xseg, m, gseg, bound = cases["SegFullMaxBwd"]
    xt = xseg.clone().requires_grad_()
    sm.seg_full_max_bounded(first, last, xt, bound).backward(gseg)
    assert torch.equal(xt.grad, sm.seg_full_max_bounded_bwd_plain(
        first, last, xseg, m, gseg, bound))


def test_fake_implementations_give_the_real_shapes_and_types():
    """Meta tensors take the fake implementations, which give each output
    the real one's shape and type."""
    cases, op = _cases()
    for name in OPS:
        args = [t.detach().to("meta") if isinstance(t, torch.Tensor) else t
                for t in cases[name]]
        real = op(name)(*[a.detach() if isinstance(a, torch.Tensor) else a
                          for a in cases[name]])
        fake = op(name)(*args)
        for r, f in zip(real if isinstance(real, tuple) else (real,),
                        fake if isinstance(fake, tuple) else (fake,)):
            assert f.device.type == "meta"
            assert (f.shape, f.dtype) == (r.shape, r.dtype), name


def _nms_case(rs, b, n, ties):
    boxes = np.concatenate([rs.uniform(0, 40, (b, n, 2)),
                            rs.uniform(4, 14, (b, n, 2))], -1)
    boxes[..., 2:] += boxes[..., :2]
    scores = rs.rand(b, n)
    if ties:  # a few score levels and duplicated boxes
        scores = np.round(scores * 3) / 3
        boxes[:, 1::3] = boxes[:, ::3][:, : boxes[:, 1::3].shape[1]]
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_traced_fixed_point_is_the_eager_one_and_the_reference(ties):
    from minddet_tpu.ops.box import pairwise_iou as j_iou
    from minddet_tpu_torch.ops.box import pairwise_iou

    rs = np.random.RandomState(3 + ties)
    boxes, scores = _nms_case(rs, 3, 48, ties)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    valid = st > 0.1
    iou = pairwise_iou(bt, bt)
    keep, passes = nms.greedy_keep_from_iou(iou, st, valid, 0.3)
    tkeep, tpasses = nms._fixed_point_traced(
        nms._suppress(iou, st, valid, 0.3), valid)
    assert passes > 1 and torch.equal(keep, tkeep)
    assert tpasses.dtype == torch.int64 and int(tpasses) == passes
    for i in range(3):
        ref = j_greedy(j_iou(jnp.asarray(boxes[i]), jnp.asarray(boxes[i])),
                       jnp.asarray(scores[i]), jnp.asarray(scores[i] > 0.1),
                       0.3)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref))
