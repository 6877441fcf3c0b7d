"""``utils/visual.py`` against the reference's, bit for bit (cv2 is on the
CPU host): ``draw_detections`` with scores under the threshold, negative
labels, class names and the default ones (the port draws on a copy, the
reference into a contiguous uint8 input: ``ROADMAP.md`` §3); ``draw_bev``
with points on and off the view and rotated boxes, and without boxes; the
port's own
``rect_corners`` against the reference's to the f32 rounding of cos / sin.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from minddet_tpu.ops.rotated_iou import rect_corners as j_rect_corners
from minddet_tpu.utils import visual as jvisual
from minddet_tpu_torch.utils import visual as tvisual

pytest.importorskip("cv2")


def test_draw_detections_matches_the_reference():
    rs = np.random.RandomState(0)
    image = rs.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    xy = rs.uniform(0, 90, (12, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 40, (12, 2))], -1)
    scores = rs.rand(12)
    labels = rs.randint(-1, 10, 12)
    for kw in (dict(scores=scores, labels=labels),
               dict(scores=scores, labels=labels,
                    class_names=["car", "person", "bike"]),
               dict(score_threshold=0.0, thickness=1), {}):
        ours, theirs = image.copy(), image.copy()
        got = tvisual.draw_detections(ours, boxes, **kw)
        want = jvisual.draw_detections(theirs, boxes, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert not np.array_equal(got, image)
        # the port draws on a copy; the reference into its input
        assert np.array_equal(ours, image) and want is theirs


def test_draw_bev_matches_the_reference():
    rs = np.random.RandomState(1)
    pcr = (-20.0, -20.0, -3.0, 20.0, 20.0, 1.0)
    points = rs.uniform(-25, 25, (2000, 4)).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-18, 18, (7, 3)),
                            rs.uniform(0.5, 5, (7, 3)),
                            rs.uniform(-np.pi, np.pi, (7, 1))],
                           -1).astype(np.float32)
    for b, res in ((boxes, 256), (None, 128), (boxes[:0], 128)):
        got = tvisual.draw_bev(points, b, pcr, resolution=res)
        want = jvisual.draw_bev(points, b, pcr, resolution=res)
        assert got.shape == (res, res, 3) and np.array_equal(got, want)
    bev = boxes[:, [0, 1, 3, 4, -1]]
    np.testing.assert_allclose(tvisual.rect_corners(bev),
                               np.asarray(j_rect_corners(jnp.asarray(bev))),
                               rtol=0, atol=1e-5)
