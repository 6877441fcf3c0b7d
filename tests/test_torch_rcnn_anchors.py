"""The bf16 R-CNN serving model keeps its anchors in f32, as the reference
does (``minddet_tpu/models/detectors/faster_rcnn.py:_anchors`` is numpy f32
under any compute dtype).

``build_faster_rcnn`` casts the whole model to bf16; the anchors must come
through bit for bit equal to ``multilevel_anchors``' f32 grid (at 512², 65,472
anchors, a bf16 rounding moved 67 % of their coordinates by up to 2 px), and
the bf16 model's ``proposals`` on f32 logits and deltas must equal the f32
model's. Built, not run: no forward of the full-size model on the CPU.
"""

import numpy as np
import pytest
import torch

from minddet_tpu.ops.anchors2d import multilevel_anchors as j_anchors
from minddet_tpu_torch.entry import RES, build_faster_rcnn
from minddet_tpu_torch.ops.anchors2d import multilevel_anchors


@pytest.fixture(scope="module")
def models():
    return (build_faster_rcnn("cpu", dtype=torch.bfloat16),
            build_faster_rcnn("cpu", dtype=torch.float32))


def test_bf16_model_keeps_f32_anchors(models):
    bf16, f32 = models
    assert next(bf16.parameters()).dtype == torch.bfloat16
    want = multilevel_anchors((RES, RES), bf16.strides)
    np.testing.assert_array_equal(want, np.asarray(j_anchors((RES, RES),
                                                             bf16.strides)))
    for model in (bf16, f32):
        assert model.anchors.dtype == torch.float32
        assert model.anchors.shape == (65472, 4)
        np.testing.assert_array_equal(model.anchors.numpy(), want)
    # what a bf16 rounding would have done to them
    assert not np.array_equal(
        torch.from_numpy(want).bfloat16().float().numpy(), want)
    assert "anchors" not in bf16.state_dict()


def test_bf16_model_proposals_equal_the_f32_models(models):
    """The same f32 RPN logits and deltas through both models'
    ``proposals``: boxes, scores and NMS passes equal."""
    bf16, f32 = models
    a = f32.anchors.shape[0]
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, a, generator=gen) * 2
    deltas = torch.randn(2, a, 4, generator=gen) * 0.2
    with torch.inference_mode():
        got = bf16.proposals(logits, deltas)
        want = f32.proposals(logits, deltas)
    for g, w in zip(got, want):
        if torch.is_tensor(w):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
        else:
            assert g == w
    assert float(want[0].abs().sum()) > 0
