"""The port's COCO evaluation path vs the JAX package's, on the CPU.

- ``soft_nms``: Gaussian and linear decay against the reference vmapped
  over sets of random boxes (duplicates included, so the linear decay
  meets an IoU of 1), on tied scores (the first index wins, as
  ``jnp.argmax``), with every score under the threshold, and with
  ``top_k`` below N: the order exactly, the rescored scores to 1e-6
  relative (exp and the decays' products in f32, in another order).
- ``_soft_nms_per_class``: the same boxes, labels and scores to 1e-6
  relative, a class past ``cap`` included.
- ``COCOEvaluator``: every case of ``tests/test_coco_eval.py`` (hand
  derived) and of ``tests/test_coco_eval_oracle.py`` (random fixtures,
  crowd, ties, maxDets, segm) run through both evaluators fed the same
  inputs: the 12 numbers equal to 1e-12, and the case's own assertions
  held by the port's numbers.
- ``coco_evaluate`` and ``centernet_evaluate``: one tiny CenterNet
  (depth 18, DCN, 3 classes, random offset convs and BN) carried across by
  ``centernet_from_flax``, f32, on JPEG records of 5 images (60-200 px;
  ``coco_evaluate`` at 128 x 128 in batches of 4, the second padded, and
  ``centernet_evaluate`` in two keep-res buckets, (128, 128) of 3 images
  and (128, 256) of 2, each batch of 4 padded): the predictions each
  evaluation scores, image by image (labels equal, boxes to 1e-3 px,
  scores to 1e-4: the heads agree to 1e-4, ``tests/
  test_torch_centernet.py``), and the 12 numbers to 1e-9. The reference's
  predict is compiled once for both cases (``_JaxWithOnePredict``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_coco_eval
import test_coco_eval_oracle
import torch
from test_torch_centernet import randomize_flax

from minddet_tpu.data import coco_eval as jcoco_eval
from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu.ops.nms import soft_nms as j_soft_nms
from minddet_tpu.train import evaluate as jevaluate
from minddet_tpu_torch.data import coco_eval
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.ops.nms import soft_nms
from minddet_tpu_torch.train import evaluate
from minddet_tpu_torch.utils.convert import centernet_from_flax

CLASSES = 3
REF_EVALUATOR = jcoco_eval.COCOEvaluator  # before any case swaps it out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets(seed, sets=3, n=24):
    """Random boxes (sets, n, 4) in clusters (so that they overlap), a few
    exact duplicates, distinct scores in (0, 1)."""
    rs = np.random.RandomState(seed)
    ctr = rs.uniform(20, 80, (sets, 4, 2))[:, rs.randint(0, 4, n)]
    xy = ctr + rs.randn(sets, n, 2) * 4
    wh = rs.uniform(10, 30, (sets, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 5] = boxes[:, 2]
    boxes[:, n - 1] = boxes[:, 7]
    scores = rs.permutation(np.linspace(0.05, 0.95, sets * n)).reshape(
        sets, n).astype(np.float32)
    return boxes, scores


def _reference(boxes, scores, **kw):
    out, order = jax.vmap(lambda b, s: j_soft_nms(b, s, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(out), np.asarray(order)


def _hold(boxes, scores, **kw):
    want, want_order = _reference(boxes, scores, **kw)
    got, order = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          **kw)
    assert order.dtype == torch.int32 and order.shape == want_order.shape
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    return got.numpy(), order.numpy()


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_matches_the_reference(method):
    boxes, scores = _sets(0)
    got, order = _hold(boxes, scores, method=method, sigma=0.5,
                       iou_threshold=0.3, score_threshold=1e-3)
    assert (got > 0).sum() > 10 and (order >= 0).any(axis=1).all()
    _hold(boxes, scores, method=method, score_threshold=0.2, top_k=7)


def test_soft_nms_ties_and_scores_under_the_threshold():
    boxes, _ = _sets(1, sets=2, n=10)
    tied = np.full((2, 10), 0.5, np.float32)
    tied[1, 4:] = 0.0  # empty slots score 0 and never come alive
    for method in ("gaussian", "linear"):
        got, order = _hold(boxes, tied, method=method)
        assert order[0, 0] == 0  # the first of the tied maxima
        assert (got[1, 4:] == 0).all()
    low = np.full((2, 10), 5e-4, np.float32)
    got, order = _hold(boxes, low)
    assert (got == 0).all() and (order == -1).all()


def test_soft_nms_per_class_matches_the_reference():
    rs = np.random.RandomState(2)
    n = 40
    boxes, scores = _sets(3, sets=1, n=n)
    labels = rs.randint(0, 5, n)
    labels[:12] = 2  # more than the cap
    want = jevaluate._soft_nms_per_class(boxes[0], scores[0], labels, 5,
                                         cap=8)
    got = evaluate._soft_nms_per_class(boxes[0], scores[0], labels, 5, cap=8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == np.float32 and got[2].dtype == np.int64
    assert (got[2] == 2).sum() <= 8


class _Twin:
    """An evaluator fed to both packages' ``COCOEvaluator``: ``summarize``
    holds the port's 12 numbers to the reference's (1e-12) and returns the
    port's."""

    compared = 0

    def __init__(self, class_ids):
        self.ref = REF_EVALUATOR(class_ids)
        self.port = coco_eval.COCOEvaluator(class_ids)

    def add(self, *args, **kwargs):
        self.ref.add(*args, **kwargs)
        self.port.add(*args, **kwargs)

    def summarize(self):
        want, got = self.ref.summarize(), self.port.summarize()
        assert list(got) == list(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
        _Twin.compared += 1
        return got


def _cases(module):
    return [getattr(module, n) for n in sorted(dir(module))
            if n.startswith("test_")]


def _param(fn):
    return pytest.param(fn, id=f"{fn.__module__}.{fn.__name__}")


@pytest.mark.parametrize(
    "case", [_param(f) for f in _cases(test_coco_eval)]
    + [_param(f) for f in _cases(test_coco_eval_oracle)])
def test_coco_evaluator_matches_the_reference(case, monkeypatch):
    """Each evaluator test of the reference, its ``COCOEvaluator`` swapped
    for ``_Twin`` (the module's own name and the one its cases import)."""
    for module in (jcoco_eval, test_coco_eval, test_coco_eval_oracle):
        monkeypatch.setattr(module, "COCOEvaluator", _Twin)
    before = _Twin.compared
    marks = getattr(case, "pytestmark", [])
    args = [m.args[1] for m in marks if m.name == "parametrize"]
    for values in (args[0] if args else [()]):
        case(*((values,) if args else ()))
    assert _Twin.compared > before


# ---------------------------------------------------------------------------
# coco_evaluate and centernet_evaluate on a tiny CenterNet
# ---------------------------------------------------------------------------

# keep-res buckets (128, 128) for the first, second and fourth, (128, 256)
# for the third and fifth
SIZES = ((64, 96), (72, 90), (100, 128), (110, 120), (60, 200))
COCO_HW = (128, 128)  # coco_evaluate's: the first bucket's program


@pytest.fixture(scope="module")
def coco_records(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("array_record")
    from minddet_tpu_torch.data.coco import convert_coco_to_records
    from test_torch_coco_data import make_coco

    root = tmp_path_factory.mktemp("coco_eval")
    ann, imgs = make_coco(root, cv2, SIZES, CLASSES)
    convert_coco_to_records(ann, imgs, str(root / "rec"))
    return str(root / "rec-*.arrayrecord")


@pytest.fixture(scope="module")
def tiny_centernet():
    """Random offset convs and BN (``randomize_flax``); the stem's kernel
    / 100, since both packages' evaluations feed the canvas unnormalized,
    in [0, 255]; the wh head's kernel x 0.01 and bias 3 (boxes ~12 px, so
    neighbours overlap and soft-NMS decays them); per-class heatmap
    biases; and the reference's predict, jitted once."""
    jmodel = JaxCenterNet(num_classes=CLASSES, depth=18, dcn=True)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = randomize_flax(variables, seed=3)
    params = variables["params"]
    stem = params["backbone"]["conv1"]
    stem["kernel"] = stem["kernel"] / 100
    wh = params["head"]["wh"]["out"]
    wh["kernel"] = wh["kernel"] * 0.01
    wh["bias"] = wh["bias"] + 3.0
    params["head"]["hm"]["out"]["bias"] = np.array([-2.0, -2.19, -2.1],
                                                   np.float32)
    tmodel = centernet_from_flax(CenterNet(num_classes=CLASSES).eval(),
                                 variables)
    predict = jax.jit(lambda image: jmodel.apply(variables, image,
                                                  method=jmodel.predict))
    return jmodel, variables, tmodel, predict


class _JaxWithOnePredict:
    """``jax`` as the reference's evaluation module sees it, except that
    ``jit`` hands back ``predict``, jitted once for the module. The
    reference's ``centernet_evaluate`` jits a new closure of the same
    ``model.apply(variables, image, method=model.predict)`` in every call,
    so each call would compile its buckets again."""

    def __init__(self, predict):
        self.predict, self.jitted = predict, 0

    def jit(self, fn):
        self.jitted += 1
        return self.predict

    def __getattr__(self, name):
        return getattr(jax, name)


def _captured(monkeypatch, module):
    """The predictions each ``evaluate_coco_detections`` call of
    ``module`` scores."""
    seen = []
    real = module.evaluate_coco_detections

    def keep(ds, predictions, *args, **kwargs):
        seen.append(predictions)
        return real(ds, predictions, *args, **kwargs)

    monkeypatch.setattr(module, "evaluate_coco_detections", keep)
    return seen


def _hold_predictions(got, want):
    """Image by image, a one-to-one match: each reference detection to the
    port's of its label with the nearest box, within 1e-3 px, its score
    within 1e-4 (the order of near-equal scores may differ). Returns the
    detections matched and the share whose score soft-NMS decayed."""
    assert sorted(got) == sorted(want)
    kept = decayed = 0
    for img in want:
        g = {k: np.asarray(v) for k, v in got[img].items()}
        w = {k: np.asarray(v) for k, v in want[img].items()}
        assert len(g["scores"]) == len(w["scores"])
        free = np.ones(len(g["scores"]), bool)
        for i in np.argsort(-w["scores"], kind="stable"):
            dist = np.abs(g["boxes"] - w["boxes"][i]).max(axis=1)
            dist[~free | (g["labels"] != w["labels"][i])] = np.inf
            j = int(np.argmin(dist))
            assert dist[j] <= 1e-3, (img, i, dist[j])
            assert abs(g["scores"][j] - w["scores"][i]) <= 1e-4
            free[j] = False
        kept += len(w["scores"])
    return kept


def _hold_stats(got, want):
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


@pytest.mark.parametrize("kind", ["coco_evaluate", "centernet_evaluate"])
def test_coco_evaluations_match_the_reference(kind, coco_records,
                                              tiny_centernet, monkeypatch):
    jmodel, variables, tmodel, jpredict = tiny_centernet
    shared = _JaxWithOnePredict(jpredict)
    monkeypatch.setattr(jevaluate, "jax", shared)
    want_preds = _captured(monkeypatch, jevaluate)
    got_preds = _captured(monkeypatch, evaluate)
    inputs = []
    predict = tmodel.predict

    def keep(image, *args, **kwargs):
        inputs.append(float(image.max()))
        return predict(image, *args, **kwargs)

    monkeypatch.setattr(tmodel, "predict", keep)
    if kind == "coco_evaluate":
        want = jevaluate.coco_evaluate(jmodel, variables, coco_records,
                                       COCO_HW, CLASSES, batch_size=4,
                                       predict_fn=jpredict)
        got = evaluate.coco_evaluate(tmodel, coco_records, COCO_HW,
                                     CLASSES, batch_size=4)
    else:
        want = jevaluate.centernet_evaluate(jmodel, variables, coco_records,
                                            num_classes=CLASSES)
        timings = {}
        got = evaluate.centernet_evaluate(tmodel, coco_records,
                                          num_classes=CLASSES,
                                          timings=timings)
        assert sorted(timings) == ["copy", "evaluate", "load", "predict",
                                   "soft_nms", "warp"]
        assert shared.jitted == 1
    kept = _hold_predictions(got_preds[0], want_preds[0])
    assert kept >= len(SIZES) * 20
    _hold_stats(got, want)
    # the canvas reaches the model unnormalized, in [0, 255], as in the
    # reference (whose predictions these match); the train path normalizes
    assert max(inputs) > 200
