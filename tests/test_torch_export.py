"""``train/export.py`` and ``evaluate --exported`` on the CPU, against the
JAX package's ``jax.export`` programs.

- A small function's program round trip (``tests/test_entrypoints.py``'s).
- A tiny CenterNet (depth 18, DCN in its neck: nine K1f op nodes, 4
  classes, 64 x 64, flax weights randomized as ``test_torch_centernet.py``
  does): the reloaded program gives the live predict bit for bit, and the
  reference's reloaded program within the CenterNet comparisons' tolerance
  (classes exact, atol 1e-4: some 20 f32 conv layers summed in another
  order than XLA's).
- The tiny two-stage CenterPoint of ``test_torch_centerpoint.py`` (calibrated
  heads) exported by ``export_detector_3d(refined=True, nms_pre=32,
  nms_post=8)``, ``tests/test_two_stage.py``'s round trip: the graph holds
  the K5f, K4 and K3f ops; the reloaded program gives the live one bit for
  bit (the NMS's passes as a tensor, from its ``while_loop``), and the
  reference's reloaded program within 1e-5, as the reference's own round
  trip is held (labels exact; 1.2e-6 apart at most when written).
- ``coco_evaluate`` with a reloaded program (``predict_fn``) on
  ``tests/test_coco_pipeline.py``'s records gives the in-memory model's
  statistics exactly, and ``exported_evaluate`` reads the batch and
  resolution from the artifact and refuses a program whose input is not
  (B, H, W, 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coco_pipeline import _make_coco
from test_torch_centernet import randomize_flax
from test_torch_centerpoint import TINY as CP_TINY
from test_torch_centerpoint import _clouds, _cp_variables

from minddet_tpu.models.detectors.centernet import CenterNet as JCenterNet
from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCenterPointTwoStage)
from minddet_tpu.train import export as jexport
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.detectors.centerpoint import CenterPointTwoStage
from minddet_tpu_torch.train import evaluate as tevaluate
from minddet_tpu_torch.train import export as texport
from minddet_tpu_torch.utils.convert import (centernet_from_flax,
                                             centerpoint_from_flax)

REFINED = dict(nms_pre=32, nms_post=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_export_roundtrip(tmp_path):
    def fn(x):
        return {"y": torch.tanh(x) * 2.0}

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8)
                         .astype(np.float32))
    path = texport.export_predict_fn(fn, (x,), str(tmp_path / "m.pt2"))
    assert (tmp_path / "m.pt2").stat().st_size > 100
    out = texport.load_exported(path)(x)
    np.testing.assert_allclose(out["y"].numpy(), np.tanh(x.numpy()) * 2.0,
                               atol=1e-6)


def test_centernet_program_matches_live_and_the_reference(tmp_path):
    jmodel = JCenterNet(num_classes=4, depth=18, dcn=True)
    variables = randomize_flax(jax.jit(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False))(
            jnp.zeros((1, 64, 64, 3))))  # jitted: eager init takes ~25 s
    tmodel = centernet_from_flax(CenterNet(num_classes=4).eval(), variables)
    image = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    path = texport.export_detector(tmodel, torch.from_numpy(image),
                                   str(tmp_path / "cn.pt2"))
    ep = torch.export.load(path)
    assert texport.exported_ops(ep) == {"TapsSample": 9}
    fn, specs = texport.load_exported_program(path)
    assert [tuple(s.shape) for s in specs] == [(2, 64, 64, 3)]
    got = fn(torch.from_numpy(image))
    assert torch.equal(got, tmodel.predict(torch.from_numpy(image)))
    jpath = jexport.export_detector(jmodel, variables, jnp.asarray(image),
                                    str(tmp_path / "cn.stablehlo"))
    ref = np.asarray(jexport.load_exported(jpath)(jnp.asarray(image)))
    assert got.shape == ref.shape == (2, 100, 6)
    np.testing.assert_array_equal(got[..., 5].numpy(), ref[..., 5])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_two_stage_program_matches_live_and_the_reference(tmp_path):
    jm = JCenterPointTwoStage(**CP_TINY, num_proposals=16)
    pts, mask = _clouds()
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jp, jmask, method=jm.predict_refined))
    variables = _cp_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, 3, pts, mask)
    port = centerpoint_from_flax(CenterPointTwoStage(**CP_TINY).eval(),
                                 variables)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    path = texport.export_detector_3d(port, tp, tm, str(tmp_path / "cp.pt2"),
                                      refined=True, **REFINED)
    ops = texport.exported_ops(torch.export.load(path))
    assert ops == {"SegFullMax": 1, "RotatedIntersectionBev": 1,
                   "BilinearGather": 1}
    got = texport.load_exported(path)(tp, tm)
    live = port.predict_refined(tp, tm, **REFINED)
    for k in ("boxes", "scores", "labels"):
        assert torch.equal(got[k], live[k]), k
    assert int(got["nms_passes"]) == live["nms_passes"] > 1
    jpath = jexport.export_detector_3d(jm, variables, jp, jmask,
                                       str(tmp_path / "cp.stablehlo"),
                                       refined=True, **REFINED)
    ref = jax.device_get(jexport.load_exported(jpath)(jp, jmask))
    assert got["boxes"].shape == ref["boxes"].shape == (2, 16, 9)
    valid = ref["labels"] >= 0
    assert valid.sum() > 4
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_exported_coco_evaluation_is_the_in_memory_one(tmp_path):
    ann, imgs = _make_coco(tmp_path)
    from minddet_tpu_torch.data.coco import convert_coco_to_records

    convert_coco_to_records(ann, imgs, str(tmp_path / "rec"))
    records = str(tmp_path / "rec-*.arrayrecord")
    model = CenterNet(num_classes=3, depth=18, dcn=False).init_weights(
        torch.Generator().manual_seed(0)).eval()
    path = texport.export_detector(model, torch.zeros(4, 64, 64, 3),
                                   str(tmp_path / "cn.pt2"))
    ref = tevaluate.coco_evaluate(model, records, (64, 64), 3, batch_size=4)
    fn, specs = texport.load_exported_program(path)
    assert tuple(specs[0].shape) == (4, 64, 64, 3)
    off = tevaluate.coco_evaluate(None, records, (64, 64), 3, batch_size=4,
                                  predict_fn=fn, device="cpu")
    assert ref.keys() == off.keys() and {"AP", "AP50"} <= set(ref)
    for k in ref:
        assert ref[k] == off[k], (k, ref[k], off[k])
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model:\n  type: CenterNet\n  num_classes: 3\n"
                   "  depth: 18\n  dcn: false\ntrain:\n  image_hw: [64, 64]\n")
    assert tevaluate.exported_evaluate(str(cfg), records, path,
                                       device="cpu") == ref
    flat = texport.export_predict_fn(lambda x: x * 2, (torch.zeros(4, 8),),
                                     str(tmp_path / "flat.pt2"))
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        tevaluate.exported_evaluate(str(cfg), records, flat, device="cpu")
    with pytest.raises(ValueError, match="device"):
        tevaluate.coco_evaluate(None, records, (64, 64), 3, predict_fn=fn)


def test_new_modules_are_walked_by_the_isolation_probe():
    """The modules this slice adds are among those the import probe of
    ``test_torch_isolation.py`` walks (it imports every module of the port
    and fails on any import of jax or the JAX package)."""
    import pkgutil

    import minddet_tpu_torch

    walked = {m.name for m in pkgutil.walk_packages(
        minddet_tpu_torch.__path__, "minddet_tpu_torch.")}
    assert {f"minddet_tpu_torch.{m}" for m in (
        "train.export", "train.infer", "utils.visual",
        "tools.create_data")} <= walked
