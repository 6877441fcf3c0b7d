"""The port's train and evaluate CLIs on the CPU (``--device cpu``).

- ``train.main`` end to end on a tiny CenterNet YAML (depth 18, DCN, 4
  classes, 64 x 64, batch 2): with ``--synthetic``, and on COCO records
  (``convert_coco_to_records``, ``write_records`` under it; staged by
  ``--data-url`` into the workdir, the workdir mirrored by
  ``--train-url``); both write metrics.jsonl with
  the reference Trainer's keys (``tests/test_torch_trainer.py`` holds them
  against the reference's own file) and a checkpoint at the forced last
  step.
- ``--resume``: 2 steps, then 1 more, equals 3 straight bit for bit
  (parameters, BN statistics, Adam's state, the counts, and the third
  step's metrics record).
- ``--resume`` skips the batches the checkpoint's steps drew, where the
  reference's CLI draws its stream from the start again (``ROADMAP.md``
  §3): after a checkpoint at step 2 the port's next step trains on the
  fourth draw (the sample, then steps 1-2), the reference's on the second.
- A config with ``train.fsdp`` > 1 raises, naming the ROADMAP item it
  waits for.
- ``evaluate --exported`` on a reloaded program of the tiny CenterNet gives
  the in-memory model's statistics exactly and the reference's exported
  program's within 1e-6.
- ``evaluate.main`` on a tiny CenterNet's checkpoint and JPEG records
  gives the reference evaluator's statistics on the same weights and
  records within 1e-6, by the CenterNet protocol (derived from the
  config) and the fixed-resolution COCO one, both with ``--max-images``
  cutting the predicted images (the reference's ``max_images``).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from test_torch_coco_eval import (COCO_HW, CLASSES, _captured,
                                  _hold_predictions, _JaxWithOnePredict,
                                  coco_records, tiny_centernet)  # noqa: F401

from minddet_tpu.train import evaluate as jevaluate
from minddet_tpu_torch.core.checkpoint import load_pytree, save_pytree
from minddet_tpu_torch.train import evaluate as tevaluate
from minddet_tpu_torch.train import train as ttrain

# the reference Trainer's record keys for CenterNet (its loss parts)
CENTERNET_KEYS = {"step", "time", "loss", "hm_loss", "wh_loss", "off_loss",
                  "grad_norm", "img_per_sec"}
TINY = {
    "model": {"type": "CenterNet", "num_classes": 4, "depth": 18,
              "dcn": True, "head_conv": 64},
    "train": {"image_hw": [64, 64], "batch_size": 2, "total_steps": 10,
              "log_every": 1, "save_every": 100,
              "optimizer": {"type": "adam", "clip_global_norm": 35.0},
              "lr_schedule": {"type": "multi_epochs_decay",
                              "learning_rate": 5e-4, "milestones": [1],
                              "steps_per_epoch": 2}},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaml(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train(config, workdir, *extra):
    return ttrain.main(["--config", config, "--workdir", str(workdir),
                        "--device", "cpu", *extra])


def test_train_main_synthetic_and_resume(tmp_path):
    config = _yaml(tmp_path / "tiny.yaml", TINY)
    straight = _train(config, tmp_path / "a", "--synthetic", "--steps", "3")
    recs = _records(tmp_path / "a")
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(set(r) == CENTERNET_KEYS for r in recs)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs)
    assert os.listdir(tmp_path / "a" / "ckpt") == ["3"]
    saved = load_pytree(str(tmp_path / "a" / "ckpt" / "3"))
    assert saved["step"] == 3 and set(saved) == {"model", "optimizer",
                                                 "step"}
    _train(config, tmp_path / "b", "--synthetic", "--steps", "2")
    resumed = _train(config, tmp_path / "b", "--synthetic", "--steps", "1",
                     "--resume")
    assert resumed.step == straight.step == 3
    a, b = resumed.state_dict(), straight.state_dict()
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for i, st in b["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(a["optimizer"]["state"][i][k], v), (i, k)
    for g, h in zip(a["optimizer"]["param_groups"],
                    b["optimizer"]["param_groups"]):
        assert torch.equal(g["count"], h["count"])
        assert torch.equal(g["lr"], h["lr"])
    third = _records(tmp_path / "b")[-1]
    assert third["step"] == 3
    assert {k: v for k, v in third.items() if k not in ("time",
                                                        "img_per_sec")} == \
        {k: v for k, v in recs[-1].items() if k not in ("time",
                                                        "img_per_sec")}


def test_train_main_on_records_with_staging(coco_records, tmp_path):  # noqa: F811
    src = os.path.dirname(coco_records)
    cfg = dict(TINY, data={"records": "elsewhere/" + os.path.basename(
        coco_records), "max_objs": 16, "workers": 1})
    config = _yaml(tmp_path / "rec.yaml", cfg)
    work, mirror = tmp_path / "w", tmp_path / "mirror"
    state = _train(config, work, "--steps", "2", "--data-url", src,
                   "--train-url", str(mirror))
    assert state.step == 2
    recs = _records(work)
    assert [r["step"] for r in recs] == [1, 2]
    assert all(set(r) == CENTERNET_KEYS for r in recs)
    assert np.isfinite(recs[-1]["loss"])
    assert sorted(os.listdir(work / "data")) == sorted(os.listdir(src))
    assert sorted(os.listdir(mirror)) == ["ckpt", "metrics.jsonl"]


class _FirstBatch:
    """A Trainer that records the first batch's draw index and its
    ``start_step`` and trains nothing."""
    seen = {}

    def __init__(self, state, *args, **kwargs):
        self.state = state

    def fit(self, batches, num_steps=None, batch_size=None, start_step=0):
        _FirstBatch.seen.update(step=int(next(iter(batches))["step"]),
                                start=int(start_step))
        return self.state


def test_resume_skips_what_the_reference_replays(tmp_path, monkeypatch):
    from minddet_tpu.train import train as jtrain

    config = _yaml(tmp_path / "tiny.yaml", TINY)
    _train(config, tmp_path / "t", "--synthetic", "--steps", "2")
    monkeypatch.setattr(ttrain, "Trainer", _FirstBatch)
    _train(config, tmp_path / "t", "--synthetic", "--steps", "1",
           "--resume")
    assert _FirstBatch.seen == {"step": 4, "start": 2}

    class Model:  # the reference's main with its model, init and
        def init(self, rngs, sample, method=None):  # checkpoints stubbed
            return {"params": {"w": np.zeros(2, np.float32)}}

        def loss_from_gt(self, *args, **kwargs):
            raise AssertionError("not trained")

    class Checkpoints:
        def __init__(self, *args, **kwargs):
            pass

        def latest_step(self):
            return 2

        def restore(self, template):
            return dict(template, step=2)

    monkeypatch.setattr(jtrain.DETECTORS, "build", lambda cfg: Model())
    monkeypatch.setattr(jtrain, "CheckpointManager", Checkpoints)
    monkeypatch.setattr(jtrain, "Trainer", _FirstBatch)
    jtrain.main(["--config", config, "--synthetic", "--steps", "1",
                 "--resume", "--workdir", str(tmp_path / "j")])
    assert _FirstBatch.seen == {"step": 2, "start": 2}


def test_cli_refusals(tmp_path):
    config = _yaml(tmp_path / "fsdp.yaml",
                   dict(TINY, train=dict(TINY["train"], fsdp=2)))
    with pytest.raises(NotImplementedError, match="item 7"):
        _train(config, tmp_path / "w", "--synthetic", "--steps", "1")


def test_evaluate_exported_matches_the_reference(coco_records,  # noqa: F811
                                                 tiny_centernet,  # noqa: F811
                                                 tmp_path, monkeypatch):
    """``--exported``: the tiny CenterNet's program, exported at batch 4 by
    ``export_detector`` and reloaded, evaluated at the artifact's batch and
    resolution, gives the in-memory model's statistics exactly and the
    reference's (its reloaded ``jax.export`` program through
    ``predict_fn``) within 1e-6, on the same predictions
    (``_hold_predictions``); a program exported on another device than
    ``--device`` is refused."""
    from minddet_tpu.train.export import export_detector as j_export
    from minddet_tpu.train.export import load_exported as j_load
    from minddet_tpu_torch.train.export import export_detector

    jmodel, variables, tmodel, _ = tiny_centernet
    want_preds = _captured(monkeypatch, jevaluate)
    got_preds = _captured(monkeypatch, tevaluate)
    config = _yaml(tmp_path / "eval.yaml", {
        "model": {"type": "CenterNet", "num_classes": CLASSES, "depth": 18,
                  "dcn": True},
        "train": {"image_hw": [64, 64]}})
    image = torch.zeros(4, *COCO_HW, 3)
    path = export_detector(tmodel, image, str(tmp_path / "cn.pt2"))
    got = tevaluate.main(["--config", config, "--records", coco_records,
                          "--exported", path, "--max-images", "4",
                          "--device", "cpu"])
    live = tevaluate.coco_evaluate(tmodel, coco_records, COCO_HW, CLASSES,
                                   batch_size=4, max_images=4)
    assert got == live
    jpath = j_export(jmodel, variables, image.numpy(),
                     str(tmp_path / "cn.stablehlo"))
    want = jevaluate.coco_evaluate(jmodel, variables, coco_records, COCO_HW,
                                   CLASSES, batch_size=4, max_images=4,
                                   predict_fn=j_load(jpath))
    assert len(got_preds[0]) == len(want_preds[0]) == 4
    assert _hold_predictions(got_preds[0], want_preds[0]) >= 4 * 20
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    with pytest.raises(ValueError, match="exported on cpu"):
        tevaluate.exported_evaluate(config, coco_records, path,
                                    device="meta")


@pytest.mark.parametrize("protocol", ["centernet", "coco"])
def test_evaluate_main_matches_the_reference(protocol, coco_records,  # noqa: F811
                                             tiny_centernet,  # noqa: F811
                                             tmp_path, monkeypatch):
    jmodel, variables, tmodel, jpredict = tiny_centernet
    monkeypatch.setattr(jevaluate, "jax", _JaxWithOnePredict(jpredict))
    want_preds = _captured(monkeypatch, jevaluate)
    got_preds = _captured(monkeypatch, tevaluate)
    config = _yaml(tmp_path / "eval.yaml", {
        "model": {"type": "CenterNet", "num_classes": CLASSES, "depth": 18,
                  "dcn": True},
        "train": {"image_hw": list(COCO_HW)}})
    ckpt = str(tmp_path / "ckpt" / "3")
    save_pytree(ckpt, {"model": tmodel.state_dict(), "step": 3})
    argv = ["--config", config, "--records", coco_records, "--checkpoint",
            ckpt, "--max-images", "4", "--device", "cpu"]
    if protocol == "coco":
        got = tevaluate.main(argv + ["--protocol", "coco"])
        want = jevaluate.coco_evaluate(jmodel, variables, coco_records,
                                       COCO_HW, CLASSES, max_images=4,
                                       predict_fn=jpredict)
    else:  # derived from the config's model
        got = tevaluate.main(argv)
        want = jevaluate.centernet_evaluate(jmodel, variables, coco_records,
                                            num_classes=CLASSES,
                                            max_images=4)
    # the first 4 of the 6 images predicted on both sides, detection by
    # detection (``_hold_predictions``: boxes 1e-3 px, scores 1e-4)
    assert len(got_preds[0]) == len(want_preds[0]) == 4
    assert _hold_predictions(got_preds[0], want_preds[0]) >= 4 * 20
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
