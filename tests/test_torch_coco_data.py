"""The port's COCO data path vs the JAX package's, on the CPU.

- Records: a COCO folder (JPEGs written with cv2, polygon and RLE
  segmentations, a crowd box, a zero-width box, an image without boxes)
  converted by both packages: the shards read equal in both, and
  ``coco_examples`` yields the same records.
- ``CocoDetection``: equal to the reference's example by example (the
  canvas, boxes, labels, mask, the GT bitmaps at 1/4, the raw fields), also
  with images larger than the canvas (scaled down with cv2 on the host);
  records in memory with decoded images give the shards' examples, and
  need no cv2.
- ``GroupSampler`` and ``aspect_flags``: index for index, epochs and
  shards.
- ``rasterize_polygons``, ``paste_masks_to_image``, ``example_gt_bitmaps``
  exactly, and ``evaluate_coco_detections`` (bbox and segm) to 1e-12.
- ``coco_batches``, both routes and the mask branch, at one loader thread:
  the reference's batches against ``coco_device_batch`` on the same raw
  batches with the reference's draws (``jax.random.fold_in(key, step)``
  split as the reference splits it), to the tolerances of
  ``tests/test_torch_transforms.py``; the port's own ``coco_batches`` is
  ``coco_device_batch`` on its generator's draws.
- The two entries (``centernet_coco_train_entry``,
  ``centernet_eval_entry``) at a cut size on the CPU: the config's
  optimizer and schedule, finite losses, the 12 numbers.
Every test here skips without ``cv2`` or ``array_record``.
"""

import json
import math
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_transforms import (BOX_TOL, jax_mixup_draws,
                                   jax_mosaic_draws,
                                   jax_train_transform_draws)

cv2 = pytest.importorskip("cv2")
pytest.importorskip("array_record")

from minddet_tpu.core.config import Config  # noqa: E402
from minddet_tpu.data import coco as jcoco  # noqa: E402
from minddet_tpu.data import loader as jloader  # noqa: E402
from minddet_tpu.data import records as jrecords  # noqa: E402
from minddet_tpu.train.train import coco_batches as j_coco_batches  # noqa
from minddet_tpu_torch.data import coco, loader, records  # noqa: E402
from minddet_tpu_torch.train import synthetic  # noqa: E402

SIZES = ((80, 100), (88, 104), (120, 90), (96, 112), (70, 70))
CLASSES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_coco(root, cv2, sizes, classes=CLASSES, seed=0):
    """A COCO folder under ``root``: one JPEG per size (uniform noise),
    3-4 boxes each with polygon segmentations (the reference tests'
    ``_make_coco``), category ids 1, 3, 7...; the first image also gets a
    crowd box with an uncompressed RLE and a zero-width box, and one more
    image has no annotation. Returns (annotation file, image folder)."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(seed)
    cat_ids = [1 + 2 * c + c // 2 for c in range(classes)]
    images, annotations = [], []

    def add(image_id, bbox, cat, crowd=0, seg=None):
        x, y, w, h = bbox
        annotations.append({
            "id": len(annotations) + 1, "image_id": image_id,
            "bbox": [float(v) for v in bbox], "category_id": cat,
            "iscrowd": crowd, "area": float(w * h),
            "segmentation": seg if seg is not None else [
                [x, y, x + w, y, x + w, y + h, x, y + h]]})

    for i, (h, w) in enumerate(list(sizes) + [(40, 50)]):
        name = f"{i:012d}.jpg"
        cv2.imwrite(str(img_dir / name),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        if i == len(sizes):
            continue  # no annotation: skipped
        for _ in range(rng.randint(3, 5)):
            x, y = rng.uniform(0, w - 30), rng.uniform(0, h - 30)
            add(i + 1, [x, y, rng.uniform(10, 25), rng.uniform(10, 25)],
                int(rng.choice(cat_ids)))
        if i == 0:
            counts = [5 * h, 10 * h, (w - 15) * h]  # columns 5-14 set
            add(1, [5, 0, 10, h], cat_ids[0], crowd=1,
                seg={"counts": counts, "size": [h, w]})
            add(1, [3, 3, 0, 5], cat_ids[0])
    cats = [{"id": c, "name": f"c{c}"} for c in cat_ids]
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps({"images": images,
                                    "annotations": annotations,
                                    "categories": cats}))
    return str(ann_file), str(img_dir)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, imgs = make_coco(root, cv2, SIZES)
    paths = coco.convert_coco_to_records(ann, imgs, str(root / "port"),
                                         shard_size=3, with_masks=True)
    ref_paths = jcoco.convert_coco_to_records(ann, imgs, str(root / "ref"),
                                              shard_size=3, with_masks=True)
    return dict(ann=ann, imgs=imgs, paths=paths, ref_paths=ref_paths,
                pattern=str(root / "port-*.arrayrecord"))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], bytes):
            assert got[k] == want[k], k
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_records_and_examples_match_the_reference(coco_root):
    ann, imgs = coco_root["ann"], coco_root["imgs"]
    want = list(jcoco.coco_examples(ann, imgs, with_masks=True))
    got = list(coco.coco_examples(ann, imgs, with_masks=True))
    assert len(got) == len(want) == len(SIZES)  # the empty image skipped
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert len(got[0]["boxes"]) == len(want[0]["boxes"])  # zero width out
    assert got[0]["iscrowd"].sum() == 1
    mine, ref = (records.RecordDataset(coco_root["pattern"]),
                 jrecords.RecordDataset(coco_root["ref_paths"]))
    mine_of_ref = records.RecordDataset(coco_root["ref_paths"])
    assert len(mine) == len(ref) == len(mine_of_ref) == len(SIZES)
    for i in range(len(SIZES)):
        _assert_same(mine[i], ref[i])
        _assert_same(mine_of_ref[i], ref[i])
    assert coco.category_mapping([{"id": 7}, {"id": 1}]) == \
        jcoco.category_mapping([{"id": 7}, {"id": 1}])


@pytest.mark.parametrize("max_hw,with_masks,keep_raw", [
    ((128, 128), True, True), ((64, 96), False, False)],
    ids=["canvas_masks_raw", "oversize"])
def test_coco_detection_matches_the_reference(coco_root, max_hw, with_masks,
                                              keep_raw):
    kw = dict(max_hw=max_hw, max_objs=6, keep_raw=keep_raw,
              with_masks=with_masks)
    got = coco.CocoDetection(coco_root["pattern"], **kw)
    want = jcoco.CocoDetection(coco_root["pattern"], **kw)
    assert len(got) == len(want) == len(SIZES)
    for i in range(len(SIZES)):
        _assert_same(got[i], want[i])
    ex = got[0]
    if with_masks:
        assert ex["bitmaps"].shape == (32, 32, 6) and ex["bitmaps"].any()
    else:  # the 80 x 100 image scaled down to 64 x 80
        assert list(ex["hw"]) == [64, 80]


def test_coco_detection_from_records_in_memory(coco_root, monkeypatch):
    """Records in memory, each with its decoded image under "image", give
    the shards' examples; without cv2 they still load, while a JPEG record
    raises at its decode."""
    shards = records.RecordDataset(coco_root["pattern"])
    in_memory = []
    for i in range(len(shards)):
        rec = dict(shards[i])
        rec["image"] = coco._decode_jpeg(rec.pop("jpeg"))
        in_memory.append(rec)
    kw = dict(max_hw=(128, 128), max_objs=6, keep_raw=True)
    from_shards = coco.CocoDetection(coco_root["paths"], **kw)
    want = [from_shards[i] for i in range(len(SIZES))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = coco.CocoDetection(in_memory, **kw)
    for i in range(len(SIZES)):
        _assert_same(got[i], want[i])
    with pytest.raises(ImportError):
        coco._decode_jpeg(shards[0]["jpeg"])
    assert "jpeg" not in in_memory[0]  # left as it was


@pytest.mark.parametrize("batch,shards", [(2, 1), (3, 2)])
def test_group_sampler_and_aspect_flags_match_the_reference(batch, shards):
    rs = np.random.RandomState(batch)
    hws = rs.randint(50, 200, (23, 2))
    flags = loader.aspect_flags(hws)
    np.testing.assert_array_equal(flags, jloader.aspect_flags(hws))
    assert flags.dtype == np.int64 and 0 < flags.sum() < len(flags)
    for shard in range(shards):
        got = loader.GroupSampler(flags, batch, shards, shard, seed=5)
        want = jloader.GroupSampler(flags, batch, shards, shard, seed=5)
        for epoch in range(3):
            g, w = got.epoch_indices(epoch), want.epoch_indices(epoch)
            np.testing.assert_array_equal(g, w)
            groups = flags[g.reshape(-1, batch)]
            assert (groups == groups[:, :1]).all()  # aspect-pure batches


def test_host_mask_utilities_and_evaluation_match_the_reference(coco_root):
    square = [[10, 10, 20, 10, 20, 20, 10, 20]]
    rle = {"counts": [0, 4, 12], "size": [4, 4]}
    for seg, hw in ((square, (32, 32)), (rle, (4, 4)), (rle, (8, 6))):
        np.testing.assert_array_equal(coco.rasterize_polygons(seg, *hw),
                                      jcoco.rasterize_polygons(seg, *hw))
    rs = np.random.RandomState(3)
    masks = rs.rand(5, 28, 28).astype(np.float32)
    boxes = np.array([[3.2, 4.7, 30.1, 20.0], [-5, -5, 10, 10],
                      [50, 50, 80, 70], [10, 10, 10.5, 30], [60, 2, 90, 9]])
    np.testing.assert_array_equal(
        coco.paste_masks_to_image(masks, boxes, 40, 64),
        jcoco.paste_masks_to_image(masks, boxes, 40, 64))
    rec = records.RecordDataset(coco_root["pattern"])[0]
    np.testing.assert_array_equal(coco.example_gt_bitmaps(rec, 8, (96, 128)),
                                  jcoco.example_gt_bitmaps(rec, 8, (96, 128)))
    ds = coco.CocoDetection(coco_root["pattern"], keep_raw=True)
    jds = jcoco.CocoDetection(coco_root["pattern"], keep_raw=True)
    preds = {}
    for i in range(len(ds.records)):
        r = ds.records[i]
        n = len(r["boxes"])
        h, w = r["hw"]
        jitter = rs.uniform(-3, 3, (n, 4))
        preds[int(r["image_id"])] = {
            "boxes": r["boxes"] + jitter, "scores": rs.rand(n),
            "labels": r["labels"],
            "masks": coco.paste_masks_to_image(
                0.45 + rs.rand(n, 28, 28), r["boxes"] + jitter, h, w)}
    for segm in (False, True):
        got = coco.evaluate_coco_detections(ds, preds, CLASSES, segm=segm)
        want = jcoco.evaluate_coco_detections(jds, preds, CLASSES, segm=segm)
        assert list(got) == list(want) and 0 < got["AP50"] <= 1
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def _jax_draws(aug, key, step, b):
    key_i = jax.random.fold_in(key, step)
    if aug == "mosaic":
        k1, k2 = jax.random.split(key_i)
        return {"mosaic": jax_mosaic_draws(k1, b),
                "mixup": jax_mixup_draws(k2, b)}
    return jax_train_transform_draws(key_i, b)


@pytest.mark.parametrize("aug,with_masks", [
    ("affine", False), ("affine", True), ("mosaic", False)],
    ids=["affine", "affine_masks", "mosaic"])
def test_coco_batches_match_the_reference(coco_root, aug, with_masks):
    b, out_hw, seed = 2, (48, 64), 3
    data = {"records": coco_root["pattern"], "max_objs": 6, "workers": 1,
            "with_masks": with_masks}
    want = j_coco_batches(Config.fromdict({"data": data}), b, out_hw,
                          seed=seed, aug=aug)
    ds = coco.CocoDetection(coco_root["pattern"], max_objs=6,
                            with_masks=with_masks)
    raws = loader.DataLoader(
        ds, b, sampler=loader.DistributedSampler(len(ds), seed=seed),
        num_workers=1)
    key = jax.random.PRNGKey(seed)
    for step, raw in zip(range(3), raws):  # an epoch is 2 batches
        w = next(want)
        g = synthetic.coco_device_batch(raw, _jax_draws(aug, key, step, b),
                                        out_hw, aug, with_masks, step=step,
                                        device="cpu")
        assert sorted(g) == sorted(w)
        assert int(g["step"]) == int(w["step"]) == step
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(w["image"]),
                                   rtol=0, atol=5e-5)
        np.testing.assert_allclose(g["gt_boxes"].numpy(),
                                   np.asarray(w["gt_boxes"]), **BOX_TOL)
        for k in ("gt_classes", "gt_mask"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        if with_masks:
            np.testing.assert_allclose(g["gt_bitmaps"].numpy(),
                                       np.asarray(w["gt_bitmaps"]), rtol=0,
                                       atol=1e-5)
            assert g["gt_bitmaps"].shape == (b, 12, 16, 6)
    slots = 6 * (8 if aug == "mosaic" else 1)
    assert g["gt_boxes"].shape == (b, slots, 4)
    # the port's own pipeline: the same raw batches, its generator's draws
    gen = torch.Generator().manual_seed(seed)
    mine = synthetic.coco_batches({"data": data}, b, out_hw, seed=seed,
                                  aug=aug, device="cpu")
    first_raw = next(iter(raws))
    again = synthetic.coco_device_batch(
        first_raw, synthetic.draw_coco_batch(gen, b, aug), out_hw, aug,
        with_masks, device="cpu")
    first = next(mine)
    for k in ("image", "gt_boxes", "gt_mask"):
        torch.testing.assert_close(first[k], again[k], rtol=0, atol=0)


def test_synthetic_coco_records_are_coco_like():
    recs = synthetic.synthetic_coco_records(12, seed=1)
    assert [int(r["image_id"]) for r in recs] == list(range(1, 13))
    for r in recs:
        h, w = r["hw"]
        assert (int(h), int(w)) in synthetic.COCO_SIZES
        assert r["image"].shape == (h, w, 3) and r["image"].dtype == np.uint8
        n = len(r["boxes"])
        assert 1 <= n <= 20 and r["labels"].shape == r["iscrowd"].shape == (n,)
        bx = r["boxes"]
        assert (bx[:, 2] > bx[:, 0]).all() and (bx[:, 2] <= w).all()
        assert (bx[:, 3] > bx[:, 1]).all() and (bx[:, 3] <= h).all()
    assert sum(int(r["iscrowd"].sum()) for r in recs) >= 1
    again = synthetic.synthetic_coco_records(12, seed=1)
    np.testing.assert_array_equal(again[5]["image"], recs[5]["image"])


def test_coco_entries_at_a_cut_size():
    """``centernet_coco_train_entry``: the config's Adam (b1 0.9, b2 0.999,
    eps 1e-8, no decay), clip 35, the NaN guard and ``multi_epochs_decay``
    (5e-4, then / 10 at epochs 90 and 120 of 7400 steps), two steps at
    batch 2 and 64 x 64 with finite losses; ``centernet_eval_entry`` on 4
    small images: the 12 numbers, finite."""
    from minddet_tpu_torch import entry

    step_fn, (state, batches) = entry.centernet_coco_train_entry(
        "cpu", batch=2, images=4, res=64)
    tx = state.tx
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (0.9, 0.999, 1e-8, 0.0)
    assert tx.clip_global_norm == 35.0 and tx.nan_guard
    lr = tx.learning_rate
    for count, want in ((0, 5e-4), (90 * 7400 - 1, 5e-4), (90 * 7400, 5e-5),
                        (120 * 7400, 5e-6)):
        assert math.isclose(float(lr(torch.tensor(count))), want,
                            rel_tol=1e-6)
    for _ in range(2):
        batch = next(batches)
        assert batch["image"].shape == (2, 64, 64, 3)
        state, metrics = step_fn(state, batch)
        assert all(math.isfinite(float(v)) for v in metrics.values())
    assert state.step == 2
    fn, (model, ds) = entry.centernet_eval_entry(
        "cpu", images=4, sizes=((48, 64), (64, 40)))
    assert ds.max_hw == (1024, 1024) and len(ds) == 4
    stats = fn(model, ds)
    assert len(stats) == 12 and all(math.isfinite(v) for v in stats.values())
    if not torch.cuda.is_available():  # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.centernet_eval_entry(images=1)
