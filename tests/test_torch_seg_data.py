"""The port's segmentation data path vs the JAX package's, on the CPU.

- ``synthetic_seg_batches``: the reference's generator draw for draw, three
  batches at an odd size.
- Records: (image, mask) pairs written with cv2 as a VOC-style folder,
  converted by the port (``convert_seg_to_records``), read back by both
  packages' ``RecordDataset`` equal, and the reference's own shards read
  by the port; ``encode_example`` keeps bytes fields and scalars.
- ``SegDataset``: equal to the reference's on the same records without
  augmentation, and with it (flips from one ``RandomState(seed)``) on the
  same sequence of reads; ``DistributedSampler`` equal index for index;
  the ``DataLoader`` at one worker (so the flips are drawn in the same
  order) and ``seg_batches`` equal batch for batch.
- ``segmentation_evaluate``: the same mIoU as the reference's on the same
  records and weights (a tiny UNet, f64 compute on both sides), 6 images
  in batches of 4, so the tail batch is padded.
- ``cv2`` and ``array_record`` are imported only by the calls that need
  them: no port module imports them at the top, and with either missing
  the call raises ``ImportError``.
"""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_yolov8 import _flax_variables

from minddet_tpu.core.config import Config
from minddet_tpu.data import loader as jloader
from minddet_tpu.data import records as jrecords
from minddet_tpu.data import seg as jseg_data
from minddet_tpu.models.segmentors import UNet as JaxUNet
from minddet_tpu.train import evaluate as jevaluate
from minddet_tpu.train.train import seg_batches as j_seg_batches
from minddet_tpu.train.train import \
    synthetic_seg_batches as j_synthetic_seg_batches
from minddet_tpu_torch.data import loader, records
from minddet_tpu_torch.data import seg as seg_data
from minddet_tpu_torch.models.segmentors import UNet
from minddet_tpu_torch.train.evaluate import segmentation_evaluate
from minddet_tpu_torch.train.synthetic import (seg_batches,
                                               synthetic_seg_batches)
from minddet_tpu_torch.utils.convert import load_from_flax

SIDE = 40
IMAGES = 6
CLASSES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_synthetic_seg_batches_match_the_reference():
    got = synthetic_seg_batches(2, (37, 45), 5, seed=3)
    want = j_synthetic_seg_batches(2, (37, 45), 5, seed=3)
    for _ in range(3):
        _assert_same(next(got), next(want))


@pytest.fixture(scope="module")
def seg_records(tmp_path_factory):
    """A VOC-style folder of IMAGES pairs (sizes differ; class rectangles,
    an ignored corner) and its records, converted by the port at SIDE x
    SIDE."""
    root = tmp_path_factory.mktemp("seg")
    img_dir, mask_dir = root / "images", root / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rs = np.random.RandomState(0)
    for i in range(IMAGES):
        h, w = 50 + 4 * i, 60 + 2 * i
        mask = np.zeros((h, w), np.uint8)
        mask[5:20, 8:30] = 1
        mask[25:45, 30:55] = 2
        mask[:4, :4] = 255
        img = np.stack([mask * 60 + 20, 255 - mask * 50, (mask == 1) * 200],
                       -1) + rs.randint(0, 20, (h, w, 3))
        cv2.imwrite(str(img_dir / f"f{i}.png"), img.clip(0, 255)
                    .astype(np.uint8))
        cv2.imwrite(str(mask_dir / f"f{i}.png"), mask)
    cv2.imwrite(str(img_dir / "unpaired.png"), np.zeros((8, 8, 3), np.uint8))
    paths = seg_data.convert_seg_to_records(
        str(img_dir), str(mask_dir), str(root / "port"), (SIDE, SIDE),
        shard_size=4)
    ref_paths = jseg_data.convert_seg_to_records(
        str(img_dir), str(mask_dir), str(root / "ref"), (SIDE, SIDE),
        shard_size=4)
    return paths, ref_paths, str(root / "port-*.arrayrecord")


def test_records_read_in_both_packages(seg_records):
    paths, ref_paths, pattern = seg_records
    assert [os.path.basename(p) for p in paths] == [
        "port-00000.arrayrecord", "port-00001.arrayrecord"]
    got, want = records.RecordDataset(pattern), jrecords.RecordDataset(paths)
    mine_of_ref = records.RecordDataset(ref_paths)
    assert len(got) == len(want) == len(mine_of_ref) == IMAGES
    for i in range(IMAGES):
        _assert_same(got[i], want[i])
        _assert_same(mine_of_ref[i], want[i])
    assert got[-1]["image"].shape == (SIDE, SIDE, 3)
    assert [got[i]["hw"].tolist() for i in (0, 5)] == [[50, 60], [70, 70]]
    ex = {"name": b"f0.png", "id": 7, "x": np.arange(3.0)}
    back = records.decode_example(records.encode_example(ex))
    assert back["name"] == b"f0.png" and int(back["id"]) == 7
    _assert_same(back, jrecords.decode_example(jrecords.encode_example(ex)))


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "flip"])
def test_seg_dataset_matches_the_reference(seg_records, augment):
    _, _, pattern = seg_records
    got = seg_data.SegDataset(pattern, augment=augment, seed=4)
    want = jseg_data.SegDataset(pattern, augment=augment, seed=4)
    for i in (0, 1, 2, 3, 4, 5, 2, 2, 0):
        a, b = got[i], want[i]
        _assert_same(a, b)
    ignored = ~a["valid"]  # the ignored corner, flipped or not
    assert ignored.any() and not a["mask"][ignored].any()
    np.testing.assert_array_equal(seg_data.seg_normalize(np.full(3, 255)),
                                  (1 - jseg_data.SEG_MEAN)
                                  / jseg_data.SEG_STD)


@pytest.mark.parametrize("num_examples", [7, 9], ids=["padded", "even"])
def test_distributed_sampler_matches_the_reference(num_examples):
    for shard in range(3):
        got = loader.DistributedSampler(num_examples, 3, shard, seed=2)
        want = jloader.DistributedSampler(num_examples, 3, shard, seed=2)
        for epoch in (0, 1):
            np.testing.assert_array_equal(got.epoch_indices(epoch),
                                          want.epoch_indices(epoch))
    assert loader.process_shard() == (0, 1)


def test_loader_and_seg_batches_match_the_reference(seg_records):
    """One worker: the flips are drawn in the sampler's order in both."""
    _, _, pattern = seg_records
    got = loader.DataLoader(seg_data.SegDataset(pattern, True, seed=1), 2,
                            sampler=loader.DistributedSampler(IMAGES, seed=1),
                            num_workers=1)
    want = jloader.DataLoader(jseg_data.SegDataset(pattern, True, seed=1), 2,
                              sampler=jloader.DistributedSampler(IMAGES,
                                                                 seed=1),
                              num_workers=1)
    assert got.steps_per_epoch() == want.steps_per_epoch() == 3
    for a, b in zip(got.epoch(1), want.epoch(1)):
        _assert_same(a, b)
    cfg = {"data": {"records": pattern, "augment": True, "workers": 1}}
    gen, ref = seg_batches(cfg, 4, seed=5), j_seg_batches(
        Config.fromdict(cfg), 4, seed=5)
    for _ in range(3):  # one batch an epoch: the second starts over
        _assert_same(next(gen), next(ref))
    with pytest.raises(ValueError):
        next(loader.DataLoader(list(range(3)), 4).epoch())


def test_loader_raises_a_workers_exception_at_its_batch():
    order = loader.DistributedSampler(4).epoch_indices(0)

    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == order[-1]:  # in the second batch
                raise KeyError(i)
            return {"x": np.asarray(i)}

    batches = loader.DataLoader(Bad(), 2, num_workers=2).epoch()
    np.testing.assert_array_equal(next(batches)["x"], order[:2])
    with pytest.raises(KeyError):
        next(batches)


def test_segmentation_evaluate_matches_the_reference(seg_records):
    _, _, pattern = seg_records
    jm = JaxUNet(num_classes=CLASSES, widths=(8, 16, 32), dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.zeros((1, SIDE, SIDE, 3)),
                                    seed=2)
        want = jevaluate.segmentation_evaluate(jm, variables, pattern,
                                               CLASSES, batch_size=4)
        want_3 = jevaluate.segmentation_evaluate(
            jm, variables, pattern, CLASSES, batch_size=4, max_images=3)
    port = load_from_flax(UNet(num_classes=CLASSES, widths=(8, 16, 32),
                               dtype=torch.float64).double(), variables)
    port.eval()
    got = segmentation_evaluate(port, pattern, CLASSES, batch_size=4)
    got_3 = segmentation_evaluate(port, pattern, CLASSES, batch_size=4,
                                  max_images=3)
    assert 0 < want["miou"] < 1 and want["miou"] != want_3["miou"]
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert got_3 == pytest.approx(want_3, rel=1e-12, abs=0)


def test_seg_modules_import_cv2_and_array_record_at_the_call(
        seg_records, monkeypatch, tmp_path):
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "minddet_tpu_torch")
    top = []
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(d, n)) as f:
                    top += [f"{n}: {line.strip()}" for line in f
                            if line.startswith(("import cv2",
                                                "from array_record",
                                                "import array_record"))]
    assert not top, top
    _, _, pattern = seg_records
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        next(seg_data.seg_examples(str(tmp_path), str(tmp_path)))
    monkeypatch.setitem(sys.modules, "array_record.python."
                        "array_record_module", None)
    with pytest.raises(ImportError):
        seg_data.SegDataset(pattern)
    with pytest.raises(ImportError):
        records.write_records(str(tmp_path / "x"), [{"a": 1}])
