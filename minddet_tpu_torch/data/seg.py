"""Semantic-segmentation data: records and host examples (counterpart of
``minddet_tpu/data/seg.py``: ``SEG_MEAN``, ``SEG_STD``, ``seg_normalize``,
``seg_examples``, ``convert_seg_to_records`` and ``SegDataset``).

(image, mask) pairs become fixed-size uint8 records (images resized
bilinearly, masks nearest-neighbour, at conversion), which ``SegDataset``
turns into normalized train-ready examples for ``train/synthetic.py:
seg_batches`` and ``train/evaluate.py:segmentation_evaluate``. ``cv2`` is
imported by the call that reads images (``seg_examples``) and
``array_record`` by those that write or open shards (``data/records.py``):
each raises there where the module is missing.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from minddet_tpu_torch.data.records import RecordDataset, write_records

# CenterNet's COCO statistics, as the detection pipeline normalizes
SEG_MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
SEG_STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
IGNORE_LABEL = 255  # a void mask pixel (VOC, Cityscapes)


def seg_normalize(images: np.ndarray) -> np.ndarray:
    """uint8 / float [0, 255] images -> normalized float32 ((x / 255 -
    mean) / std; train and eval use the same constants)."""
    return (np.asarray(images, np.float32) / 255.0 - SEG_MEAN) / SEG_STD


def seg_examples(image_dir: str, mask_dir: str,
                 image_hw: Tuple[int, int] = (512, 512),
                 ignore_label: int = IGNORE_LABEL
                 ) -> Iterator[Dict[str, Any]]:
    """Pair each image of ``image_dir`` (sorted) with the same-stem ``.png``
    (else ``.bmp``) mask of ``mask_dir``, images without one skipped; both
    resized to ``image_hw`` (the VOC / Cityscapes layout: a mask pixel is
    the class id, ``ignore_label`` for void). Yields image (H, W, 3) uint8
    BGR, mask (H, W) uint8, hw (the original size) and ignore_label."""
    import cv2

    stems: List[Tuple[str, str]] = []
    for f in sorted(os.listdir(image_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in IMG_EXTS:
            stems.append((stem, f))  # the file's own name, any case
    h, w = image_hw
    for stem, fname in stems:
        mask_path = next((p for p in (os.path.join(mask_dir, stem + e)
                                      for e in (".png", ".bmp"))
                          if os.path.exists(p)), None)
        if mask_path is None:
            continue
        img = cv2.imread(os.path.join(image_dir, fname), cv2.IMREAD_COLOR)
        mask = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        yield {
            "image": cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR
                                ).astype(np.uint8),
            "mask": cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST
                               ).astype(np.uint8),
            "hw": np.array(img.shape[:2], np.int32),
            "ignore_label": np.asarray(ignore_label, np.int32),
        }


def convert_seg_to_records(image_dir: str, mask_dir: str, out_prefix: str,
                           image_hw: Tuple[int, int] = (512, 512),
                           shard_size: int = 2048,
                           ignore_label: int = IGNORE_LABEL) -> List[str]:
    """``seg_examples`` written to record shards; returns their paths."""
    return write_records(out_prefix,
                         seg_examples(image_dir, mask_dir, image_hw,
                                      ignore_label),
                         shard_size)


class SegDataset:
    """Record-backed segmentation examples: image (H, W, 3) normalized f32,
    mask (H, W) int32 (0 at ignored pixels), valid (H, W) bool (False
    where the mask is the record's ``ignore_label``, ``IGNORE_LABEL``
    without one).
    With ``augment`` a horizontal flip of image and mask together, drawn
    from one ``RandomState(seed)`` per dataset, example by example."""

    def __init__(self, record_pattern, augment: bool = False, seed: int = 0):
        self.records = RecordDataset(record_pattern)
        self.augment = augment
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        img = np.asarray(rec["image"])
        mask = np.asarray(rec["mask"])
        if self.augment and self._rng.rand() < 0.5:
            img = img[:, ::-1]
            mask = mask[:, ::-1]
        mask = mask.astype(np.int32)
        valid = mask != int(rec.get("ignore_label", IGNORE_LABEL))
        return {"image": seg_normalize(img),
                "mask": np.where(valid, mask, 0).astype(np.int32),
                "valid": valid}
