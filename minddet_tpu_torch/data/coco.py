"""COCO detection data: JSON parsing, records, host examples and the
evaluation against them (counterpart of ``minddet_tpu/data/coco.py``:
``load_coco_json``, ``category_mapping``, ``coco_examples``,
``convert_coco_to_records``, ``_decode_jpeg``, ``CocoDetection``,
``evaluate_coco_detections``, ``rasterize_polygons``,
``paste_masks_to_image`` and ``example_gt_bitmaps``).

Offline conversion stores the raw JPEG bytes and the boxes per record;
``CocoDetection`` decodes an image onto a fixed-size zero-padded canvas on
the host, and every augmentation runs on the device
(``data/transforms.py``). The records may also be held in memory, each
with its decoded image under ``"image"`` in the place of ``"jpeg"``
(``record_image``): that is how a host without ``cv2`` or
``array_record`` feeds the path. ``cv2`` is imported by the calls that
decode, resize or rasterize, and ``array_record`` by those that open
shards (``data/records.py``): each raises there where the module is
missing. Evaluation is ``data/coco_eval.py``'s, with no pycocotools.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from minddet_tpu_torch.data.coco_eval import COCOEvaluator
from minddet_tpu_torch.data.records import RecordDataset, write_records


def load_coco_json(ann_file: str
                   ) -> Tuple[List[Dict], Dict[int, List[Dict]], List[Dict]]:
    """-> (images, annotations by image id, categories)."""
    with open(ann_file) as f:
        coco = json.load(f)
    by_img: Dict[int, List[Dict]] = {}
    for ann in coco.get("annotations", []):
        by_img.setdefault(ann["image_id"], []).append(ann)
    return coco["images"], by_img, coco.get("categories", [])


def category_mapping(categories: List[Dict]) -> Dict[int, int]:
    """COCO category id -> contiguous [0, C) label, in id order."""
    return {c["id"]: i
            for i, c in enumerate(sorted(categories, key=lambda c: c["id"]))}


def coco_examples(ann_file: str, image_dir: str, skip_empty: bool = True,
                  with_masks: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield record dicts: jpeg bytes, hw, boxes xyxy (annotations of zero
    width or height left out), labels, iscrowd, image_id (and with
    ``with_masks`` the JSON-encoded segmentations); images without a box
    skipped where ``skip_empty``."""
    images, by_img, categories = load_coco_json(ann_file)
    cat_map = category_mapping(categories)
    for img in images:
        boxes, labels, crowd, segs = [], [], [], []
        for a in by_img.get(img["id"], []):
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(cat_map[a["category_id"]])
            crowd.append(a.get("iscrowd", 0))
            if with_masks:
                segs.append(a.get("segmentation", []))
        if skip_empty and not boxes:
            continue
        with open(os.path.join(image_dir, img["file_name"]), "rb") as f:
            jpeg = f.read()
        ex = {
            "jpeg": jpeg,
            "hw": np.array([img["height"], img["width"]], np.int32),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "iscrowd": np.asarray(crowd, np.int32),
            "image_id": np.asarray(img["id"], np.int64),
        }
        if with_masks:
            ex["segmentations"] = json.dumps(segs).encode()
        yield ex


def convert_coco_to_records(ann_file: str, image_dir: str, out_prefix: str,
                            shard_size: int = 4096, with_masks: bool = False
                            ) -> List[str]:
    """``coco_examples`` written to record shards; returns their paths."""
    return write_records(
        out_prefix, coco_examples(ann_file, image_dir, with_masks=with_masks),
        shard_size)


def _decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8, BGR (cv2's order, the reference's)."""
    import cv2

    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def record_image(rec: Dict[str, Any]) -> np.ndarray:
    """A record's image: its decoded ``"image"`` where it holds one (a
    record in memory), else its ``"jpeg"`` decoded."""
    if "image" in rec:
        return np.asarray(rec["image"])
    return _decode_jpeg(rec["jpeg"])


def _segmentations(rec: Dict[str, Any]) -> List:
    segs = rec.get("segmentations")
    if segs is None:
        return []
    return json.loads(segs.decode() if isinstance(segs, bytes) else segs)


class CocoDetection:
    """COCO records as fixed-shape host examples.

    ``records``: a shard pattern (or a list of shard paths), read through
    ``RecordDataset``; or a sequence of record dicts in memory, each with
    its decoded image under ``"image"`` (``record_image``). Each example:
    image (max_h, max_w, 3) f32, the image at the top left of a zero
    canvas (an image larger than the canvas is first scaled down on the
    host, its boxes with it), hw (2,) the image's size on the canvas, boxes
    (max_objs, 4), labels (max_objs,), mask (max_objs,) (valid and not
    crowd), image_id; with ``with_masks`` the GT bitmaps (``_bitmaps``),
    with ``keep_raw`` the record's own boxes, labels, iscrowd (and
    segmentations)."""

    def __init__(self, records, max_hw: Tuple[int, int] = (640, 640),
                 max_objs: int = 128, keep_raw: bool = False,
                 with_masks: bool = False, mask_stride: int = 4):
        """``with_masks`` adds per-object GT bitmaps (records written with
        ``convert_coco_to_records(..., with_masks=True)``) at 1 /
        ``mask_stride`` of the canvas: the Mask R-CNN loss crops 28 x 28
        targets per roi, so full-resolution bitmaps would copy 16x the
        bytes to the device for nothing."""
        if isinstance(records, str) or (
                isinstance(records, (list, tuple)) and records
                and isinstance(records[0], str)):
            records = RecordDataset(records)
        self.records = records
        self.max_hw = max_hw
        self.max_objs = max_objs
        self.keep_raw = keep_raw
        self.with_masks = with_masks
        self.mask_stride = mask_stride

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = dict(self.records[idx])  # a record in memory stays as it is
        img = record_image(rec).astype(np.float32)
        mh, mw = self.max_hw
        h, w = img.shape[:2]
        if h > mh or w > mw:  # rare: the device affine handles the rest
            import cv2

            s = min(mh / h, mw / w)
            img = cv2.resize(img, (int(w * s), int(h * s)))
            rec["boxes"] = rec["boxes"] * s
            h, w = img.shape[:2]
        canvas = np.zeros((mh, mw, 3), np.float32)
        canvas[:h, :w] = img

        o = self.max_objs
        boxes = np.zeros((o, 4), np.float32)
        labels = np.zeros((o,), np.int32)
        mask = np.zeros((o,), bool)
        n = min(len(rec["boxes"]), o)
        boxes[:n] = rec["boxes"][:n]
        labels[:n] = rec["labels"][:n]
        mask[:n] = rec["iscrowd"][:n] == 0
        out = {"image": canvas, "hw": np.array([h, w], np.int32),
               "boxes": boxes, "labels": labels, "mask": mask,
               "image_id": rec["image_id"]}
        if self.with_masks:
            out["bitmaps"] = self._bitmaps(rec, h, w)
        if self.keep_raw:
            out["raw_boxes"] = rec["boxes"]
            out["raw_labels"] = rec["labels"]
            out["raw_iscrowd"] = rec["iscrowd"]
            if "segmentations" in rec:
                out["raw_segmentations"] = rec["segmentations"]
        return out

    def _bitmaps(self, rec: Dict[str, Any], h: int, w: int) -> np.ndarray:
        """(mh / s, mw / s, max_objs) uint8 GT bitmaps in canvas space, as
        ``__getitem__`` places the image (top left, scaled by h / ih)."""
        import cv2

        s = self.mask_stride
        mh, mw = self.max_hw
        out = np.zeros((mh // s, mw // s, self.max_objs), np.uint8)
        if rec.get("segmentations") is None:
            return out
        ih, iw = int(rec["hw"][0]), int(rec["hw"][1])
        bh, bw = max(1, round(h / s)), max(1, round(w / s))
        for i, seg in enumerate(_segmentations(rec)[: self.max_objs]):
            if not seg:
                continue
            m = rasterize_polygons(seg, ih, iw)
            out[:bh, :bw, i] = cv2.resize(m, (bw, bh),
                                          interpolation=cv2.INTER_NEAREST)
        return out


def evaluate_coco_detections(dataset: CocoDetection,
                             predictions: Dict[int, Dict[str, np.ndarray]],
                             num_classes: int = 80, segm: bool = False
                             ) -> Dict[str, float]:
    """The COCO protocol over every record of ``dataset`` (an image without
    predictions counts with none). ``predictions``: image_id -> {boxes (N,
    4) in the image's own pixels, scores, labels, [masks (N, H, W) bool
    with ``segm``]}. ``segm=True`` matches by mask IoU (pycocotools'
    iouType 'segm'), the GT bitmaps rasterized from the records' stored
    segmentations."""
    ev = COCOEvaluator(list(range(num_classes)))
    empty = {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
             "labels": np.zeros(0)}
    for i in range(len(dataset.records)):
        rec = dataset.records[i]
        pred = predictions.get(int(rec["image_id"]), empty)
        gt_masks = None
        if segm:
            ih, iw = int(rec["hw"][0]), int(rec["hw"][1])
            gt_masks = np.zeros((len(rec["boxes"]), ih, iw), bool)
            for gi, seg in enumerate(
                    _segmentations(rec)[: len(rec["boxes"])]):
                if seg:
                    gt_masks[gi] = rasterize_polygons(seg, ih, iw) > 0
        for c in range(num_classes):
            gm = rec["labels"] == c
            pm = np.asarray(pred["labels"]) == c
            dt_masks = None
            if segm:
                dt_masks = (np.asarray(pred["masks"])[pm] if "masks" in pred
                            else np.zeros((int(pm.sum()),)
                                          + gt_masks.shape[1:], bool))
            ev.add(c, np.asarray(pred["boxes"])[pm],
                   np.asarray(pred["scores"])[pm], rec["boxes"][gm],
                   rec["iscrowd"][gm].astype(bool), dt_masks=dt_masks,
                   gt_masks=gt_masks[gm] if segm else None)
    return ev.summarize()


def rasterize_polygons(segmentation, height: int, width: int) -> np.ndarray:
    """A COCO segmentation -> (H, W) uint8 bitmap: polygons filled with
    cv2 (coordinates rounded), an uncompressed RLE ({counts, size},
    column-major) decoded, and resized (nearest) where its size differs."""
    import cv2

    mask = np.zeros((height, width), np.uint8)
    if isinstance(segmentation, dict):
        counts = segmentation["counts"]
        h, w = segmentation["size"]
        if isinstance(counts, list):
            flat = np.zeros(h * w, np.uint8)
            pos, val = 0, 0
            for run in counts:
                if val:
                    flat[pos:pos + run] = 1
                pos += run
                val ^= 1
            mask = flat.reshape(w, h).T
            if (h, w) != (height, width):
                mask = cv2.resize(mask, (width, height),
                                  interpolation=cv2.INTER_NEAREST)
        return mask
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def paste_masks_to_image(masks: np.ndarray, boxes: np.ndarray, height: int,
                         width: int, threshold: float = 0.5) -> np.ndarray:
    """Per-detection roi masks (D, m, m) in [0, 1] pasted into their boxes
    (D, 4) xyxy at the image's resolution -> (D, H, W) bool: each mask
    resized bilinearly to its box's whole-pixel extent, cut to the image,
    thresholded (>= ``threshold``)."""
    import cv2

    out = np.zeros((len(masks), height, width), bool)
    for i in range(len(masks)):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1c, y1c = max(x1i, 0), max(y1i, 0)
        x2c, y2c = min(x2i, width), min(y2i, height)
        bw, bh = x2i - x1i, y2i - y1i
        if bw <= 0 or bh <= 0 or x2c <= x1c or y2c <= y1c:
            continue
        m = cv2.resize(masks[i].astype(np.float32), (bw, bh),
                       interpolation=cv2.INTER_LINEAR)
        out[i, y1c:y2c, x1c:x2c] = (
            m[y1c - y1i:y2c - y1i, x1c - x1i:x2c - x1i] >= threshold)
    return out


def example_gt_bitmaps(rec: Dict[str, Any], max_objs: int,
                       hw: Sequence[int]) -> np.ndarray:
    """Per-object GT bitmaps (H, W, max_objs) f32 at the image's own
    resolution, top left (records written with ``with_masks=True``; zeros
    without segmentations)."""
    h, w = hw
    out = np.zeros((h, w, max_objs), np.float32)
    if rec.get("segmentations") is None:
        return out
    ih, iw = int(rec["hw"][0]), int(rec["hw"][1])
    for i, seg in enumerate(_segmentations(rec)[:max_objs]):
        if not seg:
            continue
        m = rasterize_polygons(seg, ih, iw)
        out[:ih, :iw, i] = m[:min(ih, h), :min(iw, w)]
    return out
