"""The offline data-preparation CLI (counterpart of ``tools/create_data.py``):
one entry point over the port's converters in ``minddet_tpu_torch/data/``::

    python -m minddet_tpu_torch.tools.create_data kitti --root KITTI \\
        --split-file train.txt --out data/kitti/train [--classes Car]
    python -m minddet_tpu_torch.tools.create_data nuscenes --root NUSC \\
        --out data/nuscenes/train [--version v1.0-trainval] [--nsweeps 10] \\
        [--split train]
    python -m minddet_tpu_torch.tools.create_data waymo \\
        --tfrecords 'segs/*.tfrecord' --out data/waymo/train
    python -m minddet_tpu_torch.tools.create_data coco \\
        --ann instances_train2017.json --images train2017/ \\
        --out data/coco/train [--with-masks]
    python -m minddet_tpu_torch.tools.create_data seg --images JPEGImages/ \\
        --masks SegmentationClass/ --out data/voc/train --image-hw 513 513
    python -m minddet_tpu_torch.tools.create_data gt-database \\
        --records 'data/kitti/train-*' --classes Car --out data/kitti/gt_db.pkl

Each subcommand writes ArrayRecord shards and prints their paths, or, for
``gt-database``, pickles the per-class object bank of the GT sampler. The
converters import what they need inside the calls (cv2, array_record, the
Waymo toolkit), so the module imports on a host without them.
"""

from __future__ import annotations

import argparse
import glob
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run one subcommand; returns the written shard paths (``gt-database``:
    the database file)."""
    p = argparse.ArgumentParser(description="minddet_tpu_torch offline data "
                                            "preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="KITTI velodyne+label -> records")
    k.add_argument("--root", required=True)
    k.add_argument("--split-file", required=True)
    k.add_argument("--out", required=True)
    k.add_argument("--classes", nargs="+", default=["Car"])

    n = sub.add_parser("nuscenes", help="nuScenes tables -> 10-sweep records")
    n.add_argument("--root", required=True)
    n.add_argument("--out", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--nsweeps", type=int, default=10)
    n.add_argument("--split", default="train", choices=["train", "val"])

    w = sub.add_parser("waymo", help="Waymo Frame TFRecords -> records "
                                     "(needs tensorflow + waymo proto)")
    w.add_argument("--tfrecords", required=True,
                   help="glob of segment .tfrecord files")
    w.add_argument("--out", required=True)
    w.add_argument("--max-points", type=int, default=180000)

    c = sub.add_parser("coco", help="COCO annotations + images -> records")
    c.add_argument("--ann", required=True)
    c.add_argument("--images", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--with-masks", action="store_true",
                   help="store polygon/RLE segmentations (Mask R-CNN)")

    s = sub.add_parser("seg", help="(image, mask-png) pairs -> seg records")
    s.add_argument("--images", required=True)
    s.add_argument("--masks", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--image-hw", type=int, nargs=2, default=[512, 512])
    s.add_argument("--ignore-label", type=int, default=255)

    g = sub.add_parser("gt-database",
                       help="crop per-object clouds for GT-AUG sampling")
    g.add_argument("--records", required=True, help="record glob (kitti/nusc)")
    g.add_argument("--classes", nargs="+", default=["Car"])
    g.add_argument("--out", required=True)
    g.add_argument("--min-points", type=int, default=5)

    args = p.parse_args(argv)

    if args.cmd == "kitti":
        from minddet_tpu_torch.data.kitti import create_kitti_records
        paths = create_kitti_records(args.root, args.split_file, args.out,
                                     tuple(args.classes))
    elif args.cmd == "nuscenes":
        from minddet_tpu_torch.data.nuscenes import create_nuscenes_records
        paths = create_nuscenes_records(args.root, args.out,
                                        version=args.version,
                                        nsweeps=args.nsweeps,
                                        split=args.split)
    elif args.cmd == "waymo":
        from minddet_tpu_torch.data.waymo import convert_waymo_tfrecords
        paths = convert_waymo_tfrecords(sorted(glob.glob(args.tfrecords)),
                                        args.out,
                                        max_points=args.max_points)
    elif args.cmd == "coco":
        from minddet_tpu_torch.data.coco import convert_coco_to_records
        paths = convert_coco_to_records(args.ann, args.images, args.out,
                                        with_masks=args.with_masks)
    elif args.cmd == "seg":
        from minddet_tpu_torch.data.seg import convert_seg_to_records
        paths = convert_seg_to_records(args.images, args.masks, args.out,
                                       image_hw=tuple(args.image_hw),
                                       ignore_label=args.ignore_label)
    else:  # gt-database
        from minddet_tpu_torch.data.gt_sampler import (build_gt_database,
                                                       save_database)
        from minddet_tpu_torch.data.records import RecordDataset
        db = build_gt_database(RecordDataset(args.records),
                               tuple(args.classes),
                               min_points=args.min_points)
        save_database(db, args.out)
        counts = {name: len(v) for name, v in db.items()}
        print(f"gt database -> {args.out}: {counts}")
        return [args.out]
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
