"""``python -m minddet_tpu_torch.tools.create_data`` against the reference's
``tools/create_data.py``: each subcommand but ``waymo`` (its toolkit is not
installed; the converter is held to the reference's in
``test_torch_waymo_data.py``) on the fixtures the data tests build writes
records that read back the same through both packages, and
``gt-database`` the same object bank. cv2 and array_record are on the CPU
host.
"""

import importlib.util
import os
import pickle

import pytest
from test_coco_pipeline import _make_coco
from test_mask_seg_paths import _make_seg
from test_nuscenes_data import _write_fake_nusc
from test_torch_kitti_data import _assert_same, _kitti_tree

from minddet_tpu.data.records import RecordDataset as JRecordDataset
from minddet_tpu_torch.data.records import RecordDataset
from minddet_tpu_torch.tools import create_data as tcreate

pytest.importorskip("cv2")
pytest.importorskip("array_record")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_create_data", os.path.join(_REPO, "tools",
                                              "create_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_records(got_paths, want_paths):
    got, want = RecordDataset(got_paths), JRecordDataset(want_paths)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _assert_same(got[i], want[i])


def _both(tmp_path, argv_of):
    """Run the port's and the reference's CLI with ``argv_of(out)``; returns
    their outputs' paths."""
    got = tcreate.main(argv_of(str(tmp_path / "t" / "out")))
    _reference().main(argv_of(str(tmp_path / "j" / "out")))
    return got, sorted(p.replace("/t/", "/j/") for p in got)


@pytest.mark.parametrize("cmd", ["kitti", "nuscenes", "coco", "seg"])
def test_records_match_the_reference(cmd, tmp_path):
    import numpy as np

    if cmd == "kitti":
        ids = ["000000", "000007"]
        _kitti_tree(str(tmp_path), ids, np.random.RandomState(1))
        (tmp_path / "train.txt").write_text("\n".join(ids) + "\n")
        argv = ["kitti", "--root", str(tmp_path), "--split-file",
                str(tmp_path / "train.txt"), "--classes", "Car", "Pedestrian"]
    elif cmd == "nuscenes":
        root = _write_fake_nusc(str(tmp_path))
        argv = ["nuscenes", "--root", root, "--version", "v1.0-test",
                "--nsweeps", "3"]
    elif cmd == "coco":
        ann, imgs = _make_coco(tmp_path)
        argv = ["coco", "--ann", ann, "--images", imgs]
    else:
        imgs, masks = _make_seg(tmp_path)
        argv = ["seg", "--images", imgs, "--masks", masks, "--image-hw",
                "48", "64", "--ignore-label", "250"]
    got, want = _both(tmp_path, lambda out: argv + ["--out", out])
    assert all(os.path.exists(p) for p in got + want)
    _same_records(got, want)


def test_gt_database_matches_the_reference(tmp_path):
    import numpy as np

    ids = ["000000", "000007"]
    _kitti_tree(str(tmp_path), ids, np.random.RandomState(1))
    (tmp_path / "train.txt").write_text("\n".join(ids) + "\n")
    records = tcreate.main(["kitti", "--root", str(tmp_path), "--split-file",
                            str(tmp_path / "train.txt"), "--out",
                            str(tmp_path / "rec")])
    pattern = str(tmp_path / "rec-*.arrayrecord")
    assert records
    got, want = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    argv = ["gt-database", "--records", pattern, "--classes", "Car",
            "--min-points", "0"]
    assert tcreate.main(argv + ["--out", got]) == [got]
    _reference().main(argv + ["--out", want])
    with open(got, "rb") as f, open(want, "rb") as g:
        db_t, db_j = pickle.load(f), pickle.load(g)
    assert set(db_t) == set(db_j) == {"Car"} and len(db_j["Car"]) > 0
    _assert_same(db_t, db_j)
