"""The port's configuration system vs the JAX package's, on the CPU.

- Every ``configs/*.yaml`` loads to the same ``to_dict()`` in both packages
  (``_base_`` merged), and ``entry.read_config`` gives that dict.
- ``_base_`` inheritance (a path and a list), multi-document YAML, ``.py``
  and ``.json`` files, and unknown extensions, as in both packages.
- ``merge_from_options`` and ``_parse_scalar`` on the cases of
  ``tests/test_entrypoints.py`` and more (bools, none, ints, floats,
  bracketed and comma lists, strings, new nested keys, a missing ``=``).
- ``ConfigDict``'s attribute access, deep copy and ``dump``.
"""

import copy
import glob
import json
import os

import pytest

from minddet_tpu.core import config as jconfig
from minddet_tpu_torch import entry
from minddet_tpu_torch.core import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _both(path):
    return (tconfig.Config.fromfile(str(path)).to_dict(),
            jconfig.Config.fromfile(str(path)).to_dict())


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_loads_as_the_reference(path):
    got, want = _both(path)
    assert got == want
    assert "_base_" not in got and "model" in got and "train" in got
    assert entry.read_config(path) == want


def test_base_multi_document_py_and_json(tmp_path):
    (tmp_path / "a.yaml").write_text("model:\n  type: SSD\n  num_classes: 80\n"
                                     "train:\n  batch_size: 4\n")
    (tmp_path / "b.yaml").write_text("train:\n  batch_size: 8\n  lr: 0.1\n")
    (tmp_path / "one.yaml").write_text("_base_: a.yaml\nmodel:\n"
                                       "  num_classes: 20\n")
    (tmp_path / "two.yaml").write_text(
        "_base_: [a.yaml, b.yaml]\nmodel:\n  depth: 50\n---\n"
        "model:\n  depth: 101\nextra: [1, 2]\n")
    (tmp_path / "c.py").write_text(
        "import os\nmodel = dict(type='UNet', num_classes=3)\nlr = 0.1\n"
        "_hidden = 1\n\ndef f():\n    pass\n")
    (tmp_path / "d.json").write_text(json.dumps(
        {"_base_": "a.yaml", "model": {"type": "YOLOX"}}))
    for name in ("one.yaml", "two.yaml", "c.py", "d.json"):
        got, want = _both(tmp_path / name)
        assert got == want, name
    two = tconfig.Config.fromfile(str(tmp_path / "two.yaml"))
    assert two.model.depth == 101 and two.train.batch_size == 8
    assert two.train.lr == 0.1 and two.extra == [1, 2]
    py = tconfig.Config.fromfile(str(tmp_path / "c.py"))
    assert set(py.keys()) == {"model", "lr"}
    (tmp_path / "e.toml").write_text("")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="Unsupported"):
            mod.Config.fromfile(str(tmp_path / "e.toml"))
        with pytest.raises(FileNotFoundError):
            mod.Config.fromfile(str(tmp_path / "none.yaml"))


@pytest.mark.parametrize("text", [
    "true", "False", "none", "NULL", "3", "-7", "0.01", "1e-4", "nan",
    "[0.4,0.4,8.0]", "[1, 2, x]", "[]", "1,2,3", "a,b", "abc", "",
    "model.x"])
def test_parse_scalar_as_the_reference(text):
    got, want = tconfig._parse_scalar(text), jconfig._parse_scalar(text)
    if isinstance(want, float) and want != want:
        assert isinstance(got, float) and got != got
    else:
        assert got == want and type(got) is type(want)


def test_merge_from_options_as_the_reference(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("model:\n  type: CenterNet\n  depth: 18\n"
                 "train:\n  batch_size: 4\n")
    options = ["model.depth=50", "train.lr=0.01", "model.dcn=false",
               "new.deep.key=[1,2]", "refined=true", "train.name=run 1"]
    got = tconfig.Config.fromfile(str(p)).merge_from_options(options)
    want = jconfig.Config.fromfile(str(p)).merge_from_options(options)
    assert got.to_dict() == want.to_dict()
    assert got.model.depth == 50 and got.model.dcn is False
    assert abs(got.train.lr - 0.01) < 1e-9 and got.refined is True
    assert got.new.deep.key == [1, 2]
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="key=value"):
            mod.Config.fromfile(str(p)).merge_from_options(["model.depth"])


def test_config_dict_access_copy_and_dump(tmp_path):
    d = tconfig.ConfigDict({"a": {"b": [{"c": 1}]}}, x=2)
    assert d.a.b[0].c == 1 and d.x == 2
    d.y = {"z": 3}
    assert isinstance(d.y, tconfig.ConfigDict) and d.y.z == 3
    del d.x
    with pytest.raises(AttributeError):
        d.x
    with pytest.raises(AttributeError):
        del d.x
    e = copy.deepcopy(d)
    e.a.b[0].c = 5
    assert d.a.b[0].c == 1 and isinstance(e, tconfig.ConfigDict)
    assert d.to_dict() == {"a": {"b": [{"c": 1}]}, "y": {"z": 3}}
    cfg = tconfig.Config.fromdict({"m": {"k": (1, 2)}, "t": 1.5})
    assert "m" in cfg and cfg["t"] == 1.5 and cfg.get("q", 7) == 7
    cfg.merge_from_dict({"m": {"j": 1}})
    assert cfg.m.k == (1, 2) and cfg.m.j == 1 and cfg.filename is None
    cfg.dump(str(tmp_path / "out.json"))
    jcfg = jconfig.Config.fromdict({"m": {"k": (1, 2), "j": 1}, "t": 1.5})
    jcfg.dump(str(tmp_path / "ref.json"))
    assert (tmp_path / "out.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    with pytest.raises(AttributeError):
        cfg._private
