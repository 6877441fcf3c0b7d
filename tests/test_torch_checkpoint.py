"""The port's checkpoints, metrics and storage paths, on the CPU.

- ``CheckpointManager``: the save interval and ``force``, a step saved once,
  rotation to ``keep_max`` step directories, ``latest_step``, ``restore``
  of the latest or a given step, the writer thread (``async_save``: the
  host copy is taken at ``save``, so a later in-place change does not
  reach the file; ``wait`` re-raises the thread's error), and no
  checkpoint -> FileNotFoundError; ``save_pytree`` / ``load_pytree`` and
  ``tree_size_bytes``, against the reference's ``tree_size_bytes`` on the
  same arrays.
- The resume trap of ``core/optim.py:_schedule_groups``: the groups share
  one lr tensor and one count, and a step advances group 0's only. After
  ``load_optimizer_state`` every group holds group 0's tensors again, and
  the second group's lr follows the schedule through the steps after a
  resume, as in a run that never stopped (bit for bit on the CPU).
- ``MetricWriter`` writes the reference's record keys and values (JSONL),
  ``StepTimer`` as the reference's, ``profiler_trace`` writes a Chrome trace.
- ``utils/cloud.py``: local paths as plain file I/O in both packages (the
  same files copied, listed and mirrored, ``exclude`` honoured), remote
  schemes recognised, and without fsspec a remote path raises ImportError.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from minddet_tpu.core import metrics as jmetrics
from minddet_tpu.utils import cloud as jcloud
from minddet_tpu_torch.core import checkpoint as ck
from minddet_tpu_torch.core import metrics as tmetrics
from minddet_tpu_torch.core.lr_schedules import one_cycle
from minddet_tpu_torch.core.optim import (adamw, load_optimizer_state, sgd,
                                          skip_nonfinite_updates)
from minddet_tpu_torch.utils import cloud as tcloud


def test_manager_interval_rotation_restore(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"), keep_max=2,
                               save_interval_steps=3, async_save=True)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    state = {"model": {"w": torch.arange(4.0)}, "step": 0,
             "nested": [torch.ones(2, dtype=torch.int64), {"x": 1.5}]}
    saved = []
    for step in range(1, 11):
        state["model"]["w"] += 1
        state["step"] = step
        saved.append(mgr.save(step, state, force=step == 10))
        state["model"]["w"] += 100  # after the save: not in the file
        state["model"]["w"] -= 100
    mgr.wait()
    assert [s for s, ok in zip(range(1, 11), saved) if ok] == [3, 6, 9, 10]
    assert mgr.all_steps() == [9, 10] and mgr.latest_step() == 10
    assert not mgr.save(10, state, force=True)  # a step is saved once
    latest = mgr.restore()
    assert latest["step"] == 10
    assert torch.equal(latest["model"]["w"], torch.arange(4.0) + 10)
    assert mgr.restore(step=9)["step"] == 9
    assert torch.equal(mgr.restore(9)["nested"][0],
                       torch.ones(2, dtype=torch.int64))
    assert sorted(os.listdir(mgr.step_dir(10))) == [ck.STATE_FILE]
    mgr.close()
    sync = ck.CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert sync.latest_step() == 10  # found on disk by a new manager


def test_writer_thread_errors_reach_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
    mgr.save(1, {"f": lambda: 0})  # torch.save cannot pickle a lambda
    with pytest.raises(Exception):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.latest_step() is None


def test_pytree_and_size(tmp_path):
    tree = {"a": torch.zeros(3, 4), "b": [np.zeros(5, np.float64),
                                         torch.ones(2, dtype=torch.bfloat16)],
            "c": 7}
    path = str(tmp_path / "tree")
    ck.save_pytree(path, tree)
    back = ck.load_pytree(path)
    assert torch.equal(back["a"], tree["a"]) and back["c"] == 7
    assert torch.equal(back["b"][1], tree["b"][1])
    assert torch.equal(back["b"][0], torch.zeros(5, dtype=torch.float64))
    assert ck.tree_size_bytes(tree) == 48 + 40 + 4
    import jax.numpy as jnp
    from minddet_tpu.core.checkpoint import tree_size_bytes

    assert tree_size_bytes({"a": jnp.zeros((3, 4)), "b": [
        np.zeros(5, np.float64), jnp.ones(2, jnp.bfloat16)]}) == 92


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(3, 4)  # weight decayed (group 0), bias not


def _step(model, opt, tx, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    tx.update(opt, model.parameters())


@pytest.mark.parametrize("make", [
    lambda s: skip_nonfinite_updates(adamw(s, weight_decay=0.1)),
    lambda s: skip_nonfinite_updates(sgd(s, momentum=0.9,
                                         weight_decay=1e-3))],
    ids=["adamw", "sgd"])
def test_restored_groups_share_lr_and_count(tmp_path, make):
    """Resume after 2 of 5 steps under a one-cycle schedule: the restored
    optimizer's groups hold one lr and one count again, group 1's lr is
    the schedule's at every later step, and the parameters and state equal
    those of the run that never stopped, bit for bit."""
    schedule = one_cycle(1e-2, 8)
    torch.manual_seed(0)
    straight = _Net()
    resumed = _Net()
    resumed.load_state_dict(straight.state_dict())
    tx = make(schedule)
    opt = tx.init(straight)
    for i in range(5):
        _step(straight, opt, tx, i)
    tx2 = make(schedule)
    opt2 = tx2.init(resumed)
    for i in range(2):
        _step(resumed, opt2, tx2, i)
    mgr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.save(2, {"model": resumed.state_dict(),
                 "optimizer": opt2.state_dict()})
    restored = _Net()
    tx3 = make(schedule)
    opt3 = tx3.init(restored)
    back = mgr.restore()
    restored.load_state_dict(back["model"])
    load_optimizer_state(opt3, back["optimizer"])
    g0, g1 = opt3.param_groups
    assert g1["lr"] is g0["lr"] and g1["count"] is g0["count"]
    for i in range(2, 5):
        _step(restored, opt3, tx3, i)
        assert float(g1["lr"]) == float(schedule(torch.tensor(i)))
    assert int(g1["count"]) == 5
    for a, b in zip(restored.parameters(), straight.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(restored.parameters(), straight.parameters()):
        for k, v in opt.state[q].items():
            assert torch.equal(opt3.state[p][k], v), k
    # without the re-tie group 1 would keep its restored lr and count
    untied = _Net()
    opt4 = make(schedule).init(untied)
    opt4.load_state_dict(back["optimizer"])
    assert opt4.param_groups[1]["count"] is not opt4.param_groups[0]["count"]


def test_metric_writer_records_as_the_reference(tmp_path):
    metrics = {"loss": torch.tensor(1.25), "parts": np.float32(0.5),
               "grad_norm": 3, "note": "x", "img_per_sec": float("nan")}
    tmetrics.MetricWriter(str(tmp_path / "t")).write(7, metrics)
    jmetrics.MetricWriter(str(tmp_path / "j")).write(7, {
        k: (np.float32(v) if hasattr(v, "item") else v)
        for k, v in metrics.items()})
    got, want = (json.loads((tmp_path / d / "metrics.jsonl").read_text())
                 for d in ("t", "j"))
    assert list(got) == list(want) == ["step", "time", "loss", "parts",
                                       "grad_norm", "note", "img_per_sec"]
    assert {k: v for k, v in got.items() if k not in ("time", "img_per_sec")}\
        == {k: v for k, v in want.items() if k not in ("time", "img_per_sec")}
    assert got["img_per_sec"] != got["img_per_sec"]
    assert tmetrics.MetricWriter().path is None


def test_step_timer_as_the_reference(monkeypatch):
    def ticks(timer):
        clock = iter([0.0, 1.0, 3.0, 6.0, 10.0, 15.0])
        monkeypatch.setattr(tmetrics.time, "perf_counter",
                            lambda: next(clock))  # jmetrics' time too
        return [timer.tick() for _ in range(6)]

    t, j = tmetrics.StepTimer(), jmetrics.StepTimer()
    assert ticks(t) == ticks(j) == [None, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert t.mean_step_time == j.mean_step_time == 4.0
    assert t.throughput(8) == j.throughput(8) == 2.0
    t.reset()
    assert t.mean_step_time != t.mean_step_time  # nan: no step yet


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with tmetrics.profiler_trace(None):
        pass
    with tmetrics.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def _tree(root):
    (root / "sub").mkdir(parents=True)
    (root / "a.txt").write_text("a")
    (root / "sub" / "b.bin").write_bytes(b"\x00\x01")
    (root / "data").mkdir()
    (root / "data" / "big").write_text("x")


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cloud_local_paths_as_the_reference(tmp_path):
    _tree(tmp_path / "src")
    for name, mod in (("t", tcloud), ("j", jcloud)):
        out = tmp_path / name
        assert mod.sync_dir(str(tmp_path / "src"), str(out / "mirror")) \
            == str(out / "mirror")
        mod.upload_dir(str(tmp_path / "src"), str(out / "up"))
        mod.download(str(tmp_path / "src" / "sub" / "b.bin"),
                     str(out / "dl" / "b.bin"))
        assert mod.listdir(str(tmp_path / "src")) == ["a.txt", "data", "sub"]
        with mod.open_path(str(out / "dl" / "b.bin")) as f:
            assert f.read() == b"\x00\x01"
    for part in ("mirror", "up", "dl"):
        assert _listing(tmp_path / "t" / part) == \
            _listing(tmp_path / "j" / part)
    assert "data/big" not in _listing(tmp_path / "t" / "up")
    for path in ("gs://b/x", "s3://b/x", "obs://b/x", "/local", "gcs://x"):
        assert tcloud.is_remote(path) == jcloud.is_remote(path)


def test_cloud_remote_needs_fsspec(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "fsspec", None)  # import fails
    for call in (lambda: tcloud.open_path("gs://bucket/x"),
                 lambda: tcloud.listdir("s3://bucket/"),
                 lambda: tcloud.sync_dir("obs://bucket/d", str(tmp_path)),
                 lambda: tcloud.upload_dir(str(tmp_path), "gs://bucket/d")):
        with pytest.raises(ImportError, match="fsspec"):
            call()
