"""The port's ``Trainer``, ``create_train_state`` and synthetic generators
vs the JAX package's, on the CPU.

- ``synthetic_detection_batches`` (with and without masks) and
  ``synthetic_points_batches`` (7- and 9-wide boxes, 4 and 5 features)
  give the reference's arrays bit for bit, batch after batch.
- ``Trainer.fit`` on a tiny CenterNet (depth 18, DCN, 4 classes, 64 x 64,
  batch 8) under ``build_optimizer`` / ``build_schedule`` (SGD, momentum
  0.9, clip 35, the NaN guard; multi_epochs_decay from 0.005, its
  milestone at the third step), started from the reference's initial
  variables (its init on the first batch, as its CLI makes them) through
  ``utils/convert.py``,
  against the reference's ``Trainer`` on the conftest's 8-device CPU mesh
  (its batch sharded one image a device): the same draws (the sample
  first, then three steps), each step's loss and parts within 1e-5
  relative and grad_norm within 1e-4, the same metrics.jsonl keys, and
  after three steps every parameter within 1e-4 relative L2 of its update
  from the start.

  Three steps are held tightly only where the steps are well conditioned,
  so three things differ from the CenterNet CLI: the parameters and compute
  are f64 (in f32 a ReLU input within rounding of zero takes the other
  branch on one side, and the third step's loss moves by percents); the
  offset convs and BN are random (``randomize_flax`` at phase 4's offset
  gain 0.25): flax's zero offsets put every sample on the integer grid,
  where the sampler's coordinate gradient jumps, and the first step moves
  them to either side of it; at gain 1 the nine chained DCN layers
  amplify rounding into the first step's gradients; and the optimizer is
  SGD at a small lr: the losses are f32 on both sides (the heads' outputs
  are cast), so the gradients agree only to f32 rounding, and Adam's first
  steps (~lr * sign(g)) turn every element under that noise into a +-lr
  move, as a large SGD step spreads it. ``tests/test_torch_registry.py``
  holds Adam itself against optax.
- Resume: ``fit`` for 2 steps, a checkpoint, a new state restored from it
  and ``fit`` for the third step (the batch iterator past the checkpoint's
  steps) equals 3 straight steps bit for bit.
- ``create_train_state``: the weights from the generator, the device,
  train mode; ``to_device``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_centernet import randomize_flax

from minddet_tpu.core.lr_schedules import build_schedule as j_build_schedule
from minddet_tpu.core.metrics import MetricWriter as JMetricWriter
from minddet_tpu.core.optim import build_optimizer as j_build_optimizer
from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu.parallel.mesh import MeshSpec, create_mesh
from minddet_tpu.train import train as jtrain
from minddet_tpu.train.loop import Trainer as JTrainer
from minddet_tpu.train.loop import TrainState as JTrainState
from minddet_tpu.train.loop import make_train_step as j_make_train_step
from minddet_tpu_torch.core.checkpoint import CheckpointManager
from minddet_tpu_torch.core.lr_schedules import build_schedule
from minddet_tpu_torch.core.metrics import MetricWriter
from minddet_tpu_torch.core.optim import build_optimizer
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.train import train as ttrain
from minddet_tpu_torch.train.loop import (Trainer, TrainState,
                                          create_train_state,
                                          make_train_step, to_device)
from minddet_tpu_torch.utils.convert import centernet_from_flax

CLASSES, HW, BATCH, STEPS = 4, (64, 64), 8, 3
# SGD, not the CenterNet config's Adam: see the module's docstring; the
# milestone at count 2 makes the third step's lr a tenth of the others'
OPTIMIZER = {"type": "sgd", "momentum": 0.9, "clip_global_norm": 35.0}
SCHEDULE = {"type": "multi_epochs_decay", "learning_rate": 0.005,
            "milestones": [2], "steps_per_epoch": 1, "factor": 10.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_streams(got, want, n=3):
    for _ in range(n):
        g, w = next(got), next(want)
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("masks", [False, True])
def test_synthetic_detection_batches_are_the_reference(masks):
    args = (3, (48, 40), 5)
    kw = dict(max_objs=6, seed=4, with_masks=masks, mask_stride=4)
    _equal_streams(ttrain.synthetic_detection_batches(*args, **kw),
                   jtrain.synthetic_detection_batches(*args, **kw))


@pytest.mark.parametrize("box_dim,features", [(7, 4), (9, 5)])
def test_synthetic_points_batches_are_the_reference(box_dim, features):
    args = (2, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0))
    kw = dict(num_points=300, max_gt=5, num_classes=10, seed=2,
              num_features=features, box_dim=box_dim)
    _equal_streams(ttrain.synthetic_points_batches(*args, **kw),
                   jtrain.synthetic_points_batches(*args, **kw))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's CLI path on the tiny CenterNet: the init from the
    first batch (``loss_from_gt``), then its ``Trainer`` over the next
    three on the 8-device mesh, every step logged. Returns the initial
    variables, the final state and the metrics records."""
    with jax.enable_x64(True):
        model = JaxCenterNet(num_classes=CLASSES, depth=18, dcn=True,
                             dtype=jnp.float64)
        batches = jtrain.synthetic_detection_batches(BATCH, HW, CLASSES)
        sample = next(batches)
        rngs = {"params": jax.random.PRNGKey(0),
                "sampling": jax.random.PRNGKey(1)}
        variables = jax.jit(lambda b: model.init(
            rngs, b, method=model.loss_from_gt))(
            jax.tree_util.tree_map(jnp.asarray, sample))
        initial = randomize_flax(variables, seed=7, offset_std=0.25)
        variables = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64), initial)
        tx = j_build_optimizer(OPTIMIZER, j_build_schedule(SCHEDULE))
        state = JTrainState.create(variables["params"],
                                   variables["batch_stats"], tx)

        def loss_apply(vs, batch, train=True):
            step_seed = batch.pop("step", jnp.zeros((), jnp.int32))
            rng = jax.random.fold_in(jax.random.PRNGKey(17), step_seed)
            return model.apply(vs, batch, train=train,
                               method=model.loss_from_gt,
                               mutable=["batch_stats"], rngs={"sampling": rng})

        out = tmp_path_factory.mktemp("jax_run")
        trainer = JTrainer(state, j_make_train_step(loss_apply),
                           mesh=create_mesh(MeshSpec(data=-1)),
                           metric_writer=JMetricWriter(str(out)),
                           log_every=1)
        final = trainer.fit(batches, num_steps=STEPS, batch_size=BATCH)
    records = [json.loads(line) for line in
               (out / "metrics.jsonl").read_text().splitlines()]
    return initial, jax.tree_util.tree_map(np.asarray, final.params), records


def _port_state(initial, dtype=torch.float64):
    model = centernet_from_flax(CenterNet(num_classes=CLASSES, dtype=dtype),
                                initial).to(dtype)
    return TrainState.create(model.train(), build_optimizer(
        OPTIMIZER, build_schedule(SCHEDULE)))


def _port_batches(skip=0):
    it = ttrain.synthetic_detection_batches(BATCH, HW, CLASSES)
    for _ in range(1 + skip):  # the sample, then the steps already taken
        next(it)
    return it


def test_trainer_fit_matches_the_reference(reference_run, tmp_path):
    initial, ref_params, ref_records = reference_run
    state = _port_state(initial)
    trainer = Trainer(state, make_train_step(ttrain.train_loss(state.model)),
                      metric_writer=MetricWriter(str(tmp_path)), log_every=1)
    trainer.fit(_port_batches(), num_steps=STEPS, batch_size=BATCH)
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    # the same keys; the reference's metrics come out of its jit sorted
    assert [set(r) for r in records] == [set(r) for r in ref_records]
    assert [r["step"] for r in records] == list(range(1, STEPS + 1))
    for got, want in zip(records, ref_records):
        for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got,
                                                                  want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-4 * want["grad_norm"]
    ref = dict(centernet_from_flax(
        CenterNet(num_classes=CLASSES).double(),
        {"params": ref_params, "batch_stats": initial["batch_stats"]},
    ).named_parameters())
    start = dict(_port_state(initial).model.named_parameters())
    bad = {}
    for name, p in state.model.named_parameters():
        if name.startswith("neck.") and name.endswith("up.bias"):
            continue  # cancelled by a train-mode BN: rounding noise on both
        theirs = ref[name].detach() - start[name].detach()
        err = float((p.detach() - ref[name].detach()).norm()
                    / theirs.norm().clamp_min(1e-30))
        if err > 1e-4:
            bad[name] = err
    assert not bad, bad


def test_trainer_resume_is_bit_for_bit(reference_run, tmp_path):
    initial = reference_run[0]
    straight = _port_state(initial)
    Trainer(straight, make_train_step(ttrain.train_loss(straight.model)),
            log_every=100).fit(_port_batches(), num_steps=STEPS)
    first = _port_state(initial)
    ckpt = CheckpointManager(str(tmp_path), save_interval_steps=100)
    Trainer(first, make_train_step(ttrain.train_loss(first.model)),
            checkpoint_manager=ckpt, log_every=100).fit(
        _port_batches(), num_steps=STEPS - 1)
    assert ckpt.latest_step() == STEPS - 1  # the forced last-step save
    resumed = _port_state(initial)
    resumed.load_state_dict(ckpt.restore())
    assert resumed.step == STEPS - 1
    Trainer(resumed, make_train_step(ttrain.train_loss(resumed.model)),
            log_every=100).fit(_port_batches(skip=STEPS - 1), num_steps=1,
                               start_step=resumed.step)
    a, b = resumed.state_dict(), straight.state_dict()
    assert a["step"] == b["step"] == STEPS
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for i, st in b["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(a["optimizer"]["state"][i][k], v), (i, k)
    assert [torch.equal(g["count"], h["count"]) for g, h in zip(
        a["optimizer"]["param_groups"], b["optimizer"]["param_groups"])] \
        == [True, True]


def test_create_train_state_and_to_device():
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    tx = build_optimizer(OPTIMIZER, build_schedule(SCHEDULE))
    batch = {"image": np.zeros((1, 8, 8, 3), np.float32),
             "step": np.asarray(3, np.int32)}
    a = create_train_state(CenterNet(num_classes=2), gen(), batch, tx)
    b = create_train_state(CenterNet(num_classes=2), gen(),
                           to_device(batch, "cpu"), tx, device="cpu")
    assert a.model.training and a.step == 0 and a.tx is tx
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        assert p.device.type == "cpu"
    moved = to_device(batch, "cpu")
    assert torch.is_tensor(moved["image"]) and moved["step"] is batch["step"]
    assert ttrain.loss_method_for(a.model).__name__ == "loss_from_gt"
