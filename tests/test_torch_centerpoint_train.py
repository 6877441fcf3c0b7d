"""The port's CenterPoint train path vs the JAX package's, on the CPU.

- ``MaskedBatchNorm`` in train mode against the flax module: output,
  gradient (it flows through the masked statistics) and the running-stat
  update; and the refine head, whose BN takes the statistics of every row,
  against the flax ``BEVRefineHead`` with ``nn.BatchNorm``.
- ``loss_from_gt`` of the one- and the two-stage model on the tiny model of
  ``test_torch_centerpoint.py`` (grid 64x64, two tasks, a two-layer PFN so
  that the segment max and its backward are on the path, 16 proposals), f32:
  every part of the loss.
- One whole train step (AdamW 1e-3, clip 35) of the two-stage model with
  f64 compute over f32 parameters: loss parts, grad_norm, the parameters'
  updates, the Adam moments (the clipped gradients) and the BN running
  statistics.

The ground-truth boxes are jittered copies of the model's own training
proposals, so that the second stage has foreground proposals (IoU >= 0.55)
and background ones, none within 1e-3 of the threshold. Inputs come from
numpy seeds; the flax variables go to the port through
``centerpoint_from_flax``. The JAX programs run jitted (compiling the tiny
train step takes ~10 s, running it op by op a minute).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_centerpoint import TINY, _clouds, _cp_variables
from test_torch_pointpillars import random_variables

from minddet_tpu.core.optim import adamw as jax_adamw
from minddet_tpu.models.detectors.centerpoint import (
    CenterPoint as JCenterPoint)
from minddet_tpu.models.detectors.centerpoint import (
    CenterPointTwoStage as JCenterPointTwoStage)
from minddet_tpu.models.heads.second_stage import (
    BEVRefineHead as JBEVRefineHead)
from minddet_tpu.models.readers.pillar_encoder import (
    MaskedBatchNorm as JMaskedBatchNorm)
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch.core.optim import adamw
from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS, centerpoint_loss,
                                     centerpoint_train_entry)
from minddet_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointTwoStage)
from minddet_tpu_torch.models.heads.second_stage import BEVRefineHead
from minddet_tpu_torch.models.readers.pillar_encoder import MaskedBatchNorm
from minddet_tpu_torch.ops.rotated_iou import rotated_iou_bev
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.utils.convert import (adamw_state_from_optax,
                                             centerpoint_from_flax,
                                             load_from_flax)

LR = 1e-3
CLIP = 35.0
PROPOSALS = 16
GT_SLOTS = 12
FG_IOU = 0.55
MOMENT_FLOOR = {"exp_avg": 1e-8, "exp_avg_sq": 1e-12}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batchnorm_train_matches_flax(dtype):
    """One train-mode call over a masked (2, 50, 8) stream. f32: output and
    input gradient atol 1e-5, running statistics 1e-6. bf16 input: the
    statistics are f32 sums of the same bf16 values on both sides (1e-5);
    the output is x * a + b in bf16 with a, b rounded to bf16 (2e-2)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 50, 8) * 2 + 0.5).astype(np.float32)
    mask = rs.rand(2, 50) < 0.7
    g = rs.randn(2, 50, 8).astype(np.float32)
    jdt = jnp.dtype(dtype)
    variables = {"params": {"scale": rs.uniform(0.5, 1.5, 8).astype(
                                np.float32),
                            "bias": rs.randn(8).astype(np.float32)},
                 "batch_stats": {"mean": rs.randn(8).astype(np.float32),
                                 "var": rs.uniform(0.5, 2, 8).astype(
                                     np.float32)}}
    bn = JMaskedBatchNorm(dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)

    def f(v):
        out, mutated = bn.apply(variables, v, jnp.asarray(mask), train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), (out,
                                                                    mutated)

    (_, (ref, mutated)), ref_dx = jax.value_and_grad(f, has_aux=True)(xj)

    port = MaskedBatchNorm(8).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(
            torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(
            torch.from_numpy(variables["batch_stats"]["var"]))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        tdt).requires_grad_()
    got = port(xt, torch.from_numpy(mask))
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert got.dtype == tdt
    stats_tol = 1e-6 if dtype == "float32" else 1e-5
    for name, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mutated["batch_stats"][name]),
                                   rtol=0, atol=stats_tol, err_msg=name)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(ref_dx.astype(jnp.float32)),
                               rtol=0, atol=tol)
    # the statistics cover the masked rows only
    masked = port.running_mean.clone()
    port.running_mean.copy_(
        torch.from_numpy(variables["batch_stats"]["mean"]))
    port(xt.detach(), torch.ones(2, 50, dtype=torch.bool))
    assert (port.running_mean - masked).abs().max() > 100 * stats_tol


def test_refine_head_train_matches_flax():
    """``BEVRefineHead`` in train mode (BN statistics over all B * N rows,
    flax momentum 0.99, eps 1e-3): outputs 1e-5, running statistics 1e-6,
    the features' gradient 1e-5."""
    rs = np.random.RandomState(1)
    feats = rs.randn(2, 16, 40).astype(np.float32)
    jhead = JBEVRefineHead(hidden=12)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               jnp.asarray(feats)))
    variables = random_variables(
        {"params": dict(shapes["params"]),
         "batch_stats": dict(shapes["batch_stats"])}, seed=1)

    def f(v):
        (slog, deltas), mutated = jhead.apply(variables, v, train=True,
                                              mutable=["batch_stats"])
        return jnp.sum(slog) + jnp.sum(deltas * deltas), (slog, deltas,
                                                          mutated)

    (_, (slog, deltas, mutated)), ref_g = jax.value_and_grad(
        f, has_aux=True)(jnp.asarray(feats))
    port = load_from_flax(BEVRefineHead(40, hidden=12), variables).train()
    ft = torch.from_numpy(feats).requires_grad_()
    s, d = port(ft)
    (s.sum() + (d * d).sum()).backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(slog),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(deltas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-5)
    ref = load_from_flax(BEVRefineHead(40, hidden=12),
                         {"params": variables["params"],
                          "batch_stats": mutated["batch_stats"]})
    for name, buf in ref.named_buffers():
        np.testing.assert_allclose(port.get_buffer(name).numpy(),
                                   buf.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        old = np.asarray(variables["batch_stats"][name.split(".")[0]][
            "mean" if name.endswith("mean") else "var"])
        assert np.abs(buf.numpy() - old).max() > 1e-4  # the update moved it


def _gt_from_proposals(variables, pts, mask):
    """Ground truth made of the model's own training proposals: per cloud
    the first 8 proposals, the even ones nearly in place (foreground), the
    odd ones shifted by 0.7 m (background, IoU > 0), every coordinate
    jittered, in ``GT_SLOTS`` slots; classes 1..3 over the two tasks."""
    rs = np.random.RandomState(5)
    port = centerpoint_from_flax(
        CenterPointTwoStage(**TINY, num_proposals=PROPOSALS), variables)
    port.train()
    with torch.no_grad():
        bev = port.bev_from_points_stream(torch.from_numpy(pts),
                                          torch.from_numpy(mask))
        boxes = port.proposals(port.head(bev)).numpy()
    b = boxes.shape[0]
    gt = np.zeros((b, GT_SLOTS, 9), np.float32)
    gt[:, :8] = boxes[:, :8]
    gt[:, :8, :2] += rs.uniform(-0.05, 0.05, (b, 8, 2))
    gt[:, 1:8:2, 0] += 0.7
    gt[:, :8, 8] += rs.uniform(-0.03, 0.03, (b, 8))
    # z, sizes and velocities off the decoded values too: the L1 loss has
    # its kink where a prediction equals its target
    gt[:, :8, 2] += rs.uniform(0.05, 0.2, (b, 8))
    gt[:, :8, 3:6] *= rs.uniform(1.02, 1.08, (b, 8, 3))
    gt[:, :8, 6:8] += rs.uniform(0.05, 0.2, (b, 8, 2))
    gt_mask = np.zeros((b, GT_SLOTS), bool)
    gt_mask[:, :8] = True
    bev5 = [0, 1, 3, 4, 8]
    iou = rotated_iou_bev(torch.from_numpy(boxes[..., bev5]).contiguous(),
                          torch.from_numpy(gt[:, :8][..., bev5]).contiguous())
    batch = {"points": pts, "points_mask": mask, "gt_boxes": gt,
             "gt_classes": rs.randint(1, 4, (b, GT_SLOTS)).astype(np.int32),
             "gt_mask": gt_mask}
    return batch, iou.max(-1).values.numpy()


def _setup(compute):
    """The tiny two-stage model on both sides with ``compute`` ("float32" or
    "float64") as the compute dtype over f32 parameters: the loss and its
    parts of both ``loss_from_gt``, and one train step."""
    pts, mask = _clouds()
    with jax.enable_x64(compute == "float64"):
        jdt = jnp.dtype(compute)
        jm = JCenterPointTwoStage(**TINY, num_proposals=PROPOSALS, dtype=jdt)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
            method=jm.predict_refined))
        variables = _cp_variables(
            {"params": dict(shapes["params"]),
             "batch_stats": dict(shapes["batch_stats"])}, 3, pts, mask)
        batch, miou = _gt_from_proposals(variables, pts, mask)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_apply(v, b, train=True):
            return jm.apply(v, b, train=train, method=jm.loss_from_gt,
                            mutable=["batch_stats"])

        tx = jax_adamw(LR, clip_global_norm=CLIP)
        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)
        new_jstate, jmetrics = jax.device_get(jax_make_train_step(
            loss_apply, donate=False)(jstate, jbatch))
        single = None
        if compute == "float32":
            j1 = JCenterPoint(**{k: v for k, v in TINY.items()
                                 if k != "refine_hidden"}, dtype=jdt)
            v1 = {"params": {k: v for k, v in variables["params"].items()
                             if k != "refine"},
                  "batch_stats": {k: v for k, v in
                                  variables["batch_stats"].items()
                                  if k != "refine"}}
            (total1, parts1), _ = jax.jit(lambda v, b: j1.apply(
                v, b, train=True, method=j1.loss_from_gt,
                mutable=["batch_stats"]))(v1, jbatch)
            port1 = centerpoint_from_flax(CenterPoint(**{
                k: v for k, v in TINY.items() if k != "refine_hidden"}),
                v1).train()
            single = (jax.device_get((total1, parts1)), port1)

    model = centerpoint_from_flax(
        CenterPointTwoStage(**TINY, num_proposals=PROPOSALS,
                            dtype=getattr(torch, compute)), variables)
    model = model.to(memory_format=torch.channels_last)
    state = TrainState.create(model, adamw(LR, clip_global_norm=CLIP))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(centerpoint_loss)(state, tbatch)
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, state=state,
                metrics=metrics, old=old, single=single, tbatch=tbatch,
                miou=miou)


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.fixture(scope="module")
def f64():
    return _setup("float64")


PARTS = ("task0_hm", "task0_loc", "task1_hm", "task1_loc", "stage2_score",
         "stage2_box")


@pytest.mark.parametrize("compute", ["float32", "float64"])
def test_two_stage_loss_parts_match_jax(compute, request):
    """``CenterPointTwoStage.loss_from_gt`` in train mode: the total and
    every part rtol 1e-4 (f32 conv layers and sums in another order than
    XLA's; the losses are f32 on both sides)."""
    s = request.getfixturevalue("f32" if compute == "float32" else "f64")
    metrics, jmetrics = s["metrics"], s["jmetrics"]
    assert set(metrics) == set(jmetrics) == {"loss", "grad_norm", *PARTS}
    for name in ("loss",) + PARTS:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-4,
                                   err_msg=name)
    assert float(jmetrics["stage2_box"]) > 1e-3  # there is foreground
    assert float(jmetrics["task1_loc"]) > 0 and s["state"].step == 1


def test_proposals_have_foreground_and_background_off_the_threshold(f32):
    miou = f32["miou"]
    assert miou.shape == (2, PROPOSALS)
    assert (miou >= FG_IOU).sum() >= 4 and (miou < FG_IOU).sum() >= 4
    assert ((miou > 0) & (miou < FG_IOU)).any()
    assert np.abs(miou - FG_IOU).min() > 1e-3
    assert np.abs(miou - 0.25).min() > 1e-4  # the score target's kinks
    assert np.abs(miou - 0.75).min() > 1e-4


def test_single_stage_loss_matches_jax(f32):
    """``CenterPoint.loss_from_gt``: the same code without the second
    stage; rtol 1e-4."""
    (jtotal, jparts), port = f32["single"]
    total, parts = port.loss_from_gt(f32["tbatch"])
    assert set(parts) == set(jparts) == set(PARTS[:4])
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    for name, v in jparts.items():
        np.testing.assert_allclose(float(parts[name].detach()), float(v),
                                   rtol=1e-4, err_msg=name)
    # the two-stage loss is this one plus its two parts
    m = f32["jmetrics"]
    np.testing.assert_allclose(
        float(jtotal) + float(m["stage2_score"]) + float(m["stage2_box"]),
        float(m["loss"]), rtol=1e-5)


def _state_errors(s):
    """Errors of the port's post-step state against the JAX state carried
    across by the converters, per tensor: "<param>:update", the relative
    L2 error of p_new - p_old over the elements with a clear gradient;
    "<buffer>", the max abs error of a BN running
    statistic; "<param>:exp_avg" / ":exp_avg_sq", the L2 error of an Adam
    moment relative to its norm plus MOMENT_FLOOR."""
    new_jstate, state, old = s["new_jstate"], s["state"], s["old"]
    ref = centerpoint_from_flax(
        CenterPointTwoStage(**TINY, num_proposals=PROPOSALS),
        {"params": new_jstate.params, "batch_stats": new_jstate.batch_stats})
    got = dict(state.model.named_parameters())
    got.update(state.model.named_buffers())
    errs = {}
    for name, r in ref.named_buffers():
        if not name.endswith("num_batches_tracked"):
            errs[name] = float((got[name] - r).abs().max())
    ref_opt = adamw(LR, clip_global_norm=CLIP).init(ref)
    adamw_state_from_optax(ref, ref_opt, new_jstate.opt_state)
    for name, r in ref.named_parameters():
        m_state = state.optimizer.state[got[name]]
        r_state = ref_opt.state[r]
        # a first Adam step is ~lr * sign(g): an element whose gradient is
        # within rounding of zero moves by +-lr on either side, so the
        # updates are compared where |g| > 1e-5 of the tensor's largest
        g = r_state["exp_avg"].abs()
        clear = g > 1e-5 * g.max()
        mine = (got[name].detach() - old[name])[clear]
        theirs = (r.detach() - old[name])[clear]
        errs[f"{name}:update"] = float((mine - theirs).norm() / theirs.norm())
        assert float(m_state["step"]) == float(r_state["step"]) == 1.0
        for field in ("exp_avg", "exp_avg_sq"):
            errs[f"{name}:{field}"] = float(
                (m_state[field] - r_state[field]).norm()
                / (r_state[field].norm() + MOMENT_FLOOR[field]))
    return errs


def _noise_only(key: str) -> bool:
    """A conv bias that feeds a train-mode BN is cancelled by it: its
    gradient is zero up to rounding, and Adam's first step turns that noise
    into +-lr. The head's ``*_conv0`` and ``shared_conv`` have such a bias."""
    name = key.split(":")[0]
    return name.endswith("_conv0.bias") or name.endswith("shared_conv.bias")


def test_train_step_state_matches_jax_f64_compute(f64):
    """With f64 compute no ReLU input, sample coordinate or IoU lies within
    rounding of a kink, so both steps take the same branches: grad_norm
    rtol 1e-4; each parameter's update within 1e-3 relative L2 (a first
    Adam step is ~lr * sign(g)); each Adam moment, i.e. each clipped
    gradient, within 1e-4; each BN running statistic within atol 1e-6. Every
    parameter has a gradient: through the row gather's backward into the
    BEV map, and through the segment max's into the first PFN layer."""
    np.testing.assert_allclose(float(f64["metrics"]["grad_norm"]),
                               float(f64["jmetrics"]["grad_norm"]), rtol=1e-4)
    assert float(f64["jmetrics"]["grad_norm"]) > CLIP  # the clip fired
    errs = _state_errors(f64)
    limit = lambda k: (1e-3 if k.endswith(":update") else
                       1e-4 if ":" in k else 1e-6)
    bad = {k: v for k, v in errs.items() if v > limit(k)
           and not _noise_only(k)}
    assert not bad, bad
    model = f64["state"].model
    for name, p in model.named_parameters():
        # (an L1 loss's bias gradient is a sum of signs, which may cancel)
        assert p.grad is not None, name
        assert p.ndim == 1 or p.grad.abs().max() > 0, name


def test_train_step_state_matches_jax(f32):
    """f32 compute: BN running statistics atol 1e-5 (they come from the
    forward); the Adam moments are held to a kink-sized 1e-1 relative L2
    (a ReLU input within the two implementations' rounding of zero moves
    every gradient upstream of it) and the updates not at all; the
    f64-compute test holds both tight."""
    errs = _state_errors(f32)
    bad = {k: v for k, v in errs.items()
           if not k.endswith(":update") and not _noise_only(k)
           and v > (1e-1 if ":" in k else 1e-5)}
    assert not bad, bad


def test_second_stage_gradient_reaches_the_bev_map_only_through_x(f32):
    """The proposals are decoded from detached maps: the second stage's
    losses give the head no gradient, and the refine head gets one."""
    model = copy.deepcopy(f32["state"].model).train()
    batch = f32["tbatch"]
    model.zero_grad()
    bev = model.bev_from_points_stream(batch["points"], batch["points_mask"])
    preds = model.head(bev)
    stage2 = model.stage2_loss(bev, model.proposals(preds), batch)
    (stage2["stage2_score"] + stage2["stage2_box"]).backward()
    assert all(p.grad is None for p in model.head.parameters())
    assert model.refine.fc0.weight.grad.abs().max() > 0
    assert model.rpn.up2_deconv.weight.grad.abs().max() > 0
    assert model.reader.pfn0.linear.weight.grad.abs().max() > 0


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        centerpoint_train_entry()


def test_train_entry_builds_the_two_stage_step_on_cpu_when_asked():
    """``centerpoint_train_entry`` builds (no step: the full-width model on
    120,000 points is for the card): f32 parameters, bf16 compute, train
    mode, the lidar batch of the reference's recipe."""
    step_fn, (state, batch) = centerpoint_train_entry(device="cpu", batch=1)
    model = state.model
    assert callable(step_fn) and model.training
    assert isinstance(model, CenterPointTwoStage)
    assert model.dtype == model.reader.dtype == model.refine.dtype \
        == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (model.num_proposals, model.fg_iou, model.grid_ny,
            model.max_voxels, model.max_points_per_voxel) == (
        128, 0.55, 512, 30000, 20)
    assert batch["points"].shape == (1, NUSC_CLOUD_POINTS, 5)
    assert batch["gt_boxes"].shape == (1, 64, 9)
    assert batch["gt_classes"].dtype == torch.int32
    assert 1 <= int(batch["gt_mask"].sum()) <= 63
    assert state.tx.clip_global_norm == CLIP and state.tx.learning_rate == LR
    example = model._stage1_example(batch)
    assert [t.shape for t in example["hm"]] == [
        (1, 128, 128, n) for n in (1, 2, 2, 1, 2, 2)]
    assert sum(float(m.sum()) for m in example["mask"]) == float(
        batch["gt_mask"].sum())
