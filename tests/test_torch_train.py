"""The port's train step vs the JAX package's, f32 on the CPU.

- BN in train mode against flax ``BatchNorm(momentum=0.9)``: output and
  the running-stat update, at a size where the biased and unbiased batch
  variances differ (128 values per channel: 0.8 %).
- ``adamw`` with clip against the reference's optax chain over 3 steps,
  one of which clips.
- One full train step of ``CenterNet(num_classes=8)`` at (2, 64, 64, 3)
  from the same flax init, carried across by ``centernet_from_flax``:
  loss and parts, grad_norm, post-step params, Adam moments (through
  ``adamw_state_from_optax``) and BN running statistics.

Tolerances are stated per check; inputs are made with numpy from a seed.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from minddet_tpu.core.optim import adamw as jax_adamw
from minddet_tpu.models.detectors.centernet import CenterNet as JaxCenterNet
from minddet_tpu.train.loop import TrainState as JaxTrainState
from minddet_tpu.train.loop import make_train_step as jax_make_train_step
from minddet_tpu_torch.core.optim import adamw, global_norm
from minddet_tpu_torch.entry import train_entry
from minddet_tpu_torch.models.detectors.centernet import CenterNet
from minddet_tpu_torch.models.layers import BatchNorm, ModulatedDeformConv
from minddet_tpu_torch.train.loop import TrainState, make_train_step
from minddet_tpu_torch.utils.convert import (adamw_state_from_optax,
                                             centernet_from_flax)

LR = 5e-4
CLIP = 35.0
# added to a moment's norm before dividing: the transposed convs' biases
# feed a train-mode BN, so their gradient is zero up to rounding (~1e-9)
MOMENT_FLOOR = {"exp_avg": 1e-8, "exp_avg_sq": 1e-12}


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(a).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Output and running-stat update of one train-mode call. f32: output
    atol 1e-5, stats atol 1e-6. bf16 input: the statistics are f32 on both
    sides (atol 1e-5); the output is rounded to bf16 once (atol 2e-2)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 8, 8, 16) * 2 + 0.5).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": rs.uniform(0.5, 1.5, 16).astype(
                                np.float32),
                            "bias": rs.randn(16).astype(np.float32)},
                 "batch_stats": {"mean": rs.randn(16).astype(np.float32),
                                 "var": rs.uniform(0.5, 2, 16).astype(
                                     np.float32)}}
    ref, mutated = bn.apply(variables, xj, mutable=["batch_stats"])

    port = BatchNorm(16, eps=1e-5).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        port.running_mean.copy_(
            torch.from_numpy(variables["batch_stats"]["mean"]))
        port.running_var.copy_(
            torch.from_numpy(variables["batch_stats"]["var"]))
    tdt = getattr(torch, dtype)
    xt = _nchw(np.asarray(xj.astype(jnp.float32)), tdt)
    got = port(xt)
    assert got.dtype == tdt
    stats_tol = 1e-6 if dtype == "float32" else 1e-5
    for name, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mutated["batch_stats"][name]),
                                   rtol=0, atol=stats_tol, err_msg=name)
    out_tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(ref.astype(jnp.float32)), rtol=0, atol=out_tol)
    # the update stores the biased variance: torch's unbiased one is off
    xf = xt.float()
    unbiased = 0.9 * torch.from_numpy(variables["batch_stats"]["var"]) \
        + 0.1 * xf.var(dim=(0, 2, 3), unbiased=True)
    assert (unbiased - port.running_var).abs().max() > 100 * stats_tol


class _Toy(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


def test_adamw_with_clip_matches_optax():
    """3 steps of AdamW(5e-4, wd 0.01 on ndim > 1 only) after clip-by-
    global-norm 35; step 2's gradients have norm ~100, so the clip fires
    there only. Params, moments and the pre-clip norm: atol 1e-7 / rtol
    1e-6 (f32, one rounding apart)."""
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(6, 5).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (1.0, 20.0, 0.3)]
    tx = jax_adamw(LR, clip_global_norm=CLIP)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    toy = _Toy(params["w"], params["b"])
    recipe = adamw(LR, clip_global_norm=CLIP)
    opt = recipe.init(toy)
    norms = []
    for g in grads:
        norms.append(float(optax.global_norm(g)))
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        toy.w.grad = torch.from_numpy(g["w"].copy())
        toy.b.grad = torch.from_numpy(g["b"].copy())
        norm = recipe.update(opt, toy.parameters())
        np.testing.assert_allclose(float(norm), norms[-1], rtol=1e-6)
    assert norms[1] > CLIP > max(norms[0], norms[2])
    adam = jstate[1][0]  # chain(clip, chain(scale_by_adam, decay, lr))
    for name, p in (("w", toy.w), ("b", toy.b)):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        st = opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(adam.mu[name]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[name]), rtol=1e-6,
                                   atol=1e-9)
        assert float(st["step"]) == float(adam.count) == 3
    assert float(global_norm([toy.w.detach(), toy.b.detach()])) == pytest.approx(
        float(optax.global_norm(jparams)), rel=1e-6)


def _gt_batch(seed=1):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 40, (2, 6, 2))
    wh = rs.uniform(6, 24, (2, 6, 2))
    return {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_classes": rs.randint(0, 8, (2, 6)).astype(np.int32),
            "gt_mask": np.array([[1] * 5 + [0], [1] * 3 + [0] * 3], bool)}


def _one_step(compute):
    """The same flax init and batch through one JAX train step and one port
    train step, with f32 parameters and ``compute`` ("float32" or
    "float64") as the model's compute dtype."""
    with jax.enable_x64(compute == "float64"):
        jmodel = JaxCenterNet(num_classes=8, depth=18, dcn=True,
                              dtype=jnp.dtype(compute))
        variables = jax.device_get(jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        tx = jax_adamw(LR, clip_global_norm=CLIP)
        jstate = JaxTrainState.create(variables["params"],
                                      variables["batch_stats"], tx)

        def loss_apply(v, batch, train=True):
            return jmodel.apply(v, batch, train=train,
                                method=jmodel.loss_from_gt,
                                mutable=["batch_stats"])

        batch = _gt_batch()
        new_jstate, jmetrics = jax_make_train_step(loss_apply, donate=False)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        new_jstate, jmetrics = jax.device_get((new_jstate, jmetrics))

    model = CenterNet(num_classes=8, dtype=getattr(torch, compute))
    model = centernet_from_flax(model, variables).to(
        memory_format=torch.channels_last)
    state = TrainState.create(model, adamw(LR, clip_global_norm=CLIP))
    step = make_train_step(lambda m, b: m.loss_from_gt(b))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = step(state, tbatch)
    return new_jstate, jmetrics, state, metrics, old


@pytest.fixture(scope="module")
def one_step():
    return _one_step("float32")


@pytest.fixture(scope="module")
def one_step_f64():
    return _one_step("float64")


def _state_errors(step):
    """Errors of the port's post-step state against the JAX state carried
    across by the converters, per tensor: "<param>:update", the relative
    L2 error of the param's update p_new - p_old; "<buffer>", the max abs
    error of a BN running statistic; "<param>:exp_avg" and
    "<param>:exp_avg_sq", the L2 error of each Adam moment relative to the
    moment's norm plus MOMENT_FLOOR."""
    new_jstate, _, state, _, old = step
    ref = centernet_from_flax(
        CenterNet(num_classes=8),
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
        mine = got[name].detach() - old[name]
        theirs = r.detach() - old[name]
        errs[f"{name}:update"] = float((mine - theirs).norm() / theirs.norm())
        m_state = state.optimizer.state[got[name]]
        r_state = ref_opt.state[r]
        assert float(m_state["step"]) == float(r_state["step"]) == 1.0
        for field in ("exp_avg", "exp_avg_sq"):
            errs[f"{name}:{field}"] = float(
                (m_state[field] - r_state[field]).norm()
                / (r_state[field].norm() + MOMENT_FLOOR[field]))
    return errs


@pytest.mark.parametrize("compute", ["float32", "float64"])
def test_train_step_metrics_match_jax(compute, request):
    """Loss and parts rtol 1e-5 (the losses are f32 on both sides, and the
    forward is continuous through its kinks). grad_norm, the norm of ~60
    gradients each summed over the batch in another order: rtol 1e-4 with f64
    compute; 1e-3 with f32 compute, where a ReLU input within rounding of
    zero may take the other branch and move the gradients upstream of it
    (see ``test_train_step_state_matches_jax``)."""
    fixture = "one_step" if compute == "float32" else "one_step_f64"
    _, jmetrics, state, metrics, _ = request.getfixturevalue(fixture)
    assert set(metrics) == set(jmetrics) == {"loss", "hm_loss", "wh_loss",
                                             "off_loss", "grad_norm"}
    for name in ("loss", "hm_loss", "wh_loss", "off_loss"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]),
                               rtol=1e-3 if compute == "float32" else 1e-4)
    assert state.step == 1 and float(jmetrics["grad_norm"]) > CLIP


def _noise_only(name: str) -> bool:
    """The neck's transposed-conv biases feed a train-mode BN, which
    cancels them: their gradient is zero up to rounding, and Adam's first
    step turns that noise into +-lr, so their update is not compared."""
    return name.startswith("neck.") and name.endswith("up.bias:update")


def test_train_step_state_matches_jax_f64_compute(one_step_f64):
    """With f64 compute (f32 params and losses) no ReLU input lies within
    rounding of zero, so both steps take the same branches and agree
    tightly: each param's update within 1e-3 relative L2 (a first Adam
    step is ~lr * sign(g), so the few elements with |g| near the f32 noise
    of the loss gradient differ), each Adam moment within 1e-4, each BN
    running statistic within atol 1e-6."""
    errs = _state_errors(one_step_f64)
    limit = lambda k: (1e-3 if k.endswith(":update") else
                       1e-4 if ":" in k else 1e-6)
    bad = {k: v for k, v in errs.items() if v > limit(k)
           and not _noise_only(k)}
    assert not bad, bad


def test_train_step_state_matches_jax(one_step):
    """f32 compute. BN running statistics come from the forward: atol
    1e-5. The backward runs through some 80k ReLU inputs, and a few lie
    within the two implementations' forward rounding of zero (after batch
    statistics over only 8 values per channel in the deepest layers); one
    that takes the other branch (one does at this init, in the neck)
    changes every gradient upstream of it by a few percent, and Adam's
    first step (~lr * sign(g)) turns that into large update differences
    for small tensors. So here the Adam moments are held to a kink-sized
    1e-1 relative L2 and the updates not at all; the f64-compute test
    holds both tight.
    """
    errs = _state_errors(one_step)
    bad = {k: v for k, v in errs.items()
           if not k.endswith(":update")
           and v > (1e-1 if ":" in k else 1e-5)
           and not (k.startswith("neck.") and "up.bias" in k)}
    assert not bad, bad


def test_offset_convs_get_gradients_at_init(one_step):
    """At flax init every offset conv is zero, so every sample sits on the
    integer grid; the (dy, dx) channels must still get a gradient (the
    reference's Pallas backward gives them none) and move."""
    state = one_step[2]
    dcns = [m for m in state.model.modules()
            if isinstance(m, ModulatedDeformConv)]
    assert len(dcns) == 9
    for m in dcns:
        grad = m.conv_offset.weight.grad  # (3K, Cin, 3, 3): (dy, dx) first
        assert grad[:18].abs().max() > 0
        assert m.conv_offset.weight[:18].abs().max() > 0


def test_adamw_state_from_optax_rejects_a_mismatch(one_step):
    new_jstate, state = one_step[0], one_step[2]
    bad = jax.tree_util.tree_map(lambda a: a, new_jstate.opt_state)
    adam = bad[1][0]
    mu = jax.tree_util.tree_map(lambda a: a, adam.mu)
    mu["head"]["hm"]["spare"] = np.zeros(3, np.float32)
    bad = (bad[0], (adam._replace(mu=mu),) + tuple(bad[1][1:]))
    with pytest.raises(ValueError, match="no port tensor"):
        adamw_state_from_optax(state.model, state.optimizer, bad)
    with pytest.raises(ValueError, match="one Adam state"):
        adamw_state_from_optax(state.model, state.optimizer, (None,))


def test_train_entry_builds_the_flagship_step_on_cpu_when_asked():
    """``train_entry`` builds (no step: the full-width model at 512x512 is
    for the card): f32 params, bf16 compute, targets on the device."""
    step_fn, (state, batch) = train_entry(device="cpu", batch=2)
    model = state.model
    assert callable(step_fn) and model.training
    assert model.dtype == torch.bfloat16 and model.num_classes == 80
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert batch["image"].shape == (2, 512, 512, 3)
    t = batch["targets"]
    assert t["hm"].shape == (2, 128, 128, 80) and t["ind"].dtype == torch.long
    assert float(t["reg_mask"].sum()) == 16 and float(t["hm"].max()) == 1.0
    assert state.tx.clip_global_norm == CLIP
    assert state.tx.learning_rate == LR
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_entry()
