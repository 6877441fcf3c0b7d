"""The port's segmentors, their loss, mIoU, schedule and optimizer vs the
JAX package's, on the CPU.

- ``ASPP`` alone at f64 (16 channels -> 8, rates 6, 12, 18) on a 40 x 40
  map, wider than 37, so every dilated tap reaches real pixels: eval mode,
  and train mode with the BN statistics' update, within 1e-10 of the
  largest value.
- ``DeepLabV3Plus(depth=18)`` and ``DeepLabV3(depth=18)`` at 64 x 64 and
  ``UNet(widths=(8, 16, 32))`` at 32 x 32, batch 2, weights through
  ``load_from_flax`` (numpy-random flax variables widened to f64), f64
  compute on both sides: one train step's (the port's ``loss(batch)``)
  logits and loss (the logits are cast to f32 on both sides, as the
  reference casts them, so 1e-6 of the largest), every parameter's
  gradient (1e-5 of its largest element), the BN running statistics after
  the step (1e-10: before the cast), then eval-mode logits on those
  statistics (1e-6) and ``predict`` (equal wherever the reference's top
  two logits lie more than 1e-4 apart). DeepLabV3+'s program also
  holds its backbone, ResNet-18 at output stride 16, as
  ``test_torch_resnet_dilation.py`` holds the other depths and strides:
  C2-C5 in the step and in eval mode at 1e-10. The reference runs
  jitted, its loss, mIoU and optimizer too.
- ``segmentation_loss`` with and without dice, with labels 255 and -1 under
  ``valid`` True and False (``jax.nn.one_hot`` gives them a zero row, and
  a valid one still counts in the denominator; ``F.one_hot`` would raise),
  f32 at 1e-6, its gradient too; ``miou`` with indices past the last bin
  (dropped, where ``torch.bincount`` would grow) and negative ones (counted
  in bin 0, as ``jnp.bincount`` clips them), exactly.
- ``polynomial_decay`` (DeepLab's) against the reference's at counts 0, 1,
  15000, 29999, 30000 and 40000, with and without warm-up (f32, 1e-6: the
  two f32 ``pow``s differ by ulps); one ``adam``
  step and three guarded Adam steps under a schedule, the middle one with
  a NaN gradient, against ``optax.apply_if_finite(optax.adam(...))`` in
  f64: parameters, both moments and the counts.
- The train entries' settings against the configs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from test_torch_yolov8 import _assert_close, _flax_variables, _nchw, _nhwc

from minddet_tpu.core.lr_schedules import polynomial_decay as j_poly
from minddet_tpu.core.lr_schedules import warmup_cosine as j_warmup_cosine
from minddet_tpu.core.optim import build_optimizer
from minddet_tpu.models import segmentors as jseg
from minddet_tpu_torch import entry
from minddet_tpu_torch.core.lr_schedules import (polynomial_decay,
                                                  warmup_cosine)
from minddet_tpu_torch.core.optim import adam, skip_nonfinite_updates
from minddet_tpu_torch.models import segmentors as tseg
from minddet_tpu_torch.utils.convert import load_from_flax

F64_RTOL = 1e-10
F32_RTOL = 1e-6   # past the reference's cast of the logits to f32
GRAD_RTOL = 1e-5  # of a parameter's largest gradient element
ARGMAX_MARGIN = 1e-4
# f32 pow: torch's and XLA's differ by a few ulps (3 at count 29999)
POW_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _model_run.cache_clear()


def _flat_stats(tree, prefix=()):
    """flax ``batch_stats`` -> {port buffer name: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_stats(v, prefix + (k,)))
        else:
            name = {"mean": "running_mean", "var": "running_var"}[k]
            out[".".join(prefix + (name,))] = np.asarray(v)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_aspp_matches_jax_f64(train):
    x = np.random.RandomState(3).randn(2, 40, 40, 16)
    jm = jseg.ASPP(8, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(x), seed=3)
        ref, mutated = jax.jit(lambda v, a: jm.apply(
            v, a, train=train, mutable=["batch_stats"]))(
                variables, jnp.asarray(x))
        ref, stats = jax.device_get((ref, mutated["batch_stats"]))
    port = load_from_flax(tseg.ASPP(16, 8).double(), variables).train(train)
    assert tseg.ASPP_RATES == tuple(jm.rates) == (6, 12, 18)
    with torch.no_grad():
        got = port(_nchw(x))
    _assert_close(_nhwc(got), ref, F64_RTOL)
    for n, want in _flat_stats(stats).items():
        _assert_close(port.get_buffer(n).numpy(), want, F64_RTOL)


# name -> (JAX model at a dtype, port model, side, classes)
MODELS = {
    "deeplabv3plus": (lambda dt: jseg.DeepLabV3Plus(num_classes=5, depth=18,
                                                    dtype=dt),
                      lambda: tseg.DeepLabV3Plus(num_classes=5, depth=18,
                                                 dtype=torch.float64),
                      64, 5),
    "deeplabv3": (lambda dt: jseg.DeepLabV3(num_classes=5, depth=18,
                                            dtype=dt),
                  lambda: tseg.DeepLabV3(num_classes=5, depth=18,
                                         dtype=torch.float64), 64, 5),
    "unet": (lambda dt: jseg.UNet(num_classes=3, widths=(8, 16, 32),
                                  dtype=dt),
             lambda: tseg.UNet(num_classes=3, widths=(8, 16, 32),
                               dtype=torch.float64), 32, 3),
}


def _is_backbone(module, method):
    return module.name == "backbone" and method == "__call__"


@functools.lru_cache(maxsize=None)
def _model_run(name):
    """Both packages' train step (logits, loss, gradients, statistics) and
    eval-mode logits and ``predict`` on one batch, f64 compute; the
    backbone's C2-C5 in the step and in eval mode where the model has
    one."""
    make_j, make_t, side, classes = MODELS[name]
    rs = np.random.RandomState(sorted(MODELS).index(name))
    image = rs.randn(2, side, side, 3)
    mask = rs.randint(0, classes, (2, side, side)).astype(np.int32)
    mask[0, :3] = 255  # ignored pixels the valid mask marks
    valid = mask != 255
    jm = make_j(jnp.float64)
    with jax.enable_x64(True):
        variables = _flax_variables(jm, jnp.asarray(image), seed=7)
        img, m, v = (jnp.asarray(a) for a in (image, mask, valid))

        def loss(params):
            logits, mutated = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                img, train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=_is_backbone)
            total, parts = jseg.segmentation_loss(logits, m, v)
            return total, (logits, parts, mutated)

        def step_then_eval(params):
            (total, (logits, parts, mutated)), grads = jax.value_and_grad(
                loss, has_aux=True)(params)
            # eval mode on the statistics the step left
            var = {"params": params, "batch_stats": mutated["batch_stats"]}
            eval_logits, captured = jm.apply(
                var, img, mutable=["intermediates"],
                capture_intermediates=_is_backbone)
            return dict(total=total, logits=logits, parts=parts,
                        stats=mutated["batch_stats"], grads=grads,
                        eval_logits=eval_logits,
                        pred=jm.apply(var, img, method=jm.predict),
                        features={"train": _backbone_out(mutated),
                                  "eval": _backbone_out(captured)})

        ref = jax.device_get(jax.jit(step_then_eval)(variables["params"]))
    port = load_from_flax(make_t().double(), variables).train()
    batch = {"image": torch.from_numpy(image),
             "mask": torch.from_numpy(mask), "valid": torch.from_numpy(valid)}
    outputs, features = [], []
    hooks = [port.register_forward_hook(
        lambda m, a, out: outputs.append(out))]
    if hasattr(port, "backbone"):
        hooks.append(port.backbone.register_forward_hook(
            lambda m, a, out: features.append([f.detach() for f in out])))
    got_total, got_parts = port.loss(batch)
    got_total.backward()
    port.eval()
    with torch.no_grad():
        got_eval = port(batch["image"])
        got_pred = port.predict(batch["image"])
    for h in hooks:
        h.remove()
    return ref, variables, port, dict(
        total=got_total.detach(), logits=outputs[0].detach(),
        parts={k: v.detach() for k, v in got_parts.items()},
        eval_logits=got_eval, pred=got_pred,
        features=dict(zip(("train", "eval"), features)))


def _backbone_out(mutated):
    tree = mutated.get("intermediates", {})
    return tree["backbone"]["__call__"][0] if "backbone" in tree else None


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_run(request):
    return _model_run(request.param)


def test_model_logits_and_loss_match_jax(model_run):
    ref, _, port, got = model_run
    assert got["logits"].dtype == torch.float32
    assert got["logits"].shape == ref["logits"].shape
    _assert_close(got["logits"].numpy(), ref["logits"], F32_RTOL)
    np.testing.assert_allclose(float(got["total"]), float(ref["total"]),
                               rtol=F32_RTOL)
    np.testing.assert_allclose(float(got["parts"]["ce"]),
                               float(ref["parts"]["ce"]), rtol=F32_RTOL)


def test_model_gradients_match_jax(model_run):
    ref, variables, port, _ = model_run
    fresh = load_from_flax(type(port)(**_kwargs(port)).double(),
                           {"params": ref["grads"],
                            "batch_stats": variables["batch_stats"]})
    want = dict(fresh.named_parameters())
    zero = 0
    for n, p in port.named_parameters():
        w = want[n].detach().numpy()
        _assert_close(p.grad.numpy(), w, GRAD_RTOL)
        zero += not np.any(w)
    assert zero == 0  # every parameter reached


def test_model_bn_statistics_match_jax(model_run):
    ref, _, port, _ = model_run
    want = _flat_stats(ref["stats"])
    got = {n: b.numpy() for n, b in port.named_buffers() if "running" in n}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        _assert_close(got[n], w, F64_RTOL)


def test_model_eval_logits_and_predict_match_jax(model_run):
    ref, _, _, got = model_run
    _assert_close(got["eval_logits"].numpy(), ref["eval_logits"], F32_RTOL)
    top2 = np.sort(ref["eval_logits"], -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > ARGMAX_MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got["pred"].numpy()[clear],
                                  ref["pred"][clear])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dilated_resnet_r18_os16_matches_jax_f64(train):
    """DeepLab-18's backbone is ResNet-18 at output stride 16 (the case
    ``test_torch_resnet_dilation.py`` leaves to this program): its C2-C5 in
    the train step and in eval mode within 1e-10 of each map's largest
    value (f64 on both sides, before the logits' cast); its running
    statistics are held by ``test_model_bn_statistics_match_jax``."""
    ref, _, port, got = _model_run("deeplabv3plus")
    assert port.backbone.out_channels == (64, 128, 256, 512)
    key = "train" if train else "eval"
    sides = [f.shape[2] for f in got["features"][key]]
    assert sides == [16, 8, 4, 4]  # 64 x 64 at output stride 16
    for g, want in zip(got["features"][key], ref["features"][key]):
        _assert_close(_nhwc(g), want, F64_RTOL)


def _kwargs(port):
    if isinstance(port, tseg.UNet):
        return dict(num_classes=port.num_classes, widths=port.widths,
                    dtype=port.dtype)
    return dict(num_classes=port.num_classes, depth=18, dtype=port.dtype,
                **({} if isinstance(port, tseg.DeepLabV3)
                   else dict(use_decoder=True)))


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("dice", [0.0, 0.5], ids=["ce", "dice"])
def test_segmentation_loss_matches_jax(dice, with_valid):
    """Labels 255 and -1 on valid and on ignored pixels: the loss, its
    parts and the logits' gradient at f32."""
    rs = np.random.RandomState(11)
    logits = (rs.randn(2, 6, 7, 4) * 3).astype(np.float32)
    mask = rs.randint(0, 4, (2, 6, 7)).astype(np.int32)
    mask[0, 0, :3] = 255
    mask[1, 2, :3] = -1
    valid = rs.rand(2, 6, 7) > 0.3
    valid[0, 0, :2] = True   # out-of-range labels where valid ...
    valid[1, 2, 2] = False   # ... and where ignored
    v = valid if with_valid else None

    def jloss(lg):
        total, parts = jseg.segmentation_loss(
            lg, jnp.asarray(mask), None if v is None else jnp.asarray(v),
            dice_weight=dice)
        return total, parts

    (want, want_parts), want_grad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got, parts = tseg.segmentation_loss(
        lt, torch.from_numpy(mask), None if v is None
        else torch.from_numpy(v), dice_weight=dice)
    got.backward()
    assert sorted(parts) == sorted(want_parts)
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_RTOL)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(want_parts[k]),
                                   rtol=F32_RTOL, atol=1e-7)
    _assert_close(lt.grad.numpy(), np.asarray(want_grad), F32_RTOL)
    with pytest.raises(RuntimeError):  # the trap the comparison avoids
        torch.nn.functional.one_hot(torch.from_numpy(mask).long(), 4)


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
def test_miou_matches_jax_with_out_of_range_indices(with_valid):
    """Predictions and targets in [-2, C + 3): indices past the last of
    the (C + 1)^2 bins are dropped and negative ones counted in bin 0,
    as the reference's ``jnp.bincount``; torch's own bincount would give
    another value."""
    c = 3
    rs = np.random.RandomState(5)
    pred = rs.randint(-2, c + 3, (2, 9, 8)).astype(np.int32)
    target = rs.randint(-2, c + 3, (2, 9, 8)).astype(np.int32)
    valid = rs.rand(2, 9, 8) > 0.2 if with_valid else None
    want = float(jax.jit(jseg.miou, static_argnums=2)(
        jnp.asarray(pred), jnp.asarray(target), c,
        None if valid is None else jnp.asarray(valid)))
    tv = None if valid is None else torch.from_numpy(valid)
    got = tseg.miou(torch.from_numpy(pred), torch.from_numpy(target), c, tv)
    assert got.dtype == torch.float32
    assert float(got) == want
    # a plain bincount over the clipped indices grows past the bins
    v = np.ones_like(pred, bool) if valid is None else valid
    idx = (np.where(v, target, c) * (c + 1) + np.where(v, pred, c)).clip(0)
    assert idx.max() >= (c + 1) ** 2 and (np.where(v, target, c) * (c + 1)
                                          + np.where(v, pred, c)).min() < 0


@pytest.mark.parametrize("warmup", [0, 500])
def test_polynomial_decay_matches_the_reference(warmup):
    got = polynomial_decay(0.007, 1e-4 if warmup else 0.0, 30000, 0.9,
                           warmup)
    want = j_poly(0.007, 1e-4 if warmup else 0.0, 30000, 0.9, warmup)
    for count in (0, 1, 499, 500, 501, 15000, 29999, 30000, 40000):
        g = got(torch.tensor(count))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(want(jnp.asarray(count))),
                                   rtol=POW_RTOL, err_msg=str(count))
    if not warmup:
        assert float(got(torch.tensor(0))) == np.float32(0.007)
        np.testing.assert_allclose(float(got(torch.tensor(15000))), 3.7512e-3,
                                   rtol=1e-4)
        assert float(got(torch.tensor(30000))) == 0.0


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.tensor(v)))


@pytest.mark.parametrize("guarded", [False, True], ids=["adam", "guarded"])
def test_adam_matches_optax_f64(guarded):
    """Unguarded: one ``adam`` step at lr 1e-2. Guarded (the reference's
    ``build_optimizer``: ``apply_if_finite`` around Adam under a warm-up
    cosine, 0 -> 3e-2 over 2 counts): three steps, the middle one with a
    NaN gradient, which changes no parameter, no moment and no count.
    Parameters after each step, both moments and the counts, f64."""
    rs = np.random.RandomState(2)
    params = {"w": rs.randn(4, 3), "b": rs.randn(3)}
    grads = [{k: rs.randn(*v.shape) for k, v in params.items()}
             for _ in range(3 if guarded else 1)]
    if guarded:
        grads[1]["w"][1, 2] = np.nan
        tx = build_optimizer({"type": "adam"}, j_warmup_cosine(3e-2, 100, 2))
        recipe = skip_nonfinite_updates(adam(warmup_cosine(3e-2, 100, 2)))
    else:
        tx, recipe = optax.adam(1e-2), adam(1e-2)
    model = _Params(params)
    opt = recipe.init(model)
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)

        @jax.jit
        def step(g, state, jp):
            updates, state = tx.update(g, state, jp)
            return optax.apply_updates(jp, updates), state

        for step_no, g in enumerate(grads):
            jp, state = step({k: jnp.asarray(v) for k, v in g.items()},
                             state, jp)
            for k, v in g.items():
                getattr(model, k).grad = torch.tensor(v)
            recipe.update(opt, model.parameters())
            for k, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-14,
                                           atol=1e-15,
                                           err_msg=(step_no, k))
        (adam_state,) = [s for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        for k, p in model.named_parameters():
            st = opt.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       np.asarray(adam_state.mu[k]),
                                       rtol=1e-14)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(adam_state.nu[k]),
                                       rtol=1e-14)
            assert float(st["step"]) == int(adam_state.count)
    if guarded:
        assert int(adam_state.count) == 2
        assert int(opt.param_groups[0]["count"]) == 2


def test_train_entries_follow_the_configs():
    """The segmentor entries' constants against ``configs/``."""
    def cfg(name):
        with open(f"configs/{name}.yaml") as f:
            return yaml.safe_load(f)

    for name in ("deeplabv3_r101", "deeplabv3plus_r101"):
        c = cfg(name)
        assert (c["model"]["num_classes"], c["model"]["depth"]) == (
            entry.DEEPLAB_CLASSES, entry.DEEPLAB_DEPTH)
        t = c["train"]
        assert t["image_hw"] == [entry.DEEPLAB_RES] * 2
        assert t["batch_size"] == entry.DEEPLAB_TRAIN_BATCH
        assert t["optimizer"] == dict(type="sgd",
                                      momentum=entry.DEEPLAB_MOMENTUM,
                                      weight_decay=entry.DEEPLAB_WEIGHT_DECAY)
        assert t["lr_schedule"] == dict(
            type="polynomial_decay", learning_rate=entry.DEEPLAB_LR,
            end_learning_rate=entry.DEEPLAB_END_LR,
            decay_steps=entry.DEEPLAB_DECAY_STEPS, power=entry.DEEPLAB_POWER)
    assert jseg.DeepLabV3Plus.output_stride == tseg.OUTPUT_STRIDE
    c = cfg("unet")
    assert c["model"]["num_classes"] == entry.UNET_CLASSES
    t = c["train"]
    assert (t["image_hw"], t["batch_size"], t["optimizer"]) == (
        [entry.UNET_RES] * 2, entry.UNET_TRAIN_BATCH, {"type": "adam"})
    assert t["lr_schedule"] == dict(
        type="warmup_cosine", learning_rate=entry.UNET_LR,
        total_steps=entry.UNET_TOTAL_STEPS, warmup_steps=entry.UNET_WARMUP)
    assert tuple(jseg.UNet.widths) == tseg.UNet().widths
