"""The port's registries, schedules and optimizer factory vs the JAX
package's, on the CPU.

- Every name of the reference's twelve registries is registered in the
  port's (the 58 ``register_module`` sites).
- Every ``configs/*.yaml`` model section builds through ``DETECTORS`` (on
  the meta device) with the parameter count of the reference's init, taken
  through ``jax.eval_shape`` (nothing computed). Where the reference's own
  init fails on a config (the ped_cycle config's ``rpn_space_to_depth``
  with a stride-1 first block; the Waymo config's 468 x 468 grid,
  ``ROADMAP.md`` §3) the count is taken with the key off or at 480 x 480:
  neither changes a parameter's shape.
- Keys: a key the port does not implement, or a constant restated with
  another value, raises; a TPU layout key is accepted; ``build_from_cfg``
  and ``Registry`` behave as the reference's.
- Every config's ``lr_schedule`` equals the reference's ``build_schedule``
  within 1e-7 relative at steps 0, 1, each boundary (milestone, warm-up,
  one-cycle peak) +-1 and the last step, and on schedules of other
  lengths and options the port takes; an option it keeps constant
  (``staircase``, ``end_factor``, ``pct_start``: no config sets one)
  raises.
- ``build_optimizer`` matches optax within f32 rounding over three steps on
  the same parameters and gradients for adam, adamw and sgd (Nesterov
  too), under a schedule and a clip that bites, the second step's
  gradients not finite (skipped by the NaN guard on both sides);
  ``with_ema`` / ``get_ema_params`` match ``optax.ema(debias=True)``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import minddet_tpu.data.coco  # noqa: F401  (the reference's registry:
import minddet_tpu.data.kitti  # noqa: F401   its models through the train
import minddet_tpu.data.nuscenes  # noqa: F401  CLI, its datasets here)
import minddet_tpu.data.seg  # noqa: F401
import minddet_tpu.data.waymo  # noqa: F401
import minddet_tpu.train.train  # noqa: F401
from minddet_tpu.core import lr_schedules as jls
from minddet_tpu.core import optim as joptim
from minddet_tpu.core import registry as jreg
from minddet_tpu.core.config import Config as JConfig
from minddet_tpu_torch.core import lr_schedules as tls
from minddet_tpu_torch.core import optim as toptim
from minddet_tpu_torch.core import registry as treg
from minddet_tpu_torch.models import zoo  # noqa: F401  (the port's)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
REGISTRIES = ("READERS", "BACKBONES", "NECKS", "HEADS", "LOSSES", "DETECTORS",
              "SECOND_STAGE", "ROI_HEAD", "DATASETS", "TRANSFORMS",
              "OPTIMIZERS", "LR_SCHEDULES")
# the config changes under which the reference's init runs (see above)
REFERENCE_INIT_FIXES = {
    "pointpillars_ped_cycle_kitti.yaml": {"rpn_space_to_depth": False},
    "centerpoint_pp_waymo.yaml": {
        "grid_ny": 480, "grid_nx": 480,
        "pc_range": [-76.8, -76.8, -2.0, 76.8, 76.8, 4.0]},
}


def test_registries_hold_every_reference_name():
    """56 names: the 58 lines of ``grep -rn register_module minddet_tpu``
    less the two in ``core/registry.py`` (its docstring and its method)."""
    for name in REGISTRIES:
        want = set(getattr(jreg, name).module_dict)
        got = set(getattr(treg, name).module_dict)
        assert got == want, (name, want ^ got)
    assert sum(len(getattr(jreg, n)) for n in REGISTRIES) == 56


def _reference_params(mcfg) -> int:
    """The reference model's parameter count, through ``jax.eval_shape``
    of its init by the method that makes every parameter: the lidar
    models' predict from points (the two-stage one's refined predict), the
    others' predict at their input size."""
    model = jreg.DETECTORS.build({k: tuple(v) if isinstance(v, list) else v
                                  for k, v in mcfg.items()})
    kind = mcfg["type"]
    if kind in ("PointPillars", "CenterPoint", "CenterPointTwoStage"):
        nf = 4 if kind == "PointPillars" else 5
        args = (jnp.zeros((1, 64, nf)), jnp.ones((1, 64), bool))
        method = (model.predict_refined if kind == "CenterPointTwoStage"
                  else model.predict_from_points)
    else:
        hw = (mcfg.get("image_size", 300),) * 2 if kind == "SSD" else tuple(
            mcfg.get("image_hw", (64, 64)))
        args, method = (jnp.zeros((1,) + hw + (3,)),), model.predict
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               method=method))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_builds_with_the_reference_parameter_count(path):
    mcfg = JConfig.fromfile(path).to_dict()["model"]
    with torch.device("meta"):
        model = treg.DETECTORS.build(mcfg)
    assert type(model).__name__ == mcfg["type"]
    fixes = REFERENCE_INIT_FIXES.get(os.path.basename(path), {})
    want = _reference_params(dict(mcfg, **fixes))
    assert sum(p.numel() for p in model.parameters()) == want
    if fixes:  # the port builds the config as it is, and with the fixes
        with torch.device("meta"):
            fixed = treg.DETECTORS.build(dict(mcfg, **fixes))
        assert sum(p.numel() for p in fixed.parameters()) == want
        # the reference's init fails on the config as it is (ROADMAP.md §3)
        with pytest.raises((AssertionError, TypeError)):
            _reference_params(mcfg)


def test_detector_keys_raise_unless_ported():
    build = treg.DETECTORS.build
    with torch.device("meta"):
        net = build({"type": "CenterNet", "num_classes": 3, "head_conv": 32,
                     "reg_offset": False, "dtype": "bfloat16"})
        assert net.dtype == torch.bfloat16 and net.head.reg is None
        assert net.head.hm.conv.out_channels == 32
        build({"type": "PointPillars", "rpn_space_to_depth": True,
               "rpn_scan_inner": False, "rpn_stacked_params": False,
               "anchor_sizes": [[1.6, 3.9, 1.56]]})
        build({"type": "CenterPoint", "loc_weight": 0.25,
               "scatter_extra_channel": False,
               "code_weights": [1.0] * 6 + [0.2, 0.2, 1.0, 1.0]})
        build({"type": "DeepLabV3", "use_decoder": False, "depth": 18})
        build({"type": "YOLOv4", "decode_flavor": "exp", "width_mult": 0.25})
    for bad in ({"type": "CenterNet", "stem": 1},
                {"type": "CenterPoint", "loc_weight": 0.5},
                {"type": "CenterPointTwoStage", "stage2_box_weight": 2.0},
                {"type": "PointPillars", "rpn_stacked_params": True},
                {"type": "DeepLabV3", "use_decoder": True},
                {"type": "SSD", "extra_channels": [256, 256, 128, 128]},
                {"type": "YOLOv7", "decode_flavor": "exp"}):
        with pytest.raises(ValueError, match="not ported"):
            build(bad)
    with pytest.raises(KeyError, match="not registered"):
        build({"type": "RetinaNet"})


@pytest.mark.parametrize("mod", [treg, jreg], ids=["port", "reference"])
def test_build_from_cfg_and_registry(mod):
    reg = mod.Registry("things")

    @reg.register_module()
    class Thing:
        def __init__(self, a=1, b=2):
            self.a, self.b = a, b

    def make(a):
        return ("made", a)

    reg.register_module(name="maker", module=make)
    assert len(reg) == 2 and "Thing" in reg and "maker" in reg
    assert reg.name == "things" and "Thing" in repr(reg)
    t = reg.build({"type": "Thing", "a": 5}, b=7, a=9)
    assert (t.a, t.b) == (5, 7)
    assert mod.build_from_cfg({"type": make, "a": 3}, reg) == ("made", 3)
    with pytest.raises(KeyError, match="already registered"):
        reg.register_module(module=make, name="maker")
    reg.register_module(module=make, name="maker", force=True)
    with pytest.raises(TypeError):
        reg.register_module(module=3)
    with pytest.raises(TypeError):
        mod.build_from_cfg([("type", "Thing")], reg)
    with pytest.raises(KeyError, match="'type'"):
        reg.build({"a": 1})
    with pytest.raises(KeyError, match="not registered"):
        reg.get("Other")
    with pytest.raises(TypeError, match="str or class"):
        reg.build({"type": 3})


def _boundaries(cfg) -> list:
    kind = cfg["type"]
    if kind == "multi_epochs_decay":
        out = [m * cfg["steps_per_epoch"] for m in cfg["milestones"]]
    elif kind == "one_cycle":
        out = [int(cfg["total_steps"] * cfg.get("pct_start", 0.4))]
    elif kind == "exponential_decay":
        out = [cfg["decay_steps"], 2 * cfg["decay_steps"]]
    else:
        out = [cfg.get("decay_steps", cfg.get("total_steps", 0))]
    return out + [cfg["warmup_steps"]] if cfg.get("warmup_steps") else out


def _last(cfg) -> int:
    return int(cfg.get("total_steps", cfg.get("decay_steps", 0))
               or 10 * max(_boundaries(cfg)))


def _hold_schedule(cfg, extra=()):
    """Within 1e-7 relative; a power other than 1 within 2**-21 (4 f32
    ulps): XLA's f32 ``pow`` is not correctly rounded (DeepLab's
    ``polynomial_decay`` ** 0.9 near its last step: torch's ``pow`` a few
    ulps from it; exp(0.9 log) and the f64 value rounded are farther)."""
    ref = jls.build_schedule(dict(cfg))
    got = tls.build_schedule(dict(cfg))
    rtol = 1e-7 if cfg.get("power", 1.0) == 1.0 else 2.0 ** -21
    steps = {0, 1, _last(cfg), *extra}
    for b in _boundaries(cfg):
        steps |= {b - 1, b, b + 1}
    for s in sorted(x for x in steps if x >= 0):
        want = float(ref(jnp.asarray(s, jnp.int32)))
        v = float(got(torch.tensor(s)))
        assert abs(v - want) <= rtol * abs(want) + 1e-30, (cfg, s, v, want)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_schedule_matches_the_reference(path):
    _hold_schedule(JConfig.fromfile(path).to_dict()["train"]["lr_schedule"])


@pytest.mark.parametrize("cfg", [
    dict(type="multi_epochs_decay", learning_rate=0.02, milestones=[2, 5],
         steps_per_epoch=10, factor=4.0, warmup_steps=3),
    dict(type="exponential_decay", learning_rate=1e-3, decay_steps=7,
         decay_rate=0.5),
    dict(type="warmup_cosine", learning_rate=0.1, total_steps=50,
         warmup_steps=5),
    dict(type="one_cycle", lr_max=3e-3, total_steps=100),
    dict(type="polynomial_decay", learning_rate=0.01, end_learning_rate=1e-4,
         decay_steps=40, power=2.0, warmup_steps=4),
    dict(type="linear_warmup", learning_rate=0.01, warmup_steps=6,
         total_steps=30, end_factor=0.05),
], ids=lambda c: c["type"])
def test_schedule_options_match_the_reference(cfg):
    _hold_schedule(cfg, extra=range(0, 12))


@pytest.mark.parametrize("cfg", [
    dict(type="exponential_decay", learning_rate=1e-3, decay_steps=7,
         staircase=False),
    dict(type="warmup_cosine", learning_rate=0.1, total_steps=50,
         end_factor=0.1),
    dict(type="one_cycle", lr_max=3e-3, total_steps=100, pct_start=0.3)],
    ids=lambda c: c["type"])
def test_schedule_options_the_port_keeps_constant_raise(cfg):
    """The reference takes these; no config sets one, and the port keeps
    them as constants, so a config that does fails where it is built."""
    jls.build_schedule(dict(cfg))
    with pytest.raises(TypeError, match="unexpected keyword"):
        tls.build_schedule(dict(cfg))


class _Two(nn.Module):
    """One decayed (2-D) and one undecayed (1-D) parameter."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w))
        self.b = nn.Parameter(torch.tensor(b))


def _params_and_grads(seed=0):
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    grads[1]["w"][1, 2] = np.nan  # the NaN guard skips step 2 on both sides
    return params, grads


def _run_both(cfg, schedule_cfg, wrap_port=None, wrap_ref=None):
    """Three steps of ``build_optimizer(cfg, build_schedule(...))`` on both
    sides; yields (port params, reference params) after each."""
    params, grads = _params_and_grads()
    tx_j = joptim.build_optimizer(dict(cfg), jls.build_schedule(
        dict(schedule_cfg)))
    tx_t = toptim.build_optimizer(dict(cfg), tls.build_schedule(
        dict(schedule_cfg)))
    if wrap_port:
        tx_j, tx_t = wrap_ref(tx_j), wrap_port(tx_t)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx_j.init(jp)
    model = _Two(params["w"], params["b"])
    opt = tx_t.init(model)
    for g in grads:
        updates, state = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                     state, jp)
        jp = optax.apply_updates(jp, updates)
        model.w.grad = torch.tensor(g["w"])
        model.b.grad = torch.tensor(g["b"])
        tx_t.update(opt, model.parameters())
        yield model, opt, state, {k: np.asarray(v) for k, v in jp.items()}


OPTIMIZERS = [
    dict(type="adam", clip_global_norm=2.0),
    dict(type="adam", b1=0.8, eps=1e-6),
    dict(type="adamw", weight_decay=0.01, clip_global_norm=1.0, b1=0.8),
    dict(type="sgd", momentum=0.9, weight_decay=1e-2, clip_global_norm=3.0),
    dict(type="sgd", momentum=0.937, nesterov=True, weight_decay=5e-4),
]
SCHEDULE = dict(type="warmup_cosine", learning_rate=0.05, total_steps=10,
                warmup_steps=1)


@pytest.mark.parametrize("cfg", OPTIMIZERS,
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_build_optimizer_matches_optax(cfg):
    """Parameters within f32 rounding after each of three steps: rtol 1e-6
    and atol 2e-5 x the peak lr. Adam's normalized step m / sqrt(v) agrees
    to ~1e-5 of its size where the two applied steps' gradients nearly
    cancel in m (torch's fused Adam rounds m as a lerp, optax as a sum);
    SGD's parameters agree to f32 rounding.
    The schedule's lr is 0 at the first step; the second's NaN leaves both
    sides where they were."""
    atol = 2e-5 * SCHEDULE["learning_rate"]
    before = None
    for i, (model, _, _, ref) in enumerate(_run_both(cfg, SCHEDULE)):
        got = {"w": model.w.detach().numpy(), "b": model.b.detach().numpy()}
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=atol,
                                       err_msg=f"{cfg} step {i + 1} {k}")
        if i == 1:
            for k in ref:
                np.testing.assert_array_equal(got[k], before[k])
        before = {k: v.copy() for k, v in got.items()}
    assert toptim.build_optimizer(dict(type="sgd", nan_guard=False),
                                  0.1).nan_guard is False


def test_with_ema_matches_optax_ema():
    """``with_ema(tx, 0.5)`` against ``optax.chain(tx, optax.ema(0.5,
    debias=True))``: the parameters (as ``test_build_optimizer_matches_
    optax`` holds them) and the average (the EMA of the updates, as optax
    keeps it; rtol 1e-5: the update is the difference of two parameters
    on the port's side) after three steps."""
    cfg = dict(type="adamw", weight_decay=0.01)
    steps = list(_run_both(cfg, SCHEDULE,
                           wrap_port=lambda tx: toptim.with_ema(tx, 0.5),
                           wrap_ref=lambda tx: joptim.with_ema(tx, 0.5)))
    model, opt, state, ref = steps[-1]
    for k in ref:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), ref[k],
                                   rtol=1e-6, atol=2e-5 * SCHEDULE[
                                       "learning_rate"])
    ema = toptim.get_ema_params(model, opt)
    ref_ema = joptim.get_ema_params(state)
    for k in ("w", "b"):
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(ref_ema[k]),
                                   rtol=1e-5, atol=1e-7)
        # an average of updates (a step's size), not of the parameters
        # (ROADMAP.md §3): the reference's fault, copied
        assert float(ema[k].abs().max()) < 2 * SCHEDULE["learning_rate"]
        assert float(getattr(model, k).detach().abs().max()) > 0.5
    assert int(opt.param_groups[0]["ema_count"]) == 3
    plain = toptim.adamw(0.1)
    assert toptim.get_ema_params(model, plain.init(model)) is None
