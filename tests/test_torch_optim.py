"""The port's AdamW on parameters that the loss does not reach, against the
reference's optax chain, f32 on the CPU.

optax hands every parameter a gradient, zero where the loss never reached
it: its moments stay zero, but the shared step count advances and the
decoupled weight decay still shrinks it (ndim > 1). ``torch.optim.AdamW``
skips a parameter whose ``.grad`` is None (``zero_grad(set_to_none=True)``
leaves it so), so ``AdamW.update`` gives such a parameter a zero gradient
first. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from minddet_tpu.core.optim import adamw as jax_adamw
from minddet_tpu_torch.core.optim import adamw

LR = 1e-3
CLIP = 35.0
STEPS = 3
# f32, the same arithmetic in another order: atol and rtol
TOL = 1e-6


class _Heads(nn.Module):
    """``used`` takes a gradient every step, ``late`` from step 2 on,
    ``unused`` (a 2-D weight, so the decay applies) never."""

    def __init__(self, params):
        super().__init__()
        for name, value in params.items():
            setattr(self, name, nn.Parameter(torch.tensor(value)))


def _reached(step: int):
    return ("used", "late") if step >= 1 else ("used",)


def _grads(rs, params):
    return [{k: (rs.randn(*v.shape) * s).astype(np.float32)
             for k, v in params.items()} for s in (1.0, 30.0, 0.5)]


def _run(params, grads):
    """STEPS updates on both sides; returns the parameters after each."""
    tx = jax_adamw(LR, clip_global_norm=CLIP)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    model = _Heads(params)
    recipe = adamw(LR, clip_global_norm=CLIP)
    opt = recipe.init(model)
    out = []
    for step, g in enumerate(grads):
        reached = _reached(step)
        jg = {k: jnp.asarray(v if k in reached else np.zeros_like(v))
              for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.zero_grad(set_to_none=True)
        for name in reached:
            getattr(model, name).grad = torch.tensor(g[name])
        recipe.update(opt, model.parameters())
        out.append(({k: np.asarray(v) for k, v in jparams.items()},
                    {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()}))
    return out


@pytest.mark.parametrize("name", ["used", "late", "unused"])
def test_adamw_unreached_parameters_match_optax(name):
    """Each parameter after each of 3 steps, clip 35 (step 2's gradients
    have a norm of ~200, so it fires there): |port - optax| <= 1e-6 + 1e-6 *
    |optax|. ``unused`` is only decayed, ``late`` has its first gradient
    at step 2, where optax's bias correction is that of step 2."""
    rs = np.random.RandomState(0)
    params = {"used": rs.randn(6, 5).astype(np.float32),
              "late": rs.randn(4, 5).astype(np.float32),
              "unused": rs.randn(5, 3).astype(np.float32)}
    for step, (want, got) in enumerate(_run(params, _grads(rs, params))):
        err = np.abs(got[name] - want[name])
        bound = TOL + TOL * np.abs(want[name])
        assert (err <= bound).all(), (
            f"{name} after step {step + 1}: max abs {err.max():.3e}, max "
            f"rel {(err / np.abs(want[name])).max():.3e}")


def test_adamw_leaves_frozen_parameters_alone():
    """A parameter with ``requires_grad=False`` is in no group: it gets no
    gradient and does not change."""
    rs = np.random.RandomState(1)
    model = _Heads({"used": rs.randn(3, 2).astype(np.float32),
                    "frozen": rs.randn(3, 2).astype(np.float32)})
    model.frozen.requires_grad_(False)
    before = model.frozen.detach().clone()
    recipe = adamw(LR, clip_global_norm=CLIP)
    opt = recipe.init(model)
    model.used.grad = torch.ones(3, 2)
    recipe.update(opt, model.parameters())
    assert model.frozen.grad is None
    assert torch.equal(model.frozen.detach(), before)
