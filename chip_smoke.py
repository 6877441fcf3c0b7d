#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``minddet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, in f32 and bf16, with its time (CUDA events,
   warm L2), the plain version's time and the memory/compute bound: the
   sampler forward (K1f) and its backward (K1b), the latter also at
   integer coordinates (spread 0, a DCN layer with zero offsets);
4. end to end in f32 (TF32 off): ``CenterNet`` predict on the card against
   the same model on the CPU (the plain path);
5. end to end in f32 (TF32 off): one train step (512x512, batch 2) on the
   card against the same step on the CPU: loss, grad_norm, every
   parameter's gradient, the post-step parameters and BN statistics;
6. the main paths, each with every kernel's launch count set to 0 just
   before and read just after:
   a. serving: the flagship predict (CenterNet-R18-DCNv2, 80 classes,
      512x512, bf16, top-100) answers requests at batch 1 and 16;
   b. training: the flagship train step (``train_entry``: f32 params, bf16
      compute, batch TRAIN_BATCH) takes 2 warm-up and 10 timed steps on one
      batch; the loss must stay finite and fall.

The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. ``--json PATH`` also writes every measurement there;
``--profile`` also breaks the serving requests and 3 train steps down with
``torch.profiler``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# (H = W, C) of the nine DCN inputs at 512x512, each shape three times
DCN_SHAPES = ((64, 128), (32, 256), (16, 512))
DCN_CALLS_PER_SHAPE = 3
DCN_LAYERS = 9
BATCH = 16
TAPS = 9
SERVE_BATCHES = (1, 16)
SERVE_WARMUP = 2
SERVE_REQUESTS = 10
TRAIN_BATCH = 128
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
CHECK_BATCH = 2  # the f32 card-vs-CPU train step
OFFSET_GAIN = 0.25  # offset conv std * sqrt(fan_in), see randomize_for_check
HOST_AHEAD_CYCLES = 20_000_000  # ~10 ms of GPU clock, see _cuda_ms


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``, its launches back to back: a busy wait
    on the stream lets the host queue every launch before the first start
    event, so a call shorter than its host-side cost (a ~30 us kernel) is
    not timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dcn_coords(b, h, w, k, spread, gen):
    """Tap-major (B, K, P) coordinates of a stride-1 3x3 DCN at (h, w):
    grid - 1 + tap + spread * N(0, 1); and a mask in [0, 1)."""
    iy = torch.arange(h, dtype=torch.float32).repeat_interleave(w)
    ix = torch.arange(w, dtype=torch.float32).repeat(h)
    taps = torch.arange(k)
    base_y = iy[None, :] - 1 + torch.div(taps, 3, rounding_mode="floor")[
        :, None].float()
    base_x = ix[None, :] - 1 + (taps % 3)[:, None].float()
    ys = base_y + spread * torch.randn(b, k, h * w, generator=gen)
    xs = base_x + spread * torch.randn(b, k, h * w, generator=gen)
    sc = torch.rand(b, k, h * w, generator=gen)
    return ys, xs, sc


def _touched_rows(x, ys, xs) -> int:
    """How many (image, texel) rows of x the samples' in-bounds corners
    touch."""
    b, h, w, _ = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    rows = 0
    for bi in range(b):
        touched = []
        for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
            inb = (cy[bi] >= 0) & (cy[bi] < h) & (cx[bi] >= 0) & (cx[bi] < w)
            touched.append((cy[bi] * w + cx[bi])[inb].long())
        rows += int(torch.unique(torch.cat(touched)).numel())
    return rows


def _bound(nbytes: int, f32_ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = f32_ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _taps_bound(x, ys, xs):
    """(bound_ms, bound_by) of the taps sampler on these inputs: the output
    written once, the x rows these samples touch read once, the three
    coordinate arrays read once; 9 f32 operations per output value (4 FMAs
    and the scale)."""
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    elt = x.element_size()
    nbytes = (b * p * k * c * elt + _touched_rows(x, ys, xs) * c * elt
              + 3 * b * k * p * 4)
    return _bound(nbytes, 9 * b * p * k * c)


def _taps_bwd_bound(x, ys, xs):
    """(bound_ms, bound_by) of the sampler's backward on these inputs: g
    (B,P,K*C) read once, the x rows these samples touch read once, the
    three coordinate arrays read once; dx (B,H,W,C in x's type) and the
    three (B,K,P) f32 gradients written once; 16 f32 operations per g value
    (4 FMAs of the corner dots, 4 scaled adds into dx)."""
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    elt = x.element_size()
    nbytes = (b * p * k * c * elt + _touched_rows(x, ys, xs) * c * elt
              + 3 * b * k * p * 4 + b * h * w * c * elt + 3 * b * k * p * 4)
    return _bound(nbytes, 16 * b * p * k * c)


def check_taps_kernel(dev, gen):
    """Phase 3: hat_sample_taps_fwd against its plain version, per case."""
    from minddet_tpu_torch.ops import hat_sample as hs

    cases = []
    for h, c in DCN_SHAPES:
        x32 = torch.randn(BATCH, h, h, c, generator=gen).to(dev)
        for spread in (1.5, 80.0):
            ys, xs, sc = (t.to(dev) for t in
                          _dcn_coords(BATCH, h, h, TAPS, spread, gen))
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                got = hs.hat_sample_2d_taps(x, ys, xs, sc)
                torch.cuda.synchronize()
                ref = hs.hat_sample_2d_taps_plain(x.float(), ys, xs, sc)
                err = (got.float() - ref).abs()
                max_abs = float(err.max())
                max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
                if dtype == torch.float32:
                    tol = "f32: abs <= 1e-5"
                    ok = max_abs <= 1e-5
                else:  # within one bf16 ulp of the plain f32 result
                    tol = "bf16: abs <= 1e-2 + 2**-7 * |plain f32|"
                    ok = bool((err <= 1e-2 + 2 ** -7 * ref.abs()).all())
                del got, ref, err
                ms = _cuda_ms(lambda: hs.hat_sample_2d_taps(x, ys, xs, sc),
                              iters=20)
                plain_ms = _cuda_ms(
                    lambda: hs.hat_sample_2d_taps_plain(x, ys, xs, sc),
                    iters=3, warmup=1)
                bound_ms, bound_by = _taps_bound(x, ys, xs)
                case = dict(shape=[BATCH, h, h, c], taps=TAPS, spread=spread,
                            dtype=str(dtype).replace("torch.", ""),
                            max_abs_err=max_abs, max_rel_err=max_rel,
                            tolerance=tol, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
                cases.append(case)
                print(f"  taps x{case['shape']} K={TAPS} spread={spread:4.1f}"
                      f" {case['dtype']:8s} max_abs={max_abs:.3e} "
                      f"max_rel={max_rel:.3e} kernel={ms * 1e3:8.1f}us "
                      f"plain={plain_ms * 1e3:9.1f}us "
                      f"bound={bound_ms * 1e3:6.1f}us ({bound_by})",
                      flush=True)
                if not ok:
                    raise AssertionError(
                        f"hat_sample_taps_fwd disagrees with its plain "
                        f"version ({tol}): {case}")
    return cases


# K1b tolerances, err <= atol + rtol * |plain f32|, per output. The plain
# version gets the same g and x (bf16 ones widened exactly) and sums in f32:
# - dys, dxs, dscale: sums of 4*C f32 products, taken by warp shuffles and
#   atomics in another (and run-to-run varying) order;
# - dx f32: sums of up to 4*K scaled g values, in atomic order;
# - dx bf16: that f32 sum rounded once to bf16 (half an ulp, 2**-9
#   relative), with room for the f32 order flipping a rounding.
BWD_TOL = {"dys": (1e-4, 1e-5), "dxs": (1e-4, 1e-5), "dscale": (1e-4, 1e-5),
           "dx_float32": (1e-5, 1e-5), "dx_bfloat16": (1e-5, 2 ** -8)}
BWD_SPREADS = (0.0, 1.5, 80.0)


def check_taps_bwd_kernel(dev, gen):
    """Phase 3: hat_sample_taps_bwd against its plain version, per case.
    Spread 0 puts every sample on the integer grid (a DCN layer with
    zero-initialised offsets), where dys and dxs are forward differences
    and must not vanish."""
    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(1)
    # B = 16 in f32 and bf16 at every spread; the train path's batch in
    # bf16 at spread 0 (its first step) and 1.5 (offsets that moved)
    grid = [(BATCH, spread, dtype) for spread in BWD_SPREADS
            for dtype in (torch.float32, torch.bfloat16)]
    grid += [(TRAIN_BATCH, spread, torch.bfloat16) for spread in (0.0, 1.5)]
    cases = []
    for h, c in DCN_SHAPES:
        for b, spread, dtype in grid:
            x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
            g = torch.randn(b, h * h, TAPS * c, generator=dgen,
                            device=dev).to(dtype)
            ys, xs, sc = (t.to(dev) for t in
                          _dcn_coords(b, h, h, TAPS, spread, gen))
            got = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
            torch.cuda.synchronize()
            ref = hs.hat_sample_2d_taps_bwd_plain(g.float(), x.float(),
                                                  ys, xs, sc)
            errs = {}
            bad = []
            for name, a, r in zip(("dx", "dys", "dxs", "dscale"), got,
                                  ref):
                key = f"dx_{str(dtype)[6:]}" if name == "dx" else name
                atol, rtol = BWD_TOL[key]
                err = (a.float() - r).abs()
                errs[name] = float(err.max())
                errs[f"{name}_max_abs"] = float(r.abs().max())
                if not bool((err <= atol + rtol * r.abs()).all()):
                    bad.append(f"{name} (atol {atol}, rtol {rtol})")
            if spread == 0.0 and min(errs["dys_max_abs"],
                                     errs["dxs_max_abs"]) == 0.0:
                bad.append("dys/dxs vanish at integer coordinates")
            del got, ref
            ms = _cuda_ms(lambda: hs.hat_sample_2d_taps_bwd(g, x, ys, xs,
                                                            sc),
                          iters=20 if b == BATCH else 5)
            plain_ms = _cuda_ms(
                lambda: hs.hat_sample_2d_taps_bwd_plain(g, x, ys, xs, sc),
                iters=3, warmup=1)
            bound_ms, bound_by = _taps_bwd_bound(x, ys, xs)
            case = dict(shape=[b, h, h, c], taps=TAPS, spread=spread,
                        dtype=str(dtype).replace("torch.", ""),
                        max_abs_err=max(errs[n] for n in
                                        ("dx", "dys", "dxs", "dscale")),
                        errors=errs, tolerance=BWD_TOL, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
            cases.append(case)
            print(f"  taps bwd x{case['shape']} spread={spread:4.1f} "
                  f"{case['dtype']:8s} err dx={errs['dx']:.2e} "
                  f"dys={errs['dys']:.2e} dxs={errs['dxs']:.2e} "
                  f"dsc={errs['dscale']:.2e} (|dys|max "
                  f"{errs['dys_max_abs']:.1f}) kernel={ms * 1e3:8.1f}us "
                  f"plain={plain_ms * 1e3:9.1f}us "
                  f"bound={bound_ms * 1e3:6.1f}us ({bound_by})",
                  flush=True)
            if bad:
                raise AssertionError(
                    f"hat_sample_taps_bwd disagrees with its plain "
                    f"version: {', '.join(bad)}: {case}")
    return cases


@torch.no_grad()
def randomize_for_check(model, gen):
    """Random offset/mask convs and BN affines, then BN statistics from one
    pass over a random calibration image (momentum 1).

    The offset conv's std is 0.25/sqrt(fan_in): over the O(1) activations
    that calibrated BN gives, every DCN layer samples off the integer grid
    at offsets of a fraction of a pixel. With a gain near 1, each of the
    nine chained DCN layers turns a rounding difference in its input into
    an offset difference times the feature map's gradient, and f32 card-vs-
    CPU differences grow past any tight tolerance by the neck's end; the
    kernel itself is held to its plain version at 1.5 and 80 px offsets in
    phase 3.
    """
    from torch import nn

    from minddet_tpu_torch.entry import RES
    from minddet_tpu_torch.models.layers import ModulatedDeformConv

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in model.modules():
        if isinstance(m, ModulatedDeformConv):
            wt = m.conv_offset.weight
            wt.copy_(torch.randn(wt.shape, generator=gen)
                     * (OFFSET_GAIN / math.sqrt(wt[0].numel())))
            m.conv_offset.bias.copy_(
                0.1 * torch.randn(m.conv_offset.bias.shape, generator=gen))
    for m in bns:
        m.weight.copy_(0.8 + 0.4 * torch.rand(m.num_features, generator=gen))
        m.bias.copy_(0.1 * torch.randn(m.num_features, generator=gen))
        m.momentum = 1.0
    dev = next(model.parameters()).device
    model.train()
    model(torch.randn(1, RES, RES, 3, generator=gen).to(dev))
    model.eval()
    for m in bns:
        m.momentum = 0.1
    return model


def check_end_to_end_f32(dev, gen):
    """Phase 4: f32 predict on the card vs the same model on the CPU."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import RES, build_model

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = randomize_for_check(build_model("cpu", dtype=torch.float32), gen)
    gpu = build_model(dev, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    image = torch.randn(1, RES, RES, 3, generator=gen)

    kernels.reset_launches()
    with torch.inference_mode():
        heads_gpu = gpu(image.to(dev))
        det_gpu = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = kernels.HAT_SAMPLE_TAPS_FWD.launches
    if launches != 2 * DCN_LAYERS:
        raise AssertionError(f"f32 forward launched the taps kernel "
                             f"{launches} times for 2 forwards")
    with torch.inference_mode():
        heads_cpu = cpu(image)
        det_cpu = cpu.predict(image)

    result = {}
    for name, ref in heads_cpu.items():
        got = heads_gpu[name].cpu()
        err = float((got - ref).abs().max())
        result[f"{name}_max_abs_err"] = err
        result[f"{name}_max_abs"] = float(ref.abs().max())
        if not torch.allclose(got, ref, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"f32 head {name}: card vs CPU max abs "
                                 f"err {err} (atol 1e-4, rtol 1e-3)")
    s_gpu = det_gpu[..., 4].cpu()
    s_cpu = det_cpu[..., 4]
    score_err = float((s_gpu - s_cpu).abs().max())
    result["score_max_abs_err"] = score_err
    if det_gpu.shape != (1, 100, 6) or score_err > 1e-4:
        raise AssertionError(f"f32 predict: card vs CPU scores max abs err "
                             f"{score_err} (atol 1e-4), shape "
                             f"{tuple(det_gpu.shape)}")
    result["class_agreement"] = float(
        (det_gpu[..., 5].cpu() == det_cpu[..., 5]).float().mean())
    print("  f32 card vs CPU: " + " ".join(
        f"{k}={v:.3e}" for k, v in result.items()), flush=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    return result


# f32 train step, card vs CPU. Both sides run the same arithmetic up to the
# order of f32 sums (cuDNN and cuBLAS against oneDNN, atomics in the
# sampler's backward). The backward also passes some 10**7 ReLU inputs and
# 2 * 9 * B * P sample coordinates per DCN layer; the few that lie within
# f32 rounding of a kink (ReLU at 0, floor at an integer) take the other
# branch on the other side and move every gradient upstream of them a
# little. The "probe" (the card's step on a rounding-sized change of the
# image) measures that sensitivity beside the card-vs-CPU errors. Adam's
# first step (~lr * sign(g)) then moves the parameters whose gradient is
# within that noise of 0 by up to 2 lr apart.
TRAIN_TOL = dict(loss_rtol=1e-4, grad_norm_rtol=1e-3, grad_rel_l2=5e-2,
                 stat_atol=1e-4, stat_rtol=1e-4, param_atol=2 * 5e-4 * 1.01,
                 param_moved_share=1e-2, param_moved_atol=1e-6)


def _train_snapshot(state, metrics):
    model = state.model
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.detach().float().cpu()
               for n, p in model.named_parameters()},
        params={n: p.detach().float().cpu()
                for n, p in model.named_parameters()},
        stats={n: b.detach().float().cpu()
               for n, b in model.named_buffers() if "running" in n})


def _grad_rel_l2(a, b):
    """Per parameter, |grad_a - grad_b| / |grad_b| (L2). The neck's
    transposed-conv biases feed a train-mode BN that cancels them: their
    gradient is rounding noise around 0, so they are left out."""
    return {n: float((a["grads"][n] - v).norm() / v.norm().clamp_min(1e-30))
            for n, v in b["grads"].items()
            if not (n.startswith("neck.") and n.endswith("up.bias"))}


def check_train_step_f32(dev, gen):
    """Phase 5: one f32 train step on the card against the same step on
    the CPU (the plain path), 512x512 at batch CHECK_BATCH, from the same
    weights (``randomize_for_check``) and batch."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import (NUM_CLASSES, RES, centernet_loss,
                                         build_model, synthetic_boxes)
    from minddet_tpu_torch.ops.targets import centernet_targets_batch
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = randomize_for_check(build_model("cpu", dtype=torch.float32), gen)
    gpu = build_model(dev, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    probe = build_model(dev, dtype=torch.float32)
    probe.load_state_dict(cpu.state_dict())
    boxes = synthetic_boxes(CHECK_BATCH)
    image = torch.randn(CHECK_BATCH, RES, RES, 3, generator=gen)
    step = make_train_step(centernet_loss)
    snaps = {}
    # "probe" is the card's step on the image scaled by 1 + 1e-6: how far
    # f32 rounding-sized changes of the input move the gradients here
    for name, model, img in (("gpu", gpu, image), ("cpu", cpu, image),
                             ("probe", probe, image * (1 + 1e-6))):
        d = next(model.parameters()).device
        b = {k: torch.from_numpy(v).to(d) for k, v in boxes.items()}
        targets = centernet_targets_batch(b["boxes"], b["classes"],
                                          b["mask"], RES // 4, RES // 4,
                                          NUM_CLASSES, 0.7)
        state = TrainState.create(model, adamw(5e-4, clip_global_norm=35.0))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": img.to(d),
                                      "targets": targets})
        snaps[name] = _train_snapshot(state, metrics)
        print(f"  {name} step {time.perf_counter() - t0:.1f} s, "
              f"loss {snaps[name]['metrics']['loss']:.6f}", flush=True)
        if name != "cpu":
            launches = {k.name: k.launches for k in kernels.KERNELS}
            if set(launches.values()) != {DCN_LAYERS}:
                raise AssertionError(f"f32 train step launched {launches} "
                                     "(want 9 of each sampler kernel)")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32

    g, c = snaps["gpu"], snaps["cpu"]
    t = TRAIN_TOL
    result = {"tolerance": t}
    bad = []
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        err = abs(g["metrics"][k] - c["metrics"][k]) / abs(c["metrics"][k])
        result[f"{k}_rel_err"] = err
        if err > t["loss_rtol"]:
            bad.append(k)
    err = abs(g["metrics"]["grad_norm"] - c["metrics"]["grad_norm"]) / \
        c["metrics"]["grad_norm"]
    result["grad_norm"] = c["metrics"]["grad_norm"]
    result["grad_norm_rel_err"] = err
    if err > t["grad_norm_rtol"]:
        bad.append("grad_norm")
    rel = _grad_rel_l2(g, c)
    worst = max(rel, key=rel.get)
    result["grad_rel_l2_max"] = rel[worst]
    result["grad_rel_l2_worst"] = worst
    for part in ("head", "neck", "backbone"):
        result[f"grad_rel_l2_{part}_median"] = statistics.median(
            v for n, v in rel.items() if n.startswith(part + "."))
    probe_rel = _grad_rel_l2(snaps["probe"], g)
    for part in ("head", "neck", "backbone"):
        result[f"probe_grad_rel_l2_{part}_median"] = statistics.median(
            v for n, v in probe_rel.items() if n.startswith(part + "."))
    result["probe_grad_rel_l2_max"] = max(probe_rel.values())
    if rel[worst] > t["grad_rel_l2"]:
        bad.append(f"gradient of {worst}")
    diffs = {n: (g["params"][n] - v).abs() for n, v in c["params"].items()}
    result["param_max_abs_err"] = max(float(d.max()) for d in diffs.values())
    moved = sum(int((d > t["param_moved_atol"]).sum()) for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    result["param_moved_share"] = moved / total
    if (result["param_max_abs_err"] > t["param_atol"]
            or moved / total > t["param_moved_share"]):
        bad.append("post-step params")
    stat_err = 0.0
    for n, v in c["stats"].items():
        e = (g["stats"][n] - v).abs()
        stat_err = max(stat_err, float(e.max()))
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"BN statistic {n}")
    result["stat_max_abs_err"] = stat_err
    print("  f32 train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 train step, card vs CPU: {bad} outside "
                             f"{t}: {result}")
    return result


def train_main_path(dev):
    """Phase 6b, the training main path: ``train_entry`` at TRAIN_BATCH,
    TRAIN_WARMUP + TRAIN_STEPS steps on one batch, launch counts from 0."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import train_entry

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batch) = train_entry(device=dev, batch=TRAIN_BATCH)
    kernels.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    out = dict(batch=TRAIN_BATCH, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               img_per_s=TRAIN_BATCH / mean_s, max_memory_allocated=peak,
               losses=losses, grad_norm_last=float(metrics["grad_norm"]),
               launches=launches)
    print(f"  train bf16 batch {TRAIN_BATCH}: {mean_s * 1e3:.3f} ms/step "
          f"(p50 {out['ms_p50']:.3f}), {out['img_per_s']:.1f} img/s, peak "
          f"{peak / 2 ** 30:.2f} GiB allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss not finite and falling: {losses}")
    for name, n in launches.items():
        if n != DCN_LAYERS * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"train steps (want 9 per step)")
    print(f"  kernels: {launches} for {steps} steps == 9 x steps: True",
          flush=True)
    return out, (step_fn, state, batch)


def serve(programs):
    """Phase 6a, the serving main path: bf16 predict requests at batch 1
    and 16."""
    out = {}
    forwards = 0
    for b, (predict, (image,)) in programs.items():
        times = []
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(image)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
            forwards += 1
        if det.shape != (b, 100, 6) or not bool(torch.isfinite(det).all()):
            raise AssertionError(f"predict at batch {b}: shape "
                                 f"{tuple(det.shape)}, finite "
                                 f"{bool(torch.isfinite(det).all())}")
        mean_s = statistics.mean(times)
        out[f"b{b}"] = dict(batch=b, requests=len(times),
                            ms_mean=mean_s * 1e3,
                            ms_p50=statistics.median(times) * 1e3,
                            img_per_s=b / mean_s, out_shape=list(det.shape))
        print(f"  predict bf16 batch {b:2d}: {mean_s * 1e3:8.3f} ms/request "
              f"(p50 {out[f'b{b}']['ms_p50']:.3f}), "
              f"{b / mean_s:8.1f} img/s, out {tuple(det.shape)} finite",
              flush=True)
    return out, forwards


def _profile(fn, calls: int):
    """``torch.profiler`` over ``calls`` warm calls of ``fn``: the device's
    busy time (union of kernel intervals) against the host clock of the
    window, and the kernels with the most device time, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kevents = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kevents:
        raise RuntimeError("the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kevents)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in kevents:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(calls=calls, wall_ms_per_call=wall_us / 1e3 / calls,
                device_busy_ms_per_call=busy / 1e3 / calls,
                idle_share=1 - busy / wall_us,
                kernel_launches_per_call=len(kevents) / calls,
                top_kernels=[dict(name=n, ms_per_call=t / 1e3 / calls,
                                  share_of_busy=t / busy) for n, t in top])


def _print_profile(label: str, r) -> None:
    print(f"  profile {label}: wall {r['wall_ms_per_call']:.3f} ms/call "
          f"(profiled), device busy {r['device_busy_ms_per_call']:.3f} ms, "
          f"idle share {r['idle_share']:.3f}, "
          f"{r['kernel_launches_per_call']:.0f} kernels/call")
    for k in r["top_kernels"]:
        print(f"    {k['ms_per_call']:8.3f} ms {k['share_of_busy']:6.1%}"
              f"  {k['name'][:100]}")


def profile_serving(programs, requests: int = 3):
    """Where a request's time goes, per batch size."""
    result = {}
    for b, (predict, (image,)) in programs.items():
        result[f"b{b}"] = r = _profile(lambda: predict(image), requests)
        _print_profile(f"serving batch {b:2d}", r)
    return result


def profile_train(step_fn, state, batch, steps: int = 3):
    """Where a train step's time goes."""
    r = _profile(lambda: step_fn(state, batch), steps)
    _print_profile(f"train batch {TRAIN_BATCH}", r)
    return r


def _kernel_row(kernel, launches, main_cases, calls_per_shape, cases):
    """One kernel's entry of the ``{"kernels": [...]}`` line: times and
    bounds summed over the calls of one main-path pass at the DCN shapes."""
    from minddet_tpu_torch import kernels

    tot = lambda key: calls_per_shape * sum(c[key] for c in main_cases)
    return dict(
        name=kernel.name, route="cuda",
        source=str(kernel.source.relative_to(kernels.CSRC.parent.parent)),
        replaces=kernel.replaces.split()[0], launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes"
                                for c in main_cases) else "operations",
        library_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving requests and 3 train "
                         "steps (torch.profiler)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    from minddet_tpu_torch import kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    print("phase 1: card", flush=True)
    card = _card()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}",
          flush=True)

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = kernels.build_all(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  built {len(logs)} kernel(s) in {build_s:.1f} s", flush=True)

    print("phase 3: kernels vs plain versions", flush=True)
    cases = check_taps_kernel(dev, gen)
    bwd_cases = check_taps_bwd_kernel(dev, gen)

    print("phase 4: end to end, f32 predict, card vs CPU", flush=True)
    e2e = check_end_to_end_f32(dev, gen)

    print("phase 5: end to end, f32 train step, card vs CPU", flush=True)
    train_f32 = check_train_step_f32(dev, gen)

    print("phase 6a: main path, bf16 serving", flush=True)
    from minddet_tpu_torch.entry import entry

    programs = {b: entry(device=dev, batch=b) for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, gen)
    kernels.reset_launches()
    serving, forwards = serve(programs)
    serve_launches = {k.name: k.launches for k in kernels.KERNELS}
    taps = serve_launches["hat_sample_taps_fwd"]
    if taps != DCN_LAYERS * forwards or serve_launches["hat_sample_taps_bwd"]:
        raise AssertionError(f"serving launched {serve_launches} for "
                             f"{forwards} forwards (want 9 forward kernels "
                             f"each and no backward)")
    print(f"  kernels: hat_sample_taps_fwd launches={taps} forwards="
          f"{forwards} launches == 9 x forwards: True", flush=True)
    profiled = {}
    if args.profile:
        print("profile: bf16 serving", flush=True)
        profiled["serving"] = profile_serving(programs)
    del programs
    torch.cuda.empty_cache()

    print(f"phase 6b: main path, bf16 train step at batch {TRAIN_BATCH}",
          flush=True)
    training, train_program = train_main_path(dev)
    if args.profile:
        print("profile: bf16 train step", flush=True)
        profiled["train"] = profile_train(*train_program)
    del train_program

    # the summary rows: K1f is one bf16 batch-16 forward's nine calls (3 at
    # each DCN shape, the spread-1.5 cases); K1b one bf16 train step's nine
    # calls at the train batch (spread 1.5: offsets that moved)
    fwd_main = [c for c in cases
                if c["dtype"] == "bfloat16" and c["spread"] == 1.5]
    bwd_main = [c for c in bwd_cases
                if c["shape"][0] == TRAIN_BATCH and c["spread"] == 1.5]
    train_launches = training["launches"]
    rows = [
        _kernel_row(kernels.HAT_SAMPLE_TAPS_FWD,
                    taps + train_launches["hat_sample_taps_fwd"], fwd_main,
                    DCN_CALLS_PER_SHAPE, cases),
        _kernel_row(kernels.HAT_SAMPLE_TAPS_BWD,
                    train_launches["hat_sample_taps_bwd"], bwd_main,
                    DCN_CALLS_PER_SHAPE, bwd_cases),
    ]
    wall_s = time.perf_counter() - t_start
    print(f"  chip_smoke wall time {wall_s:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           wall_s=wall_s, taps_cases=cases,
                           taps_bwd_cases=bwd_cases, end_to_end_f32=e2e,
                           train_step_f32=train_f32, serving=serving,
                           serving_launches=serve_launches,
                           forwards=forwards, training=training,
                           profile=profiled or None, kernels=rows), f,
                      indent=1)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
