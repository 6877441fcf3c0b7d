#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``minddet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with its time (CUDA events, warm L2), the plain
   version's time and the memory/compute bound: the sampler forward (K1f)
   and its backward (K1b) in f32 and bf16, the latter also at integer
   coordinates (spread 0, a DCN layer with zero offsets); the rotated-box
   intersection (K4) in f32 at the rotated NMS's (B, 900, 5)^2, B = 1 and
   8, on boxes drawn like decoded candidates, and on exact cases;
4. end to end in f32 (TF32 off): ``CenterNet`` predict on the card against
   the same model on the CPU (the plain path);
   b. the same for PointPillars predict from raw points at batch 1: heads,
      anchor mask, top-900 candidates, IoU matrix, kept lists;
5. end to end in f32 (TF32 off): one train step (512x512, batch 2) on the
   card against the same step on the CPU: loss, grad_norm, every
   parameter's gradient, the post-step parameters and BN statistics;
6. the main paths, each with every kernel's launch count set to 0 just
   before and read just after:
   a. serving: the flagship predict (CenterNet-R18-DCNv2, 80 classes,
      512x512, bf16, top-100) answers requests at batch 1 and 16;
   b. training: the flagship train step (``train_entry``: f32 params, bf16
      compute, batch TRAIN_BATCH) takes 2 warm-up and 10 timed steps on one
      batch; the loss must stay finite and fall;
   c. PointPillars serving (``pointpillars_entry``: KITTI car, f32, 18,000
      points per cloud) answers 2 warm-up and 10 timed requests at batch 1
      and 8; K4 launches once per request and no other kernel launches.

The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. ``--json PATH`` also writes every measurement there;
``--profile`` also breaks the serving requests (both models) and 3 train
steps down with ``torch.profiler``.
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


# K4: f32 arithmetic and compare operations per pair, counted from
# csrc/rotated_iou.cu (selects and the integer slot tests not counted):
# 10 for B's pair-relative corners; per clip edge 2 (edge vector) + 8 x 5
# (sides) + 8 x 11 (2 inside tests, den, |den| test, t, ix, iy); the
# shoelace 8 x 4 + 2.
OPS_PER_PAIR = 10 + 4 * (2 + 8 * 5 + 8 * 11) + 8 * 4 + 2
# The least work for the same areas: a pair whose centres lie farther apart
# than the sum of the boxes' circumscribed radii is disjoint, settled at 0 by
# dx, dy, dx^2 + dy^2 (2), r_a + r_b, its square and the compare; only the
# other pairs need the clip. A radius is 4 operations per box.
SEP_OPS_PER_PAIR = 7
SEP_OPS_PER_BOX = 4
PP_CANDIDATES = 900  # nms_pre of the PointPillars predict
PP_BATCHES = (1, 8)
# the exact cases of tests/test_rotated_iou.py:203-219
IOU_EXACT_BOXES = ((0.0, 0.0, 2.0, 4.0, 0.0),
                   (0.0, 0.0, 2.0, 4.0, math.pi / 2),
                   (10.0, 10.0, 2.0, 2.0, 0.3),
                   (0.0, 0.0, 1.0, 1.0, 0.0))
IOU_EXACT_AREAS = {(0, 0): 8.0, (1, 1): 8.0, (2, 2): 4.0, (3, 3): 1.0,
                   (0, 1): 4.0, (0, 2): 0.0, (0, 3): 1.0}
IOU_TOL = (1e-4, 1e-5)  # K4 vs plain: atol, rtol (sincos, FMA contraction)


def candidate_boxes(b: int, n: int, gen) -> torch.Tensor:
    """(b, n, 5) BEV boxes drawn like a detector's decoded candidates over
    the KITTI range: clusters of anchor-sized cars (1.6 x 3.9, sizes
    jittered) around 60 centres per sample, so a box overlaps its cluster;
    yaws near 0 and +-pi/2 for a third, uniform for a third, and the rest
    near-duplicates of another box (centre and size jittered by 1e-3 to
    5e-2, yaw by 1e-3 or turned by pi); 5 % large boxes (4-10 m) that
    contain their neighbours and 5 % small ones (0.2-0.5 m)."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    clusters = torch.stack([u(0.0, 69.12, b, 60), u(-39.68, 39.68, b, 60)],
                           -1)
    which = torch.randint(0, 60, (b, n), generator=gen)
    centre = torch.gather(clusters, 1, which[..., None].expand(-1, -1, 2))
    centre = centre + 1.5 * torch.randn(b, n, 2, generator=gen)
    w = 1.6 * torch.exp(0.1 * torch.randn(b, n, generator=gen))
    l = 3.9 * torch.exp(0.1 * torch.randn(b, n, generator=gen))
    kind = torch.rand(b, n, generator=gen)
    big = kind < 0.05
    small = (kind >= 0.05) & (kind < 0.1)
    w = torch.where(big, u(4.0, 10.0, b, n), torch.where(
        small, u(0.2, 0.5, b, n), w))
    l = torch.where(big, u(4.0, 10.0, b, n), torch.where(
        small, u(0.2, 0.5, b, n), l))
    axis = (torch.randint(-1, 2, (b, n), generator=gen) * math.pi / 2
            + 0.05 * torch.randn(b, n, generator=gen))
    yaw = torch.where(torch.rand(b, n, generator=gen) < 0.5, axis,
                      u(-math.pi, math.pi, b, n))
    boxes = torch.stack([centre[..., 0], centre[..., 1], w, l, yaw], -1)
    # the last third: near-duplicates of boxes in the first two thirds
    m = n // 3
    src = torch.randint(0, n - m, (b, m), generator=gen)
    dup = torch.gather(boxes, 1, src[..., None].expand(-1, -1, 5)).clone()
    jitter = 10 ** u(-3.0, math.log10(5e-2), b, m, 1)
    dup[..., :4] += jitter * torch.randn(b, m, 4, generator=gen)
    dup[..., 2:4] = dup[..., 2:4].abs()
    turn = torch.rand(b, m, generator=gen) < 0.3
    dup[..., 4] += torch.where(turn, torch.full((b, m), math.pi),
                               1e-3 * torch.randn(b, m, generator=gen))
    boxes[:, n - m:] = dup
    return boxes.contiguous()


def _rotated_iou_bound(boxes: torch.Tensor):
    """K4's bound on these (B, N, 5) boxes against themselves: the larger of
    the bytes (boxes read twice, the f32 areas written) and the operations
    of a separation test on every pair plus the clip on the pairs it does
    not reject. Returns (bound_ms, bound_by, share of pairs clipped)."""
    b, n, _ = boxes.shape
    r = 0.5 * torch.hypot(boxes[..., 2], boxes[..., 3])
    d2 = torch.cdist(boxes[..., :2].double(), boxes[..., :2].double()) ** 2
    near = int((d2 <= (r[..., :, None] + r[..., None, :]).double() ** 2)
               .sum())
    pairs = b * n * n
    bound_ms, bound_by = _bound(4 * pairs + 2 * 4 * 5 * b * n,
                                SEP_OPS_PER_PAIR * pairs
                                + SEP_OPS_PER_BOX * 2 * b * n
                                + OPS_PER_PAIR * near)
    return bound_ms, bound_by, near / pairs


def check_rotated_iou_kernel(dev, gen):
    """Phase 3: rotated_iou_intersect (K4) against its plain version at the
    rotated NMS's shape (B, 900, 5) x (B, 900, 5), B = 1 and 8, and on the
    exact cases."""
    from minddet_tpu_torch.ops import rotated_iou as ri

    exact = torch.tensor(IOU_EXACT_BOXES, device=dev)
    got = ri.rotated_intersection_bev(exact, exact).cpu()
    torch.cuda.synchronize()
    for (i, j), area in IOU_EXACT_AREAS.items():
        if abs(float(got[i, j]) - area) > 1e-4:
            raise AssertionError(f"K4 exact case ({i}, {j}): {float(got[i, j])}"
                                 f" != {area}")
    print(f"  rotated_iou exact cases: {len(IOU_EXACT_AREAS)} areas within "
          f"1e-4", flush=True)
    atol, rtol = IOU_TOL
    cases = []
    for b in PP_BATCHES:
        boxes = candidate_boxes(b, PP_CANDIDATES, gen).to(dev)
        got = ri.rotated_intersection_bev(boxes, boxes)
        torch.cuda.synchronize()
        ref = ri.rotated_intersection_bev_plain(boxes, boxes)
        err = (got - ref).abs()
        max_abs = float(err.max())
        ok = bool((err <= atol + rtol * ref.abs()).all())
        overlapping = float((ref > 0).float().mean())
        del got, ref, err
        ms = _cuda_ms(lambda: ri.rotated_intersection_bev(boxes, boxes),
                      iters=20)
        plain_ms = _cuda_ms(
            lambda: ri.rotated_intersection_bev_plain(boxes, boxes),
            iters=2, warmup=1)
        bound_ms, bound_by, clipped = _rotated_iou_bound(boxes)
        case = dict(shape=[b, PP_CANDIDATES, 5], max_abs_err=max_abs,
                    tolerance=f"abs <= {atol} + {rtol} * |plain|",
                    overlapping_share=overlapping, clipped_share=clipped,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
        cases.append(case)
        print(f"  rotated_iou ({b}, {PP_CANDIDATES}, 5)^2 max_abs="
              f"{max_abs:.3e} overlapping={overlapping:.4f} "
              f"clipped={clipped:.4f} kernel={ms * 1e3:8.1f}us "
              f"plain={plain_ms * 1e3:9.1f}us "
              f"bound={bound_ms * 1e3:6.1f}us ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"rotated_iou_intersect disagrees with its "
                                 f"plain version: {case}")
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


# f32 PointPillars predict, card vs CPU (phase 4b)
PP_HEAD_TOL = (1e-4, 1e-3)  # heads: atol, rtol, as phase 4
PP_TIE = 1e-5     # candidate scores this close may trade places
PP_NEAR = 1e-5    # IoUs this close to the NMS threshold may flip a keep
PP_BOX_TOL = (1e-3, 1e-5)  # decoded boxes (m, rad): atol, rtol; x = xt *
#   4.2 m + xa carries the heads' 1e-4; rtol * 70 m (the range's far end)
#   stays under atol
PP_IOU_TOL = 1e-4  # K4 on the CPU's candidates vs the plain version
PP_IOU_E2E_TOL = 1e-3  # IoUs of the card's vs the CPU's candidates
PP_DIR_TIE = 1e-3  # a heading may turn by pi where the dir logits tie
PP_BOX_CODE_STD = 0.15  # box head's std after calibrate_heads


@torch.no_grad()
def calibrate_heads(model, points, mask):
    """Scale the three 1x1 heads so that, on this cloud, the class logits
    have std 2, the box codes std PP_BOX_CODE_STD and the direction logits
    std 1 (the biases are zero). With flax's default initialisers and
    identity BN the RPN's activations shrink layer by layer and every score
    sits near 0.5, where card-vs-CPU rounding would reorder most of the top
    900. Small box codes keep the decoded boxes near the anchors' car size
    (the sizes are exp(code) times the anchor's)."""
    preds, _ = model(points, mask)
    for name, head, std in (("cls_preds", model.conv_cls, 2.0),
                            ("box_preds", model.conv_box, PP_BOX_CODE_STD),
                            ("dir_preds", model.conv_dir, 1.0)):
        head.weight.mul_(std / float(preds[name].std()))
    return model


def _candidate_checks(cand_g, cand_c, top_c, dir_c):
    """Candidates (one sample) of the card vs the CPU: sorted scores;
    anchors on one side only must tie with the CPU's last score; boxes of
    the common anchors (a heading turned by pi only where the CPU's dir
    logits tie). Returns (result, positions of the common anchors on the
    card, on the CPU, problems)."""
    bad = []
    sg, sc = cand_g["scores"][0].cpu(), cand_c["scores"][0]
    ig, ic = cand_g["anchor"][0].cpu(), cand_c["anchor"][0]
    r = dict(score_max_abs_err=float((sg - sc).abs().max()),
             candidates_reordered=int((ig != ic).sum()))
    if r["score_max_abs_err"] > PP_TIE:
        bad.append("candidate scores")
    one_side = sorted(set(ig.tolist()) ^ set(ic.tolist()))
    r["candidates_on_one_side"] = len(one_side)
    kth = float(sc[-1])
    if any(abs(float(top_c[a]) - kth) > PP_TIE for a in one_side):
        bad.append("a candidate on one side only that is no boundary tie")
    pos_g = {a: p for p, a in enumerate(ig.tolist())}
    pc = [p for p, a in enumerate(ic.tolist()) if a in pos_g]
    pg = [pos_g[int(ic[p])] for p in pc]
    bg = cand_g["boxes"][0].cpu()[pg]
    bc = cand_c["boxes"][0][pc]
    dyaw = torch.remainder(bg[:, 6] - bc[:, 6] + math.pi, 2 * math.pi) \
        - math.pi
    turned = dyaw.abs() > math.pi / 2
    gap = (dir_c[ic[pc], 0] - dir_c[ic[pc], 1]).abs()
    r["headings_turned"] = int(turned.sum())
    if bool((turned & (gap > PP_DIR_TIE)).any()):
        bad.append("a heading turned by pi where the dir logits do not tie")
    atol, rtol = PP_BOX_TOL
    err = (bg[:, :6] - bc[:, :6]).abs()
    yaw_err = torch.where(turned, torch.zeros_like(dyaw), dyaw.abs())
    r["box_max_abs_err"] = float(torch.cat([err.flatten(), yaw_err]).max())
    if not (bool((err <= atol + rtol * bc[:, :6].abs()).all())
            and bool((yaw_err <= atol).all())):
        bad.append("decoded boxes")
    return r, pg, pc, bad


def check_pointpillars_f32(dev):
    """Phase 4b: f32 PointPillars predict at batch 1 on the card against
    the same model on the CPU (TF32 off): the heads, the anchor mask, the
    top-900 candidates and their boxes, the IoU matrix (K4 on the CPU's
    candidates, and the card's own), and the kept lists where no candidate
    pair's IoU lies within PP_NEAR of the threshold or no pair's IoUs lie
    on two sides of it."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (CLOUD_POINTS, build_pointpillars,
                                         synthetic_clouds)
    from minddet_tpu_torch.ops import rotated_iou as ri
    from minddet_tpu_torch.ops.nms import rotated_nms

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = build_pointpillars("cpu")
    pts, mask = synthetic_clouds(1, cpu.pc_range, CLOUD_POINTS, seed=1)
    points, pmask = torch.from_numpy(pts), torch.from_numpy(mask)
    calibrate_heads(cpu, points, pmask)
    gpu = build_pointpillars(dev)
    gpu.load_state_dict(cpu.state_dict())
    kernels.reset_launches()
    with torch.inference_mode():
        preds_g, amask_g = gpu(points.to(dev), pmask.to(dev))
        det_g = gpu.predict_from_preds(preds_g, amask_g)
        cand_g = gpu.decode_candidates(preds_g, amask_g)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != {k.name: int(k is kernels.ROTATED_IOU)
                    for k in kernels.KERNELS}:
        raise AssertionError(f"f32 PointPillars predict launched {launches}"
                             " (want one rotated_iou_intersect)")
    with torch.inference_mode():
        preds_c, amask_c = cpu(points, pmask)
        det_c = cpu.predict_from_preds(preds_c, amask_c)
        cand_c = cpu.decode_candidates(preds_c, amask_c)

    result, bad = {}, []
    atol, rtol = PP_HEAD_TOL
    for name, ref in preds_c.items():
        got = preds_g[name].cpu()
        result[f"{name}_max_abs_err"] = float((got - ref).abs().max())
        result[f"{name}_std"] = float(ref.std())
        if not torch.allclose(got, ref, rtol=rtol, atol=atol):
            bad.append(f"head {name}")
    result["anchor_mask_share"] = float(amask_c.float().mean())
    if not torch.equal(amask_g.cpu(), amask_c):
        bad.append("anchor mask")
    top_c = torch.where(amask_c, torch.sigmoid(preds_c["cls_preds"]).max(
        -1).values, torch.zeros(()))[0]
    r, pg, pc, problems = _candidate_checks(cand_g, cand_c, top_c,
                                            preds_c["dir_preds"][0])
    result.update(r)
    bad += problems

    sc = cand_c["scores"][0]
    bev_c = cand_c["boxes"][0][:, [0, 1, 3, 4, 6]].contiguous()
    bev_g = cand_g["boxes"][0][:, [0, 1, 3, 4, 6]].contiguous()
    iou_c = ri.rotated_iou_bev(bev_c, bev_c)
    iou_k = ri.rotated_iou_bev(bev_c.to(dev), bev_c.to(dev)).cpu()
    iou_g = ri.rotated_iou_bev(bev_g, bev_g).cpu()
    result["iou_kernel_max_abs_err"] = float((iou_k - iou_c).abs().max())
    result["iou_e2e_max_abs_err"] = float(
        (iou_g[pg][:, pg] - iou_c[pc][:, pc]).abs().max())
    if result["iou_kernel_max_abs_err"] > PP_IOU_TOL:
        bad.append("IoU matrix of K4 on the CPU's candidates")
    if result["iou_e2e_max_abs_err"] > PP_IOU_E2E_TOL:
        bad.append("IoU matrix of the card's candidates")
    valid = sc > 0.09
    pair = torch.triu(valid[:, None] & valid[None, :], 1)
    near = int((pair & ((iou_c - 0.1).abs() < PP_NEAR)).sum())
    result.update(near_threshold_pairs=near, valid_candidates=int(
        valid.sum()), overlapping_pairs=int((pair & (iou_c > 0.1)).sum()),
        kept_cpu=int((det_c["labels"] >= 0).sum()),
        nms_passes_card=det_g["nms_passes"],
        nms_passes_cpu=det_c["nms_passes"])
    # The kept lists are compared where no pair's IoU is near the
    # threshold, and also wherever the two IoU matrices put every pair on
    # the same side of it (then the NMS decides the same by construction).
    # First the card's NMS on the CPU's candidates (only K4's rounding
    # differs), then the card's own predict.
    def same_side(a, b):
        return bool((((a > 0.1) == (b > 0.1)) | ~pair).all())

    idx_k, _, _ = rotated_nms(bev_c.to(dev)[None], sc.to(dev)[None], 0.1,
                              0.09, 300)
    idx_c, _, _ = rotated_nms(bev_c[None], sc[None], 0.1, 0.09, 300)
    compared = near == 0 or same_side(iou_k, iou_c)
    result["kept_same_inputs_compared"] = compared
    if compared and not torch.equal(idx_k.cpu(), idx_c):
        bad.append("kept lists of the card's NMS on the CPU's candidates")
    same = not (result["candidates_reordered"]
                or result["candidates_on_one_side"]
                or result["headings_turned"]) and (
        near == 0 or same_side(iou_g, iou_c))
    result["kept_end_to_end_compared"] = same
    if same and not (
            torch.equal(det_g["labels"].cpu(), det_c["labels"])
            and torch.allclose(det_g["scores"].cpu(), det_c["scores"],
                               rtol=0, atol=PP_TIE)
            and torch.allclose(det_g["boxes"].cpu(), det_c["boxes"],
                               rtol=PP_BOX_TOL[1], atol=PP_BOX_TOL[0])):
        bad.append("kept lists end to end")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    print("  f32 PointPillars card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 PointPillars predict, card vs CPU: {bad}:"
                             f" {result}")
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


def _sampler_launches(n: int):
    """Launch counts of a CenterNet path: n of each sampler kernel, no
    other kernel."""
    from minddet_tpu_torch import kernels

    return {k.name: n if k.name.startswith("hat_sample") else 0
            for k in kernels.KERNELS}


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
            if launches != _sampler_launches(DCN_LAYERS):
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
    if launches != _sampler_launches(DCN_LAYERS * steps):
        raise AssertionError(f"{launches} in {steps} train steps (want 9 "
                             f"of each sampler kernel per step)")
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


def serve_pointpillars(programs, dev):
    """Phase 6c, the PointPillars serving main path: f32 requests from raw
    points at each batch size, with the peak memory and the NMS's passes
    per request."""
    out = {}
    predicts = 0
    for b, (predict, (points, mask)) in programs.items():
        times, passes = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(points, mask)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
                passes.append(det["nms_passes"])
            predicts += 1
        boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
        kept = (labels >= 0).sum(1)
        ok = (boxes.shape == (b, 300, 7) and bool(torch.isfinite(boxes).all())
              and bool((kept > 0).all())
              and bool(((scores > 0.09) == (labels >= 0)).all())
              and bool((boxes[..., 3:6] >= 0).all()))
        if not ok:
            raise AssertionError(f"PointPillars predict at batch {b}: boxes "
                                 f"{tuple(boxes.shape)}, kept {kept.tolist()}"
                                 f", finite {bool(torch.isfinite(boxes).all())}")
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, clouds_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            nms_passes=passes, kept=kept.tolist())
        print(f"  PointPillars f32 batch {b}: {mean_s * 1e3:8.3f} ms/request"
              f" (p50 {r['ms_p50']:.3f}), {r['clouds_per_s']:7.1f} clouds/s,"
              f" peak {r['max_memory_allocated'] / 2 ** 30:.2f} GiB, NMS "
              f"passes {passes}, kept {r['kept']}", flush=True)
    return out, predicts


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


def profile_pointpillars(programs, requests: int = 3):
    """Where a PointPillars request's time goes, per batch size."""
    result = {}
    for b, (predict, args) in programs.items():
        result[f"b{b}"] = r = _profile(lambda: predict(*args), requests)
        _print_profile(f"PointPillars batch {b}", r)
    return result


def profile_train(step_fn, state, batch, steps: int = 3):
    """Where a train step's time goes."""
    r = _profile(lambda: step_fn(state, batch), steps)
    _print_profile(f"train batch {TRAIN_BATCH}", r)
    return r


def _kernel_row(kernel, launches, main_cases, calls_per_shape, cases):
    """One kernel's entry of the ``{"kernels": [...]}`` line: times and
    bounds summed over the calls of one main-path pass at its shapes."""
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
                    help="also profile the serving requests of both "
                         "models and 3 train steps (torch.profiler)")
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
    iou_cases = check_rotated_iou_kernel(dev, gen)

    print("phase 4: end to end, f32 predict, card vs CPU", flush=True)
    e2e = check_end_to_end_f32(dev, gen)
    print("phase 4b: end to end, f32 PointPillars predict, card vs CPU",
          flush=True)
    pp_f32 = check_pointpillars_f32(dev)

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
    if serve_launches != {**_sampler_launches(0),
                          "hat_sample_taps_fwd": DCN_LAYERS * forwards}:
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
    torch.cuda.empty_cache()

    print("phase 6c: main path, PointPillars f32 serving", flush=True)
    from minddet_tpu_torch.entry import pointpillars_entry

    pp_programs = {b: pointpillars_entry(device=dev, batch=b)
                   for b in PP_BATCHES}
    kernels.reset_launches()
    pp_serving, predicts = serve_pointpillars(pp_programs, dev)
    pp_launches = {k.name: k.launches for k in kernels.KERNELS}
    if pp_launches != {k.name: predicts * int(k is kernels.ROTATED_IOU)
                       for k in kernels.KERNELS}:
        raise AssertionError(f"PointPillars serving launched {pp_launches} "
                             f"for {predicts} requests (want one "
                             f"rotated_iou_intersect each, nothing else)")
    print(f"  kernels: rotated_iou_intersect launches="
          f"{pp_launches['rotated_iou_intersect']} requests={predicts} "
          f"launches == requests: True", flush=True)
    if args.profile:
        print("profile: PointPillars serving", flush=True)
        profiled["pointpillars"] = profile_pointpillars(pp_programs)
    del pp_programs

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
        # K4: one batch-8 request's call
        _kernel_row(kernels.ROTATED_IOU,
                    pp_launches["rotated_iou_intersect"],
                    [c for c in iou_cases if c["shape"][0] == 8], 1,
                    iou_cases),
    ]
    wall_s = time.perf_counter() - t_start
    print(f"  chip_smoke wall time {wall_s:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           wall_s=wall_s, taps_cases=cases,
                           taps_bwd_cases=bwd_cases,
                           rotated_iou_cases=iou_cases, end_to_end_f32=e2e,
                           pointpillars_f32=pp_f32,
                           train_step_f32=train_f32, serving=serving,
                           serving_launches=serve_launches,
                           forwards=forwards, training=training,
                           pointpillars_serving=pp_serving,
                           pointpillars_launches=pp_launches,
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
