#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile] [--probe]

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
   8 (PointPillars), and (6 B, 1000, 5)^2, B = 1 and 4 (CenterPoint's six
   tasks stacked), on boxes drawn like decoded candidates, at the train
   step's (8, 128, 5) proposals x (8, 64, 5) ground-truth slots, and on
   exact cases; the bounded segment max (K5f) at (B, 120000, 32), B = 1 and
   4 in f32 and B = 1 and 8 (the train step's) in bf16, on streams from the
   port's voxelizer, exactly; the bilinear row gather (K3f) at (B, 16384,
   384) x 2490 sample points, B = 1 and 4, and x 640 points at B = 8 (the
   train step's), f32 and bf16, points off the map included, with
   ``F.grid_sample`` timed beside it; the segment max's backward (K5b) at
   (B, 120000, 32), B = 1 and 8 in bf16 and B = 1 in f32, on uniform
   streams and on clustered ones (pillars filled to the cap of 20) with
   forced ties, exactly on segments of at most two rows; the row gather's
   backwards (K3dx with ``index_add_`` timed beside it, K3dcw) at
   (B, 16384, 384) x 640 sample points, B = 1 and 8, f32 and bf16, and at
   B = 8 on a heavy-duplicate stream (every point on one of four spots of
   one map row), K3dx's dx bit-equal between two calls; K1b with the share
   of its corners that took the global fallback and its shared memory per
   block, and also at bf16 C = 384 (any width, coordinate gradients
   repeating bit for bit); the flat sampler (K2f) at stage 1's (B, 128, 128, 64) with
   147,456 position-major samples per image, B = 1 and 16 in f32 and bf16
   at spread 0 and 1.5 and B = 128 in bf16, with ``F.grid_sample`` timed
   beside it, and its backward (K2b) at B = 128 in bf16 and B = 2 in f32,
   spread 0 and 1.5, both also at C = 3, 12, 20 and at coordinates of
   +-1e6 and +-3e9; and a bf16 DCN layer with a bias, rounded once;
4. end to end in f32 (TF32 off): ``CenterNet`` predict on the card against
   the same model on the CPU (the plain path), stage by stage;
   b. the same for PointPillars predict from raw points at batch 1: heads,
      anchor mask, top-900 candidates, IoU matrix, kept lists;
   c. the same for two-stage CenterPoint ``predict_refined`` at batch 1:
      PFN rows, BEV map, every task's maps, top-1000 candidates per task,
      IoU matrix, kept lists, refined boxes and scores;
   d. the same as 4 for CenterNet with DCN in all four backbone stages;
5. end to end in f32 (TF32 off): one train step (512x512, batch 2) on the
   card against the same step on the CPU: loss, grad_norm, every
   parameter's gradient, the post-step parameters and BN statistics; and
   against the same step in f64 compute on the CPU (the referee), part by
   part;
   b. ``bilinear_sample_2d`` differentiated with respect to the map and
      the coordinates at the second stage's shape, card against CPU (K3f,
      K3dx and K3dcw launch once each);
   c. one f32 two-stage CenterPoint train step at batch 1, card against
      CPU, with the same step in f64 compute on the CPU as referee: the
      second stage on the same proposals, then the whole step's loss,
      parts, grad_norm, gradients and BN statistics;
   d. one f32 train step of CenterNet with DCN in all four backbone stages
      (batch 2), the card held to the f64 referee, the f32 CPU reported;
6. the main paths, each with every kernel's launch count set to 0 just
   before and read just after:
   a. serving: the flagship predict (CenterNet-R18-DCNv2, 80 classes,
      512x512, bf16, top-100) answers requests at batch 1 and 16;
   b. training: the flagship train step (``train_entry``: f32 params, bf16
      compute, batch TRAIN_BATCH) takes 2 warm-up and 10 timed steps on one
      batch; the loss must stay finite and fall;
   c. PointPillars serving (``pointpillars_entry``: KITTI car, f32, 18,000
      points per cloud) answers 2 warm-up and 10 timed requests at batch 1
      and 8; K4 launches once per request and no other kernel launches;
   d. two-stage CenterPoint serving (``centerpoint_entry``: nuScenes
      pillars, f32, 120,000 points per cloud, heads calibrated so that the
      NMS has 1000 valid candidates per task) answers 2 warm-up and 10
      timed requests at batch 1 and 4; K5f, K4 and K3f launch once per
      request each, the sampler kernels never;
   e. two-stage CenterPoint training (``centerpoint_train_entry``: f32
      params, bf16 compute, batch 8, 120,000 points and up to 63 boxes per
      cloud) takes 2 warm-up and 10 timed steps on one batch; the loss must
      stay finite and fall; K5f, K5b, K3f, K3dx and K4 launch once per step
      each, K3dcw and the sampler kernels never;
   f. serving CenterNet with DCN in all four backbone stages
      (``centernet_dcn4_entry``) as in a: K2f launches twice and K1f nine
      times per forward;
   g. training it (``centernet_dcn4_train_entry``) as in b: K2f and K2b
      launch twice, K1f and K1b nine times per step.

The line before the last is the ``{"kernels": [...]}`` summary (a kernel's
``launches`` are those of the main paths only; K3dcw, which no entry point
reaches yet, has 0 there and phase 5b's count under its own key; every
number in it but ``bound_ms`` is measured in the run); the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. ``--json PATH`` also writes every measurement there;
``--profile`` also breaks the serving requests (every served model) and 3
train steps of each trained model down with ``torch.profiler``; ``--probe``
also compares the f32 CenterPoint train-mode forward layer by layer, on the
card and on the CPU, with the CPU's in f64.
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
ODD_TAPS_SHAPE = (32, 384)  # (H = W, C) of K1b's any-width case


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
    # and a width no shipped model has but the reference's taps path trains
    # (C % 128 == 0): 48 bf16 vectors per sample, not a power of two
    shapes = [(h, c, grid) for h, c in DCN_SHAPES] + [
        (ODD_TAPS_SHAPE[0], ODD_TAPS_SHAPE[1],
         [(BATCH, 1.5, torch.bfloat16)])]
    cases = []
    for h, c, grid in shapes:
        for b, spread, dtype in grid:
            x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
            g = torch.randn(b, h * h, TAPS * c, generator=dgen,
                            device=dev).to(dtype)
            ys, xs, sc = (t.to(dev) for t in
                          _dcn_coords(b, h, h, TAPS, spread, gen))
            got = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
            again = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, a2)
                         for a, a2 in zip(got[1:], again[1:]))
            del again
            # the corners added outside their block's dx window
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            hs._taps_bwd_cuda(g, x, ys, xs, sc, stats=stats)
            fallback, added = (int(v) for v in stats.tolist())
            plan = hs.taps_bwd_plan(b, h, h, c, TAPS, h * h)
            ref = hs.hat_sample_2d_taps_bwd_plain(g.float(), x.float(),
                                                  ys, xs, sc)
            errs = {}
            bad = [] if repeat else ["dys/dxs/dscale differ between runs"]
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
                        errors=errs, tolerance=BWD_TOL, repeat=repeat,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, plan=plan,
                        fallback_share=fallback / max(added, 1))
            cases.append(case)
            print(f"  taps bwd x{case['shape']} spread={spread:4.1f} "
                  f"{case['dtype']:8s} fallback={case['fallback_share']:.4f}"
                  f" smem={plan['smem_bytes']} err dx={errs['dx']:.2e} "
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


# The flat sampler's path: stage 1 of ResNet-18 with DCN in all four stages
# at 512x512, a stride-1 3x3 DCN over the (B, 128, 128, 64) map, two layers
# per forward; its samples are position-major, (B, 128 * 128 * 9).
FLAT_SHAPE = (128, 64)  # (H = W, C)
FLAT_LAYERS = 2
FLAT_ODD = (32, (3, 12, 20))  # (H = W, widths) of the any-width cases
FAR = (1e6, -1e6, 3e9, -3e9)  # the reference pads with -1e6


def _flat_coords(b, h, w, spread, gen):
    """Position-major (B, P*K) coordinates and mask of a stride-1 3x3 DCN
    at (h, w), as ``ops/dcn.py``'s flat branch lays them out."""
    flat = lambda t: t.transpose(1, 2).reshape(b, -1).contiguous()
    return tuple(flat(t) for t in _dcn_coords(b, h, w, TAPS, spread, gen))


def _put_far(ys, xs):
    """The first len(FAR) samples of every image moved to FAR: in y for
    image 0, in x for the others. Returns the index of the moved ones."""
    far = torch.tensor(FAR, device=ys.device)
    ys[0, :len(FAR)] = far
    xs[1:, :len(FAR)] = far
    return slice(0, len(FAR))


def _flat_grid(main):
    """(B, H, C, spread, dtype, far) of the phase 3 cases: ``main`` at
    stage 1's shape, then the odd widths and far-away coordinates."""
    h, widths = FLAT_ODD
    odd = [(2, h, c, 1.5, dtype, False) for c in widths
           for dtype in (torch.float32, torch.bfloat16)]
    far = [(2, h, FLAT_SHAPE[1], 1.5, dtype, True)
           for dtype in (torch.float32, torch.bfloat16)]
    return main + odd + far


def check_flat_kernel(dev, gen):
    """Phase 3: hat_sample_flat_fwd (K2f) against its plain version: at
    stage 1's (B, 128, 128, 64) with 147,456 samples per image, B = 1 and
    16 (serving) in f32 and bf16 at spread 0 and 1.5, and B = 128 (the
    train step's forward) in bf16 at spread 1.5; C = 3, 12 and 20 on a
    32x32 map; samples at +-1e6 and +-3e9, which must give exactly 0.
    ``F.grid_sample`` (zero padding, ``align_corners=True``) on the same
    points without the scale is timed beside the stage-1 cases, for
    information: the modulation would be a second call."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(2)
    h0, c0 = FLAT_SHAPE
    main = [(b, h0, c0, spread, dtype, False) for b in (1, BATCH)
            for spread in (0.0, 1.5)
            for dtype in (torch.float32, torch.bfloat16)]
    main += [(TRAIN_BATCH, h0, c0, 1.5, torch.bfloat16, False)]
    cases = []
    for b, h, c, spread, dtype, far in _flat_grid(main):
        x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
        ys, xs, sc = (t.to(dev) for t in _flat_coords(b, h, h, spread, gen))
        moved = _put_far(ys, xs) if far else None
        got = hs.hat_sample_2d(x, ys, xs, sc)
        torch.cuda.synchronize()
        ref = hs.hat_sample_2d_plain(x.float(), ys, xs, sc)
        err = (got.float() - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        if dtype == torch.float32:
            tol = "f32: abs <= 1e-5"
            ok = max_abs <= 1e-5
        else:  # within one bf16 ulp of the plain f32 result
            tol = "bf16: abs <= 1e-2 + 2**-7 * |plain f32|"
            ok = bool((err <= 1e-2 + 2 ** -7 * ref.abs()).all())
        if far:
            ok = ok and bool((got[:, moved] == 0).all())
        del got, ref, err
        name = str(dtype).replace("torch.", "")
        case = dict(shape=[b, h, h, c], samples=ys.shape[1], spread=spread,
                    dtype=name, far=far, max_abs_err=max_abs,
                    max_rel_err=max_rel, tolerance=tol)
        case["ms"] = _cuda_ms(lambda: hs.hat_sample_2d(x, ys, xs, sc),
                              iters=5 if b == TRAIN_BATCH else 20)
        case["plain_ms"] = _cuda_ms(
            lambda: hs.hat_sample_2d_plain(x, ys, xs, sc), iters=3,
            warmup=1)
        case["bound_ms"], case["bound_by"] = _taps_bound(
            x, ys[:, None], xs[:, None])
        if h == h0 and not far:
            grid = torch.stack([xs / (h - 1) * 2 - 1, ys / (h - 1) * 2 - 1],
                               -1)[:, None].to(dtype)
            xn = x.permute(0, 3, 1, 2)
            case["grid_sample_ms"] = _cuda_ms(
                lambda: F.grid_sample(xn, grid, padding_mode="zeros",
                                      align_corners=True),
                iters=5 if b == TRAIN_BATCH else 20)
            del grid
        cases.append(case)
        print(f"  flat x{case['shape']} N={case['samples']} spread="
              f"{spread:3.1f} {name:8s}{' far' if far else ''} "
              f"max_abs={max_abs:.3e} kernel={case['ms'] * 1e3:8.1f}us "
              f"plain={case['plain_ms'] * 1e3:9.1f}us "
              f"bound={case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})"
              + (f" grid_sample={case['grid_sample_ms'] * 1e3:.1f}us"
                 if "grid_sample_ms" in case else ""), flush=True)
        if not ok:
            raise AssertionError(f"hat_sample_flat_fwd disagrees with its "
                                 f"plain version ({tol}): {case}")
        del x, ys, xs, sc
    return cases


# K2b vs plain: dys, dxs, dscale as K1b's (BWD_TOL, against |plain|); dx as
# K3dx's, against the same sum over absolute values, sum |scale w g|: the
# f32 atomics add up to ~36 samples' terms per texel in any order, and in
# bf16 that sum is rounded once
FLAT_BWD_TOL = {"dys": BWD_TOL["dys"], "dxs": BWD_TOL["dxs"],
                "dscale": BWD_TOL["dscale"], "dx_float32": (1e-6, 1e-5),
                "dx_bfloat16": (1e-6, 2 ** -8)}


def check_flat_bwd_kernel(dev, gen):
    """Phase 3: hat_sample_flat_bwd (K2b) against its plain version: at
    stage 1's (B, 128, 128, 64), B = 128 in bf16 (the train step's) and B =
    2 in f32, at spread 0 (zero offsets: dys and dxs are forward
    differences and must not vanish) and 1.5; C = 3, 12 and 20 on a 32x32
    map; samples at +-1e6 and +-3e9 (no gradient). dys, dxs and dscale
    must repeat bit for bit from one call to the next."""
    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(3)
    h0, c0 = FLAT_SHAPE
    main = [(TRAIN_BATCH, h0, c0, spread, torch.bfloat16, False)
            for spread in (0.0, 1.5)]
    main += [(CHECK_BATCH, h0, c0, spread, torch.float32, False)
             for spread in (0.0, 1.5)]
    cases = []
    for b, h, c, spread, dtype, far in _flat_grid(main):
        name = str(dtype).replace("torch.", "")
        x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
        ys, xs, sc = (t.to(dev) for t in _flat_coords(b, h, h, spread, gen))
        moved = _put_far(ys, xs) if far else None
        g = torch.randn(b, ys.shape[1], c, generator=dgen,
                        device=dev).to(dtype)
        got = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
        again = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, a2) for a, a2 in zip(got[1:], again[1:]))
        del again
        bad = [] if repeat else ["dys/dxs/dscale differ between runs"]
        ref = hs.hat_sample_2d_bwd_plain(g.float(), x.float(), ys, xs, sc)
        errs = {}
        for key, a, r in zip(("dx", "dys", "dxs", "dscale"), got, ref):
            err = (a.float() - r).abs()
            errs[key] = float(err.max())
            errs[f"{key}_max_abs"] = float(r.abs().max())
            if key == "dx":
                atol, rtol = FLAT_BWD_TOL[f"dx_{name}"]
                size = hs.hat_sample_2d_bwd_plain(g.float().abs(), x.float(),
                                                  ys, xs, sc.abs())[0]
                ok = a.dtype == dtype and bool(
                    (err <= atol + rtol * size).all())
                del size
            else:
                atol, rtol = FLAT_BWD_TOL[key]
                ok = bool((err <= atol + rtol * r.abs()).all())
                if far:
                    ok = ok and bool((a[:, moved] == 0).all())
            if not ok:
                bad.append(f"{key} (atol {atol}, rtol {rtol})")
            del err
        if spread == 0.0 and min(errs["dys_max_abs"],
                                 errs["dxs_max_abs"]) == 0.0:
            bad.append("dys/dxs vanish at integer coordinates")
        del got, ref
        case = dict(shape=[b, h, h, c], samples=ys.shape[1], spread=spread,
                    dtype=name, far=far,
                    max_abs_err=max(errs[k] for k in
                                    ("dx", "dys", "dxs", "dscale")),
                    errors=errs, tolerance=FLAT_BWD_TOL, repeat=repeat)
        case["ms"] = _cuda_ms(lambda: hs.hat_sample_2d_bwd(g, x, ys, xs, sc),
                              iters=5 if b == TRAIN_BATCH else 20)
        case["plain_ms"] = _cuda_ms(
            lambda: hs.hat_sample_2d_bwd_plain(g, x, ys, xs, sc), iters=3,
            warmup=1)
        case["bound_ms"], case["bound_by"] = _taps_bwd_bound(
            x, ys[:, None], xs[:, None])
        cases.append(case)
        print(f"  flat bwd x{case['shape']} spread={spread:3.1f} {name:8s}"
              f"{' far' if far else ''} err dx={errs['dx']:.2e} "
              f"dys={errs['dys']:.2e} dxs={errs['dxs']:.2e} "
              f"dsc={errs['dscale']:.2e} (|dys|max {errs['dys_max_abs']:.1f})"
              f" repeat={repeat} kernel={case['ms'] * 1e3:8.1f}us "
              f"plain={case['plain_ms'] * 1e3:9.1f}us "
              f"bound={case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})",
              flush=True)
        if bad:
            raise AssertionError(f"hat_sample_flat_bwd disagrees with its "
                                 f"plain version: {', '.join(bad)}: {case}")
        del x, ys, xs, sc, g
    return cases


def check_dcn_bias_rounding(dev):
    """Phase 3: a bf16 DCN layer with a bias on the card (stage 1's shape,
    zero offsets, no mask: K2f, then the contraction) against the same
    layer as an f64 conv plus bias rounded once to bf16. The bias is added
    to the f32 accumulator and the sum rounded once, so outputs one rounding
    apart are as rare as f32 summation order makes them (< 2e-3); adding it
    after the bf16 matmul (two roundings) puts ~1 in 5 off."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops.dcn import deform_conv2d

    g = torch.Generator().manual_seed(7)
    h, c = FLAT_SHAPE
    x = torch.randn(1, h, h, c, generator=g).bfloat16()
    w = (torch.randn(3, 3, c, c, generator=g) / 24).bfloat16()
    bias = (3 * torch.randn(c, generator=g)).bfloat16()
    offs = torch.zeros(1, h, h, 9, 2)
    got = deform_conv2d(x.to(dev), offs.to(dev), None, w.to(dev),
                        bias.to(dev)).cpu()
    ref = (F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), bias.double(), padding=1)
           .permute(0, 2, 3, 1).bfloat16())
    off = float((got != ref).float().mean())
    worst = float((got.double() - ref.double()).abs().max())
    print(f"  DCN bf16 with bias vs f64 rounded once: {off:.2e} of the "
          f"outputs one rounding off (max {worst:.3e})", flush=True)
    if off >= 2e-3:
        raise AssertionError(f"DCN bias rounding: {off} of the outputs "
                             f"differ from the f64 sum rounded once")
    return dict(share_off=off, max_abs_err=worst)


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
CP_CANDIDATES = 1000  # nms_pre of the CenterPoint predict, per task
CP_TASKS = 6
CP_NMS_POST = 83  # detections kept per task
CP_BATCHES = (1, 4)
TRAIN_CP_BATCH = 8  # the two-stage train step's (bench.py:bench_two_stage)
CP_PROPOSALS = 128  # num_proposals of the two-stage train step
# (samples, boxes) of K4's calls: one per PointPillars request, and one per
# CenterPoint request over its tasks stacked on the sample axis
IOU_SHAPES = tuple((b, PP_CANDIDATES) for b in PP_BATCHES) + tuple(
    (CP_TASKS * b, CP_CANDIDATES) for b in CP_BATCHES)
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


def _rotated_iou_bound(boxes: torch.Tensor, others: torch.Tensor = None):
    """K4's bound on (B, N, 5) boxes against ``others`` (B, M, 5; themselves
    when not given): the larger of the bytes (both box sets read, the f32
    areas written) and the operations of a separation test on every pair
    plus the clip on the pairs it does not reject. Returns (bound_ms,
    bound_by, share of pairs clipped)."""
    others = boxes if others is None else others
    b, n, _ = boxes.shape
    m = others.shape[1]
    r1 = 0.5 * torch.hypot(boxes[..., 2], boxes[..., 3])
    r2 = 0.5 * torch.hypot(others[..., 2], others[..., 3])
    d2 = torch.cdist(boxes[..., :2].double(), others[..., :2].double()) ** 2
    near = int((d2 <= (r1[..., :, None] + r2[..., None, :]).double() ** 2)
               .sum())
    pairs = b * n * m
    bound_ms, bound_by = _bound(4 * pairs + 4 * 5 * b * (n + m),
                                SEP_OPS_PER_PAIR * pairs
                                + SEP_OPS_PER_BOX * b * (n + m)
                                + OPS_PER_PAIR * near)
    return bound_ms, bound_by, near / pairs


BEV5 = (0, 1, 3, 4, 8)  # x, y, w, l, yaw of a 9-number box
TRAIN_CP_GT = 64  # ground-truth slots per cloud of the train step


def train_step_box_pairs(b: int, pc_range, gen):
    """The K4 call of one two-stage train step: (b, 128, 5) proposals against
    (b, 64, 5) ground-truth slots. Half the slots are proposals moved by
    0.1 m (foreground) or 1 m and a little in size and yaw, a quarter are
    other boxes, and the rest are empty slots (all zeros), as a padded
    ground-truth array has them."""
    props = proposal_boxes(b, CP_PROPOSALS, pc_range, gen)
    gt = torch.zeros(b, TRAIN_CP_GT, 9)
    k = TRAIN_CP_GT // 2
    gt[:, :k] = props[:, 1:2 * k:2]  # odd slots: none of the zeroed tenths
    gt[:, 0:k:2, 0] += 0.1
    gt[:, 1:k:2, 0] += 1.0
    gt[:, :k, 3:5] *= 1.05
    gt[:, :k, 8] += 0.02
    gt[:, k:k + k // 2] = proposal_boxes(b, k // 2, pc_range, gen)
    return (props[..., BEV5].contiguous(), gt[..., BEV5].contiguous())


def check_rotated_iou_kernel(dev, gen, pc_range):
    """Phase 3: rotated_iou_intersect (K4) against its plain version at the
    rotated NMS's shapes (``IOU_SHAPES``: (B, 900, 5)^2 for PointPillars,
    (6 B, 1000, 5)^2 for CenterPoint), at the two-stage train step's
    (8, 128, 5) x (8, 64, 5) over ``pc_range`` and on the exact cases."""
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
    train_pair = train_step_box_pairs(TRAIN_CP_BATCH, pc_range,
                                      torch.Generator().manual_seed(5))
    for b, n in IOU_SHAPES + ((TRAIN_CP_BATCH, CP_PROPOSALS),):
        if n == CP_PROPOSALS:
            boxes, others = (t.to(dev) for t in train_pair)
        else:
            boxes = others = candidate_boxes(b, n, gen).to(dev)
        got = ri.rotated_intersection_bev(boxes, others)
        torch.cuda.synchronize()
        ref = ri.rotated_intersection_bev_plain(boxes, others)
        err = (got - ref).abs()
        max_abs = float(err.max())
        ok = bool((err <= atol + rtol * ref.abs()).all())
        overlapping = float((ref > 0).float().mean())
        del got, ref, err
        ms = _cuda_ms(lambda: ri.rotated_intersection_bev(boxes, others),
                      iters=20)
        plain_ms = _cuda_ms(
            lambda: ri.rotated_intersection_bev_plain(boxes, others),
            iters=2, warmup=1)
        bound_ms, bound_by, clipped = _rotated_iou_bound(boxes, others)
        case = dict(shape=[b, n, 5], against=[b, others.shape[1], 5],
                    dtype="float32", max_abs_err=max_abs,
                    tolerance=f"abs <= {atol} + {rtol} * |plain|",
                    overlapping_share=overlapping, clipped_share=clipped,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
        cases.append(case)
        print(f"  rotated_iou ({b}, {n}, 5) x ({b}, {others.shape[1]}, 5) "
              f"max_abs={max_abs:.3e} overlapping={overlapping:.4f} "
              f"clipped={clipped:.4f} kernel={ms * 1e3:8.1f}us "
              f"plain={plain_ms * 1e3:9.1f}us "
              f"bound={bound_ms * 1e3:6.1f}us ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"rotated_iou_intersect disagrees with its "
                                 f"plain version: {case}")
    return cases


PFN_HALF_WIDTH = 32  # the non-last PFN layer's units: K5f's channels


def _nusc_clouds(model, batch: int, seed: int, dev):
    """``batch`` synthetic nuScenes-sized clouds for ``model``, on ``dev``."""
    from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS,
                                         NUSC_POINT_FEATURES,
                                         synthetic_clouds)

    pts, mask = synthetic_clouds(batch, model.pc_range, NUSC_CLOUD_POINTS,
                                 seed=seed, num_features=NUSC_POINT_FEATURES)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)


def check_seg_max_kernel(dev, model):
    """Phase 3: seg_full_max (K5f) against its plain version, exactly, on
    the streams the port's voxelizer makes of ``model``'s 120,000-point
    clouds (pillars over the point cap, more pillars than ``max_voxels``),
    at the serving batches in f32 and at the train step's batch 8 in bf16;
    x is N(0, 1), so the kernel's zeros outside the kept rows show."""
    from minddet_tpu_torch.ops import seg_max as sm
    from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch

    bound = model.max_points_per_voxel
    dgen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for b, dtype in ((1, torch.float32), (CP_BATCHES[-1], torch.float32),
                     (1, torch.bfloat16), (TRAIN_CP_BATCH, torch.bfloat16)):
        points, mask = _nusc_clouds(model, b, 2, dev)
        sv = voxelize_stream_batch(points, mask, model.voxel_size,
                                   model.pc_range, model.max_voxels, bound,
                                   model.voxel_drop_order)
        first, last = sv.first, sv.last
        n = first.shape[1]
        if not torch.equal(sm.seg_covered(first, last, bound), sv.keep):
            raise AssertionError("seg_covered is not the stream's keep mask")
        x = torch.randn(b, n, PFN_HALF_WIDTH, generator=dgen,
                        device=dev).to(dtype)
        got = sm.seg_full_max_bounded(first, last, x, bound)
        torch.cuda.synchronize()
        ref = sm.seg_full_max_bounded_plain(first, last, x, bound)
        max_abs = float((got.float() - ref.float()).abs().max())
        ok = torch.equal(got, ref)
        kept = float(sv.keep.float().mean())
        del got, ref
        ms = _cuda_ms(lambda: sm.seg_full_max_bounded(first, last, x, bound),
                      iters=20)
        plain_ms = _cuda_ms(
            lambda: sm.seg_full_max_bounded_plain(first, last, x, bound),
            iters=3, warmup=1)
        # x read once, out written once, the two flag planes read once; one
        # max per value
        bound_ms, bound_by = _bound(2 * x.numel() * x.element_size()
                                    + 2 * b * n, x.numel())
        case = dict(shape=[b, n, PFN_HALF_WIDTH], bound=bound,
                    dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=max_abs, tolerance="exact", kept_share=kept,
                    pillars=sv.num_voxels.tolist(), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
        cases.append(case)
        print(f"  seg_full_max x{case['shape']} {case['dtype']:8s} max_abs="
              f"{max_abs:.3e} kept rows {kept:.3f} kernel={ms * 1e3:8.1f}us "
              f"plain={plain_ms * 1e3:9.1f}us bound={bound_ms * 1e3:6.1f}us "
              f"({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"seg_full_max disagrees with its plain "
                                 f"version: {case}")
    return cases


def proposal_boxes(b: int, n: int, pc_range, gen) -> torch.Tensor:
    """(b, n, 9) boxes [x, y, z, w, l, h, vx, vy, yaw] like a request's
    stage-1 detections: centres uniform over the range widened by 5 m (so
    some sample points fall off the map), vehicle sizes, any yaw, and every
    tenth box all zeros (a dropped slot, which is sampled all the same)."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    boxes = torch.zeros(b, n, 9)
    boxes[..., 0] = u(pc_range[0] - 5.0, pc_range[3] + 5.0, b, n)
    boxes[..., 1] = u(pc_range[1] - 5.0, pc_range[4] + 5.0, b, n)
    boxes[..., 3] = 1.9 * torch.exp(0.2 * torch.randn(b, n, generator=gen))
    boxes[..., 4] = 4.5 * torch.exp(0.2 * torch.randn(b, n, generator=gen))
    boxes[..., 5] = 1.7
    boxes[..., 8] = u(-math.pi, math.pi, b, n)
    boxes[:, ::10] = 0.0
    return boxes


# K3f vs plain: f32 sums of four products, in another order (FMAs in the
# kernel); bf16 is that f32 sum rounded once (half an ulp, 2**-9 relative),
# with room for the order flipping a rounding
GATHER_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-5, 2 ** -8)}


def check_bilinear_kernel(dev, gen, model):
    """Phase 3: bilinear_gather_fwd (K3f) against its plain version at the
    second stage's shapes: ``model``'s BEV map (B, 128 * 128, 384) and 5
    sample points for each of its 6 * 83 detection slots (2490 points) at
    the serving batches, and for each of the train step's 128 proposals
    (640 points) at its batch 8; with the time of ``F.grid_sample`` (bilinear, zero padding,
    align_corners) on the same map and points."""
    import torch.nn.functional as F

    from minddet_tpu_torch.models.heads.second_stage import bev_sample_points
    from minddet_tpu_torch.ops import bilinear as bl

    h = model.grid_ny // model.out_size_factor
    w = model.grid_nx // model.out_size_factor
    c = model.rpn.out_channels
    serve_slots = len(model.task_num_classes) * CP_NMS_POST
    cell_x = model.voxel_size[0] * model.out_size_factor
    cell_y = model.voxel_size[1] * model.out_size_factor
    cases = []
    train_gen = torch.Generator().manual_seed(6)
    for b, slots, rng in tuple((b, serve_slots, gen) for b in CP_BATCHES) + (
            (TRAIN_CP_BATCH, CP_PROPOSALS, train_gen),):
        bev32 = torch.randn(b, c, h, w, generator=rng).to(dev).contiguous(
            memory_format=torch.channels_last)
        boxes = proposal_boxes(b, slots, model.pc_range, rng).to(dev)
        pts = bev_sample_points(boxes).reshape(b, slots * 5, 2)
        fx = (pts[..., 0] - model.pc_range[0]) / cell_x
        fy = (pts[..., 1] - model.pc_range[1]) / cell_y
        ci, cw = bl.bilinear_corners(fy, fx, h, w)
        p = ci.shape[1]
        off_map = float((ci < 0).float().mean())
        touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                      for i in range(b))
        grid = torch.stack([2 * fx / (w - 1) - 1, 2 * fy / (h - 1) - 1],
                           -1)[:, None]
        for dtype in (torch.float32, torch.bfloat16):
            bev = bev32.to(dtype)
            x = bev.permute(0, 2, 3, 1).view(b, h * w, c)
            got = bl.bilinear_gather(x, ci, cw)
            torch.cuda.synchronize()
            ref = bl.bilinear_gather_plain(x.float(), ci, cw)
            err = (got.float() - ref).abs()
            max_abs = float(err.max())
            name = str(dtype).replace("torch.", "")
            atol, rtol = GATHER_TOL[name]
            ok = bool((err <= atol + rtol * ref.abs()).all())
            # the second stage's own call gives the same rows
            via_model = model.extractor(bev, boxes).reshape(b, p, c)
            ok_model = torch.equal(via_model, got)
            # grid_sample takes the grid in the map's type, so in bf16 it
            # samples at rounded coordinates: timed, not compared
            lib_err = None
            if dtype == torch.float32:
                lib = F.grid_sample(bev, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
                lib_err = float((lib[:, :, 0].permute(0, 2, 1) - ref).abs()
                                .max())
                del lib
            del got, ref, err, via_model
            ms = _cuda_ms(lambda: bl.bilinear_gather(x, ci, cw), iters=50)
            plain_ms = _cuda_ms(lambda: bl.bilinear_gather_plain(x, ci, cw),
                                iters=5, warmup=1)
            g = grid.to(dtype)
            library_ms = _cuda_ms(
                lambda: F.grid_sample(bev, g, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True), iters=20)
            # out written once, the rows the corners touch read once, ci
            # and cw read once; 4 FMAs per output value
            elt = x.element_size()
            bound_ms, bound_by = _bound(
                b * p * c * elt + touched * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            case = dict(shape=[b, h * w, c], points=p, dtype=name,
                        max_abs_err=max_abs,
                        tolerance=f"abs <= {atol} + {rtol} * |plain f32|",
                        off_map_corner_share=off_map, touched_rows=touched,
                        library_max_abs_err=lib_err, ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            cases.append(case)
            print(f"  bilinear_gather x{case['shape']} P={p} {name:8s} "
                  f"max_abs={max_abs:.3e} off-map corners {off_map:.3f} "
                  f"kernel={ms * 1e3:7.1f}us plain={plain_ms * 1e3:8.1f}us "
                  f"grid_sample={library_ms * 1e3:7.1f}us (differs by "
                  f"{lib_err}) bound={bound_ms * 1e3:5.1f}us ({bound_by})",
                  flush=True)
            if not (ok and ok_model):
                raise AssertionError(
                    f"bilinear_gather_fwd disagrees with its plain version "
                    f"(kernel {ok}, through the extractor {ok_model}): "
                    f"{case}")
    return cases


def _clustered_clouds(model, batch: int, seed: int, dev):
    """``batch`` clouds of 120,000 points drawn around 4,000 pillar centres
    each (30 points per pillar on average, so most pillars pass the cap of
    20 points and have rows past their last kept row)."""
    import numpy as np

    from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS,
                                         NUSC_POINT_FEATURES)

    rs = np.random.RandomState(seed)
    x0, y0, z0, x1, y1, z1 = model.pc_range
    cells = rs.randint(0, model.grid_nx * model.grid_ny, (batch, 4000))
    pick = rs.randint(0, 4000, (batch, NUSC_CLOUD_POINTS))
    cell = np.take_along_axis(cells, pick, 1)
    inside = rs.uniform(0.05, 0.95, (batch, NUSC_CLOUD_POINTS, 2))
    pts = np.zeros((batch, NUSC_CLOUD_POINTS, NUSC_POINT_FEATURES), np.float32)
    pts[..., 0] = x0 + (cell % model.grid_nx + inside[..., 0]) \
        * model.voxel_size[0]
    pts[..., 1] = y0 + (cell // model.grid_nx + inside[..., 1]) \
        * model.voxel_size[1]
    pts[..., 2] = rs.uniform(z0, z1, (batch, NUSC_CLOUD_POINTS))
    pts[..., 3:] = rs.uniform(0, 0.45, (batch, NUSC_CLOUD_POINTS,
                                        NUSC_POINT_FEATURES - 3))
    return (torch.from_numpy(pts).to(dev),
            torch.ones(batch, NUSC_CLOUD_POINTS, dtype=torch.bool,
                       device=dev))


# K5b vs plain, err <= atol + rtol * |plain|. Both sum g in f32, the kernel
# row by row from the last kept row back, the plain version by shift levels:
# segments of one or two rows give the same bits; longer ones differ by f32
# rounding, and in bf16 that may flip the one rounding of the result
SEG_BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}


def check_seg_max_bwd_kernel(dev, model):
    """Phase 3: seg_full_max_bwd (K5b) against its plain version on streams
    of the port's voxelizer: uniform clouds (the main path's; ~1.25 kept
    points per pillar, x ~ N(0, 1), no ties) and clustered clouds with x in
    {0, 1, 2} (pillars at the cap of 20 rows, ties in every segment). Rows
    of segments with at most two kept rows, and rows that are not kept,
    must agree exactly; the others within ``SEG_BWD_TOL``."""
    from minddet_tpu_torch.ops import seg_max as sm
    from minddet_tpu_torch.ops.voxelize import (_seg_bcast_bounded,
                                                _seg_sum_bounded,
                                                voxelize_stream_batch)

    bound = model.max_points_per_voxel
    dgen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for b, dtype, kind in ((1, torch.float32, "uniform"),
                           (1, torch.bfloat16, "uniform"),
                           (TRAIN_CP_BATCH, torch.bfloat16, "uniform"),
                           (1, torch.float32, "clustered, ties"),
                           (1, torch.bfloat16, "clustered, ties")):
        clouds = _nusc_clouds if kind == "uniform" else _clustered_clouds
        points, mask = clouds(model, b, 3, dev)
        sv = voxelize_stream_batch(points, mask, model.voxel_size,
                                   model.pc_range, model.max_voxels, bound,
                                   model.voxel_drop_order)
        first, last = sv.first, sv.last
        n = first.shape[1]
        shape = (b, n, PFN_HALF_WIDTH)
        if kind == "uniform":
            x = torch.randn(shape, generator=dgen, device=dev).to(dtype)
        else:
            x = torch.randint(0, 3, shape, generator=dgen,
                              device=dev).to(dtype)
        g = torch.randn(shape, generator=dgen, device=dev).to(dtype)
        m = sm.seg_full_max_bounded(first, last, x, bound)
        got = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
        torch.cuda.synchronize()
        ref = sm.seg_full_max_bounded_bwd_plain(first, last, x, m, g, bound)
        rows = _seg_bcast_bounded(last, _seg_sum_bounded(
            first, sv.keep.float(), bound), bound)  # kept rows per segment
        short = ~sv.keep | (rows <= 2)
        err = (got.float() - ref.float()).abs()
        name = str(dtype).replace("torch.", "")
        atol, rtol = SEG_BWD_TOL[name]
        ok = (torch.equal(got[short], ref[short])
              and bool((err <= atol + rtol * ref.float().abs()).all()))
        tie = (x == m) & sv.keep[..., None]
        tied = tie & (_seg_bcast_bounded(last, _seg_sum_bounded(
            first, tie.float(), bound), bound) > 1)
        case = dict(shape=list(shape), bound=bound, dtype=name, stream=kind,
                    max_abs_err=float(err.max()),
                    tolerance=f"exact on segments of <= 2 rows, else abs <= "
                              f"{atol} + {rtol} * |plain|",
                    kept_share=float(sv.keep.float().mean()),
                    long_segment_row_share=float((~short).float().mean()),
                    tied_value_share=float(tied.float().mean()))
        del got, ref, err, rows, short, tie, tied
        case["ms"] = _cuda_ms(lambda: sm.seg_full_max_bounded_bwd(
            first, last, x, m, g, bound), iters=20)
        case["plain_ms"] = _cuda_ms(
            lambda: sm.seg_full_max_bounded_bwd_plain(first, last, x, m, g,
                                                      bound),
            iters=3, warmup=1)
        # x, m and g read once, dx written once, the two flag planes read
        # once; an add and a compare per value
        case["bound_ms"], case["bound_by"] = _bound(
            4 * x.numel() * x.element_size() + 2 * b * n, 2 * x.numel())
        cases.append(case)
        print(f"  seg_full_max_bwd x{case['shape']} {name:8s} {kind:15s} "
              f"max_abs={case['max_abs_err']:.3e} rows in segments > 2: "
              f"{case['long_segment_row_share']:.3f} tied values: "
              f"{case['tied_value_share']:.3f} kernel="
              f"{case['ms'] * 1e3:8.1f}us plain={case['plain_ms'] * 1e3:9.1f}"
              f"us bound={case['bound_ms'] * 1e3:6.1f}us "
              f"({case['bound_by']})", flush=True)
        if not ok:
            raise AssertionError(f"seg_full_max_bwd disagrees with its plain "
                                 f"version: {case}")
    return cases


# K3dx and K3dcw vs plain: err <= atol + rtol * (the same sum over absolute
# values). dx sums up to ~25 weighted g rows per map row with f32 atomics,
# in an order that changes from run to run; in bf16 the f32 sum is rounded
# once (2**-9 relative), with room for the order flipping that rounding.
# dcw sums 384 f32 products per corner in another order than the plain
# version's.
GATHER_BWD_TOL = {"dx_float32": (1e-6, 1e-5), "dx_bfloat16": (1e-6, 2 ** -8),
                  "dcw": (1e-6, 1e-5)}


def _second_stage_inputs(model, b, gen, dev, slots=CP_PROPOSALS):
    """A random BEV map (B, C, H, W) of ``model`` in channels_last memory
    and the map coordinates (fy, fx) (B, 5 * slots) of ``proposal_boxes``'
    sample points."""
    from minddet_tpu_torch.models.heads.second_stage import bev_sample_points

    h = model.grid_ny // model.out_size_factor
    w = model.grid_nx // model.out_size_factor
    c = model.rpn.out_channels
    bev = torch.randn(b, c, h, w, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)
    boxes = proposal_boxes(b, slots, model.pc_range, gen).to(dev)
    pts = bev_sample_points(boxes).reshape(b, slots * 5, 2)
    fx = (pts[..., 0] - model.pc_range[0]) / (
        model.voxel_size[0] * model.out_size_factor)
    fy = (pts[..., 1] - model.pc_range[1]) / (
        model.voxel_size[1] * model.out_size_factor)
    return bev, fy, fx


DUPLICATE_SPOTS = 4  # map positions of the heavy-duplicate stream


def _duplicate_points(fy, fx):
    """Every sample point on one of DUPLICATE_SPOTS positions two cells
    apart along one map row, off-grid: all 4 * P corners of an image land
    in two map rows, 2 * P of them in one bucket of K3dx's row tiles."""
    spot = torch.arange(fy.shape[1], device=fy.device) % DUPLICATE_SPOTS
    ys = torch.full_like(fy, 40.37)
    xs = 70.61 + 2.0 * spot.to(fx.dtype).expand_as(fx)
    return ys, xs.contiguous()


def check_bilinear_bwd_kernels(dev, gen, model):
    """Phase 3: bilinear_gather_bwd_dx (K3dx) and bilinear_gather_bwd_dcw
    (K3dcw) against their plain versions at the train step's shapes:
    ``model``'s BEV map (B, 128 * 128, 384) and 5 sample points for each of
    its 128 proposals (640 points, some off the map); with the time of
    ``index_add_`` into a zeroed f32 map beside K3dx."""
    from minddet_tpu_torch.ops import bilinear as bl

    dx_cases, dcw_cases = [], []
    for b, stream in ((1, "uniform"), (TRAIN_CP_BATCH, "uniform"),
                      (TRAIN_CP_BATCH, "duplicate")):
        bev32, fy, fx = _second_stage_inputs(model, b, gen, dev)
        _, c, h, w = bev32.shape
        hw = h * w
        if stream == "duplicate":
            fy, fx = _duplicate_points(fy, fx)
        ci, cw = bl.bilinear_corners(fy, fx, h, w)
        p = ci.shape[1]
        g32 = torch.randn(b, p, c, generator=gen).to(dev)
        touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                      for i in range(b))
        rows = (bl._clipped_rows(ci, hw) + torch.arange(
            b, device=dev)[:, None] * hw).reshape(-1)
        plan = bl.gather_bwd_dx_plan(b, hw, c, p)
        # hw is a whole number of row tiles here
        tile_of = rows[(ci >= 0).reshape(-1)] // plan["tile_rows"]
        common = dict(shape=[b, hw, c], points=p, stream=stream,
                      touched_rows=touched,
                      off_map_corner_share=float((ci < 0).float().mean()))
        dx_plan = dict(largest_bucket=int(torch.bincount(tile_of).max()),
                       sort_cap=plan["cap"], smem_bytes=plan["smem_bytes"])
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x = bev32.to(dtype).permute(0, 2, 3, 1).view(b, hw, c)
            g = g32.to(dtype)
            elt = x.element_size()

            got = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
            again = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
            torch.cuda.synchronize()
            repeat = torch.equal(got, again)
            del again
            ref = bl.bilinear_gather_bwd_dx_plain(g.float(), ci, cw, hw)
            size = bl.bilinear_gather_bwd_dx_plain(g.float().abs(), ci,
                                                   cw.abs(), hw)
            err = (got.float() - ref).abs()
            atol, rtol = GATHER_BWD_TOL[f"dx_{name}"]
            ok = got.dtype == dtype and repeat and bool(
                (err <= atol + rtol * size).all())
            case = dict(common, **dx_plan, dtype=name,
                        max_abs_err=float(err.max()),
                        max_abs=float(ref.abs().max()), repeat=repeat,
                        tolerance=f"abs <= {atol} + {rtol} * sum |cw g|; "
                                  f"bit-equal between two calls")
            del got, ref, size, err
            case["ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dx(g, x, ci, cw), iters=20)
            case["plain_ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dx_plain(g, ci, cw, hw),
                iters=5, warmup=1)
            contrib = ((cw * (ci >= 0))[..., None]
                       * g.float()[:, :, None, :]).reshape(-1, c)
            case["library_ms"] = _cuda_ms(
                lambda: torch.zeros(b * hw, c, device=dev).index_add_(
                    0, rows, contrib), iters=20)
            del contrib
            # dx (the whole map, in x's type) written once, g read once, ci
            # and cw read once; 4 multiply-adds per g value
            case["bound_ms"], case["bound_by"] = _bound(
                b * hw * c * elt + b * p * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            dx_cases.append(case)
            print(f"  bilinear_gather_bwd_dx x{case['shape']} P={p} {stream}"
                  f" {name:8s} max_abs={case['max_abs_err']:.3e} repeat="
                  f"{repeat} bucket<={case['largest_bucket']} (|dx| max "
                  f"{case['max_abs']:.1f}) kernel={case['ms'] * 1e3:7.1f}us "
                  f"plain={case['plain_ms'] * 1e3:8.1f}us index_add_="
                  f"{case['library_ms'] * 1e3:7.1f}us bound="
                  f"{case['bound_ms'] * 1e3:5.1f}us ({case['bound_by']})",
                  flush=True)
            if not ok:
                raise AssertionError(f"bilinear_gather_bwd_dx disagrees with "
                                     f"its plain version: {case}")

            got = bl.bilinear_gather_bwd_dcw(g, x, ci, cw)
            torch.cuda.synchronize()
            ref = bl.bilinear_gather_bwd_dcw_plain(g.float(), x.float(), ci)
            size = bl.bilinear_gather_bwd_dcw_plain(g.float().abs(),
                                                    x.float().abs(), ci)
            err = (got - ref).abs()
            atol, rtol = GATHER_BWD_TOL["dcw"]
            ok = (bool((err <= atol + rtol * size).all())
                  and bool((got[ci < 0] == 0).all()))
            case = dict(common, dtype=name, max_abs_err=float(err.max()),
                        max_abs=float(ref.abs().max()),
                        tolerance=f"abs <= {atol} + {rtol} * sum |g x|")
            del got, ref, size, err
            case["ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dcw(g, x, ci, cw), iters=50)
            case["plain_ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dcw_plain(g, x, ci), iters=5,
                warmup=1)
            # g read once, the rows of x the corners touch read once, ci
            # read and dcw written once; 4 multiply-adds per g value
            case["bound_ms"], case["bound_by"] = _bound(
                b * p * c * elt + touched * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            dcw_cases.append(case)
            print(f"  bilinear_gather_bwd_dcw x{case['shape']} P={p} "
                  f"{stream} {name:8s} max_abs={case['max_abs_err']:.3e} (|dcw| max "
                  f"{case['max_abs']:.1f}) kernel={case['ms'] * 1e3:7.1f}us "
                  f"plain={case['plain_ms'] * 1e3:8.1f}us bound="
                  f"{case['bound_ms'] * 1e3:5.1f}us ({case['bound_by']})",
                  flush=True)
            if not ok:
                raise AssertionError(f"bilinear_gather_bwd_dcw disagrees "
                                     f"with its plain version: {case}")
    return dx_cases, dcw_cases


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


def _stage_outputs(model):
    """Forward hooks keeping the backbone's four outputs and the neck's in
    ``model.kept`` (a dict); returns the handles."""
    model.kept = {}

    def keep_backbone(module, args, out):
        for i, o in enumerate(out):
            model.kept[f"C{i + 2}"] = o.detach().float().cpu()

    def keep_neck(module, args, out):
        model.kept["neck"] = out.detach().float().cpu()

    return [model.backbone.register_forward_hook(keep_backbone),
            model.neck.register_forward_hook(keep_neck)]


STAGE_RTOL = 1e-3  # phase 4's intermediate outputs, see check_end_to_end_f32


def check_end_to_end_f32(dev, gen, dcn4: bool = False):
    """Phase 4 (4d with ``dcn4``: DCN in all four backbone stages): f32
    predict on the card vs the same model on the CPU, stage by stage (the
    backbone's four outputs, the neck's, the heads) and the detections."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import RES, build_model

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = randomize_for_check(
        build_model("cpu", dtype=torch.float32, dcn4=dcn4), gen)
    gpu = build_model(dev, dtype=torch.float32, dcn4=dcn4)
    gpu.load_state_dict(cpu.state_dict())
    image = torch.randn(1, RES, RES, 3, generator=gen)

    hooks = _stage_outputs(gpu) + _stage_outputs(cpu)
    kernels.reset_launches()
    with torch.inference_mode():
        heads_gpu = gpu(image.to(dev))
        stages_gpu = dict(gpu.kept)
        det_gpu = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = _sampler_launches(2, dcn4, train=False)
    if launches != want:
        raise AssertionError(f"f32 forward launched {launches} for 2 "
                             f"forwards (want {want})")
    with torch.inference_mode():
        heads_cpu = cpu(image)
        stages_cpu = dict(cpu.kept)
        det_cpu = cpu.predict(image)
    for hook in hooks:
        hook.remove()

    result = {}
    # the backbone's and the neck's outputs (BN and ReLU over O(1) values
    # up to ~10) within STAGE_RTOL of each tensor's largest value; the heads
    # element by element
    for name, ref in list(stages_cpu.items()) + list(heads_cpu.items()):
        stage = name in stages_gpu
        got = stages_gpu[name] if stage else heads_gpu[name].cpu()
        err = float((got - ref).abs().max())
        result[f"{name}_max_abs_err"] = err
        result[f"{name}_max_abs"] = float(ref.abs().max())
        if stage and err > STAGE_RTOL * result[f"{name}_max_abs"]:
            raise AssertionError(f"f32 {name}: card vs CPU max abs err "
                                 f"{err}, over {STAGE_RTOL} of the largest "
                                 f"value {result[f'{name}_max_abs']}")
        if not stage and not torch.allclose(got, ref, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"f32 {name}: card vs CPU max abs err "
                                 f"{err} (atol 1e-4, rtol 1e-3)")
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
    result["launches"] = launches
    print("  f32 card vs CPU: " + " ".join(
        f"{k}={v:.3e}" for k, v in result.items() if isinstance(v, float)),
        flush=True)
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


# f32 two-stage CenterPoint predict, card vs CPU (phase 4c). The tolerances
# are phase 4b's; the PFN rows are two f32 matmuls and max/select
CP_PFN_TOL = (1e-5, 1e-5)
CP_SCORE_TOL = 2.5e-5  # sigmoid's slope (<= 1/4) times the heads' atol
CP_MATCHED_SHARE = 0.95  # of the CPU's detections found on the card
CP_REFINED_TOL = (2e-3, 1e-5)  # the refined box is exp(delta) x the size
CP_NMS_IOU = 0.2
CP_SCORE_THRESHOLD = 0.1
# std of each task's final maps after calibrate_centerpoint, per channel,
# and where their means go
CP_MAP_STD = {"hm": 2.0, "reg": 0.3, "height": 0.3, "dim": 0.15, "rot": 1.0,
              "vel": 0.5}
CP_DIM_MEAN = (math.log(1.9), math.log(4.5), math.log(1.7))  # a car, w l h
CP_REFINE_STD = {"score": 1.0, "box": 0.05}


@torch.no_grad()
def calibrate_centerpoint(model, points, mask):
    """Give the seeded two-stage CenterPoint heads that make a request do
    real work, on this cloud. With flax's default initialisers and identity
    BN every heatmap logit sits at the bias, -2.19: every score ~0.10, on
    the 0.1 threshold, where rounding would decide which candidates are
    valid. Each task's final convs are scaled and shifted per channel so
    that the heatmap logits have std 2 around -2.19 (the top 1000 peaks of
    each task all pass the threshold and the NMS has 1000 boxes to sort
    out), the sizes are a car's (exp(dim), std 0.15 in the log), and the
    other maps have the stds of ``CP_MAP_STD`` around 0; then the refine
    head's two outputs are scaled to ``CP_REFINE_STD`` over the kept
    detections, so that the second stage moves scores and boxes."""
    bev = model.bev_from_points_stream(points, mask)
    for t, pred in enumerate(model.head(bev)):
        task = getattr(model.head, f"task{t}")
        for name, std in CP_MAP_STD.items():
            out = getattr(task, f"{name}_out")
            v = pred[name].float()
            gain = std / v.std(dim=(0, 1, 2))
            centre = {"hm": task.init_bias,
                      "dim": torch.tensor(CP_DIM_MEAN, device=v.device)
                      }.get(name, 0.0)
            out.bias.copy_((out.bias - v.mean(dim=(0, 1, 2))) * gain + centre)
            out.weight.mul_(gain[:, None, None, None])
    det = model.head.predict(model.head(bev), model.pc_range,
                             model.voxel_size, model.out_size_factor)
    kept = det["labels"] >= 0
    slog, deltas = model.refine(model.extractor(bev, det["boxes"]))
    model.refine.score.weight.mul_(CP_REFINE_STD["score"] / slog[kept].std())
    model.refine.box.weight.mul_(CP_REFINE_STD["box"] / deltas[kept].std())
    return model


def _centerpoint_stages(model, points, mask):
    """``predict_refined`` stage by stage, through the model's own methods:
    the stream and the PFN's rows, the BEV map, the heads, per task the
    NMS's candidates and the flat (class-major) heatmap cells they came
    from, the stage-1 detections and the refined ones."""
    from minddet_tpu_torch.ops.decode import simple_topk
    from minddet_tpu_torch.ops.voxelize import scatter_stream_canvas

    sv, h = model.pillars_from_points(points, mask)
    canvas, _ = scatter_stream_canvas(h, sv, model.grid_ny, model.grid_nx)
    bev = model.rpn(canvas).contiguous(memory_format=torch.channels_last)
    preds = model.head(bev)
    geometry = (model.pc_range, model.voxel_size, model.out_size_factor)
    cands = model.head.candidates(preds, *geometry)
    cells = []
    for pred in preds:
        hm = torch.sigmoid(pred["hm"].float())
        _, pos, cls, _, _ = simple_topk(hm, CP_CANDIDATES)
        cells.append(cls.long() * (hm.shape[1] * hm.shape[2]) + pos)
    det = model.head.predict(preds, *geometry)
    return dict(sv=sv, h=h, bev=bev, preds=preds, cands=cands, cells=cells,
                det=det, refined=model.refine_detections(bev, det))


def _wrap(angle):
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def _cp_candidate_checks(task, cand_g, cand_c, cells_g, cells_c, hm_c):
    """One task's candidates (sample 0) of the card vs the CPU: sorted
    scores; cells on one side only must tie with the CPU's last score;
    boxes of the common cells. Returns (result, problems)."""
    bad = []
    sg, sc = cand_g["scores"][0].cpu(), cand_c["scores"][0]
    ig, ic = cells_g[0].cpu(), cells_c[0]
    r = dict(score_err=float((sg - sc).abs().max()),
             reordered=int((ig != ic).sum()))
    if r["score_err"] > CP_SCORE_TOL:
        bad.append(f"task {task}: candidate scores")
    one_side = sorted(set(ig.tolist()) ^ set(ic.tolist()))
    r["on_one_side"] = len(one_side)
    flat = torch.sigmoid(hm_c[0].float()).permute(2, 0, 1).reshape(-1)
    if any(abs(float(flat[a]) - float(sc[-1])) > CP_SCORE_TOL
           for a in one_side):
        bad.append(f"task {task}: a candidate on one side only that is no "
                   "boundary tie")
    pos_g = {a: p for p, a in enumerate(ig.tolist())}
    pc = [p for p, a in enumerate(ic.tolist()) if a in pos_g]
    pg = [pos_g[int(ic[p])] for p in pc]
    bg, bc = cand_g["boxes"][0].cpu()[pg], cand_c["boxes"][0][pc]
    atol, rtol = PP_BOX_TOL
    err = (bg[:, :8] - bc[:, :8]).abs()
    yaw_err = _wrap(bg[:, 8] - bc[:, 8]).abs()
    r["box_err"] = float(torch.cat([err.flatten(), yaw_err]).max())
    if not (bool((err <= atol + rtol * bc[:, :8].abs()).all())
            and bool((yaw_err <= atol).all())):
        bad.append(f"task {task}: decoded boxes")
    return r, bad


def _detections_agree(got, ref, box_tol, score_atol) -> bool:
    """Detections slot by slot: labels equal, scores and boxes (yaw modulo a
    turn) within tolerance."""
    bg, bc = got["boxes"].cpu(), ref["boxes"]
    atol, rtol = box_tol
    err = (bg[..., :8] - bc[..., :8]).abs()
    return (torch.equal(got["labels"].cpu(), ref["labels"])
            and torch.allclose(got["scores"].cpu(), ref["scores"], rtol=0,
                               atol=score_atol)
            and bool((err <= atol + rtol * bc[..., :8].abs()).all())
            and bool((_wrap(bg[..., 8] - bc[..., 8]).abs() <= atol).all()))


def _matched_share(got, ref, box_tol, score_atol) -> float:
    """The share of ``ref``'s kept detections that ``got`` holds too, in
    whatever slot of the same task: same label, centre, size and velocity
    within ``box_tol``, score within ``score_atol``."""
    atol, rtol = box_tol
    matched = total = 0
    for i in range(ref["labels"].shape[0]):
        for t in range(CP_TASKS):
            sl = slice(t * CP_NMS_POST, (t + 1) * CP_NMS_POST)
            lc, lg = ref["labels"][i, sl], got["labels"][i, sl].cpu()
            bc, bg = ref["boxes"][i, sl], got["boxes"][i, sl].cpu()
            sc, sg = ref["scores"][i, sl], got["scores"][i, sl].cpu()
            err = (bg[None, :, :8] - bc[:, None, :8]).abs()
            same = ((err <= atol + rtol * bc[:, None, :8].abs()).all(-1)
                    & (lg[None] == lc[:, None])
                    & ((sg[None] - sc[:, None]).abs() <= score_atol))
            matched += int((same.any(1) & (lc >= 0)).sum())
            total += int((lc >= 0).sum())
    return matched / max(total, 1)


def check_centerpoint_f32(dev, gpu):
    """Phase 4c: f32 two-stage CenterPoint ``predict_refined`` at batch 1 on
    the card against the same model on the CPU (TF32 off), stage by stage:
    the stream's flags and the PFN's rows at each pillar's last kept row
    (K5f on the card), the BEV map, every task's maps, per task the top-1000
    candidates and their boxes, the IoU matrix of the stacked tasks (K4 on
    the CPU's candidates, and the card's own), the kept lists of the card's
    NMS on the CPU's candidates, the card's second stage (K3f) on the CPU's
    detections, and the card's own kept lists and refined detections, slot
    by slot where its candidates came out in the CPU's order and always as
    sets (``CP_MATCHED_SHARE``); kept lists are compared where no pair's IoU
    lies within PP_NEAR of the threshold or no pair's IoUs lie on two sides
    of it. ``gpu`` is the model on the card; it is
    calibrated here."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import build_centerpoint
    from minddet_tpu_torch.ops import rotated_iou as ri
    from minddet_tpu_torch.ops.nms import rotated_nms

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    points, pmask = _nusc_clouds(gpu, 1, 1, "cpu")
    calibrate_centerpoint(gpu, points.to(dev), pmask.to(dev))
    cpu = build_centerpoint("cpu")
    cpu.load_state_dict(gpu.state_dict())
    kernels.reset_launches()
    with torch.inference_mode():
        g = _centerpoint_stages(gpu, points.to(dev), pmask.to(dev))
        served = gpu.predict_refined(points.to(dev), pmask.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != _centerpoint_launches(2):
        raise AssertionError(f"two f32 CenterPoint predicts launched "
                             f"{launches} (want two each of seg_full_max, "
                             f"rotated_iou_intersect, bilinear_gather_fwd)")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = _centerpoint_stages(cpu, points, pmask)
    cpu_s = time.perf_counter() - t0

    result, bad = dict(cpu_predict_s=cpu_s), []
    if not _detections_agree(served, {k: v.cpu() if torch.is_tensor(v) else v
                                      for k, v in g["refined"].items()},
                             (1e-5, 0.0), 1e-6):
        bad.append("predict_refined against its own stages on the card")
    last = c["sv"].last
    result["pillars"] = int(last.sum())
    result["kept_point_share"] = float(c["sv"].keep.float().mean())
    if not (torch.equal(g["sv"].last.cpu(), last)
            and torch.equal(g["sv"].keep.cpu(), c["sv"].keep)
            and torch.equal(g["sv"].first.cpu(), c["sv"].first)):
        bad.append("stream flags")
    rows_g, rows_c = g["h"].cpu()[last], c["h"][last]
    result["pfn_max_abs_err"] = float((rows_g - rows_c).abs().max())
    result["pfn_max_abs"] = float(rows_c.abs().max())
    if not torch.allclose(rows_g, rows_c, atol=CP_PFN_TOL[0],
                          rtol=CP_PFN_TOL[1]):
        bad.append("PFN rows at the last kept rows")
    atol, rtol = PP_HEAD_TOL
    bev_g = g["bev"].cpu()
    result["bev_max_abs_err"] = float((bev_g - c["bev"]).abs().max())
    result["bev_std"] = float(c["bev"].std())
    if not torch.allclose(bev_g, c["bev"], rtol=rtol, atol=atol):
        bad.append("BEV map")
    for name in CP_MAP_STD:
        errs = []
        for t, ref in enumerate(c["preds"]):
            got = g["preds"][t][name].cpu()
            errs.append(float((got - ref[name]).abs().max()))
            if not torch.allclose(got, ref[name], rtol=rtol, atol=atol):
                bad.append(f"task {t} map {name}")
        result[f"{name}_max_abs_err"] = max(errs)
    result["hm_std"] = float(c["preds"][0]["hm"].std())

    cand = dict(score_err=0.0, reordered=0, on_one_side=0, box_err=0.0)
    for t in range(len(c["cands"])):
        r, problems = _cp_candidate_checks(
            t, g["cands"][t], c["cands"][t], g["cells"][t], c["cells"][t],
            c["preds"][t]["hm"])
        bad += problems
        cand = {k: (max if isinstance(v, float) else sum)((v, r[k]))
                for k, v in cand.items()}
    result.update({f"candidates_{k}": v for k, v in cand.items()})

    def stacked(cands):
        return (torch.cat([x["boxes"][..., [0, 1, 3, 4, 8]] for x in cands])
                .contiguous(), torch.cat([x["scores"] for x in cands]))

    bev5_c, sc = stacked(c["cands"])
    bev5_g, _ = stacked(g["cands"])
    iou_c = ri.rotated_iou_bev(bev5_c, bev5_c)
    iou_k = ri.rotated_iou_bev(bev5_c.to(dev), bev5_c.to(dev)).cpu()
    iou_g = ri.rotated_iou_bev(bev5_g, bev5_g).cpu()
    result["iou_kernel_max_abs_err"] = float((iou_k - iou_c).abs().max())
    if result["iou_kernel_max_abs_err"] > PP_IOU_TOL:
        bad.append("IoU matrix of K4 on the CPU's candidates")
    valid = sc > CP_SCORE_THRESHOLD
    pair = torch.triu(valid[:, :, None] & valid[:, None, :], 1)
    near = int((pair & ((iou_c - CP_NMS_IOU).abs() < PP_NEAR)).sum())

    def same_side(a, b):
        return bool((((a > CP_NMS_IOU) == (b > CP_NMS_IOU)) | ~pair).all())

    kept_c = c["det"]["labels"] >= 0
    result.update(
        near_threshold_pairs=near, valid_candidates=int(valid.sum()),
        overlapping_pairs=int((pair & (iou_c > CP_NMS_IOU)).sum()),
        kept_cpu=int(kept_c.sum()), nms_passes_card=g["det"]["nms_passes"],
        nms_passes_cpu=c["det"]["nms_passes"])
    # Same inputs first, whatever order the card's own candidates took: the
    # card's NMS on the CPU's candidates (only K4's rounding differs), and
    # the card's second stage on its own BEV map at the CPU's detections
    # (K3f and the MLP).
    idx_k, _, _ = rotated_nms(bev5_c.to(dev), sc.to(dev), CP_NMS_IOU,
                              CP_SCORE_THRESHOLD, CP_NMS_POST)
    idx_c, _, _ = rotated_nms(bev5_c, sc, CP_NMS_IOU, CP_SCORE_THRESHOLD,
                              CP_NMS_POST)
    compared = near == 0 or same_side(iou_k, iou_c)
    result["kept_same_inputs_compared"] = compared
    if compared and not torch.equal(idx_k.cpu(), idx_c):
        bad.append("kept lists of the card's NMS on the CPU's candidates")
    ref = c["refined"]
    with torch.inference_mode():
        det_on_card = {k: v.to(dev) if torch.is_tensor(v) else v
                       for k, v in c["det"].items()}
        got = gpu.refine_detections(g["bev"], det_on_card)
    result["refined_score_max_abs_err"] = float(
        (got["scores"].cpu() - ref["scores"]).abs().max())
    result["refined_box_max_abs_err"] = float(
        (got["boxes"].cpu()[..., :8] - ref["boxes"][..., :8]).abs().max())
    result["rescored_by"] = float(
        (ref["scores"] - c["det"]["scores"]).abs()[kept_c].max())
    result["refined_by_m"] = float(
        (ref["boxes"] - c["det"]["boxes"]).abs()[kept_c].max())
    if not _detections_agree(got, ref, CP_REFINED_TOL, 1e-4):
        bad.append("the card's second stage on the CPU's detections")
    # then the card's own request, where its candidates came out in the
    # CPU's order and every IoU on the CPU's side of the threshold
    same = not (cand["reordered"] or cand["on_one_side"])
    if same:
        result["iou_e2e_max_abs_err"] = float((iou_g - iou_c).abs().max())
        if result["iou_e2e_max_abs_err"] > PP_IOU_E2E_TOL:
            bad.append("IoU matrix of the card's candidates")
    same = same and (near == 0 or same_side(iou_g, iou_c))
    result["kept_end_to_end_compared"] = same
    if same and not (
            _detections_agree(g["det"], c["det"], PP_BOX_TOL, CP_SCORE_TOL)
            and _detections_agree(g["refined"], ref, CP_REFINED_TOL, 1e-4)):
        bad.append("kept lists and refined detections end to end")
    # and in any case as sets: candidates that traded places move a kept
    # detection to a neighbouring slot, and change the kept set only where
    # the two overlap or straddle the 83rd place
    result["stage1_matched_share"] = _matched_share(
        g["det"], c["det"], PP_BOX_TOL, CP_SCORE_TOL)
    result["refined_matched_share"] = _matched_share(
        g["refined"], ref, CP_REFINED_TOL, 1e-4)
    if min(result["stage1_matched_share"],
           result["refined_matched_share"]) < CP_MATCHED_SHARE:
        bad.append("the card's own detections against the CPU's, as sets")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    print("  f32 CenterPoint card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 CenterPoint predict, card vs CPU: {bad}: "
                             f"{result}")
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


CP_SERVE_KERNELS = ("seg_full_max", "rotated_iou_intersect",
                    "bilinear_gather_fwd")
CP_TRAIN_KERNELS = CP_SERVE_KERNELS + ("seg_full_max_bwd",
                                       "bilinear_gather_bwd_dx")


def _centerpoint_launches(n: int, launched=CP_SERVE_KERNELS):
    """Launch counts of n two-stage CenterPoint requests (n each of the
    segment max, the rotated-box intersection and the row gather) or, with
    ``CP_TRAIN_KERNELS``, train steps (also n of the segment max's backward
    and of the row gather's backward to the map); no other kernel."""
    from minddet_tpu_torch import kernels

    return {k.name: n if k.name in launched else 0 for k in kernels.KERNELS}


def _sampler_launches(n: int, dcn4: bool = False, train: bool = True):
    """Launch counts of n forwards (with ``train``, n train steps) of a
    CenterNet path: 9 of the taps sampler's kernels each and, with
    ``dcn4`` (DCN in all four backbone stages), 2 of the flat sampler's;
    no other kernel."""
    from minddet_tpu_torch import kernels

    per = {"hat_sample_taps_fwd": DCN_LAYERS, "hat_sample_taps_bwd":
           DCN_LAYERS * train}
    if dcn4:
        per.update(hat_sample_flat_fwd=FLAT_LAYERS,
                   hat_sample_flat_bwd=FLAT_LAYERS * train)
    return {k.name: n * per.get(k.name, 0) for k in kernels.KERNELS}


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


# The same steps held to a referee, as phase 5c does for CenterPoint: the
# step once more on the CPU in f64 compute (f64 parameters, the f32 values
# widened), from the same weights and batch. Parts are compared as one
# vector each (the neck's transposed-conv biases left out); the bounds are
# kink-sized, as CP_TRAIN_TOL's referee_* ones.
REFEREE_TOL = dict(loss_rtol=1e-4, grad_norm_rtol=1e-3, grad_rel_l2=3e-2,
                   stat_atol=1e-4, stat_rtol=1e-4,
                   param_atol=2 * 5e-4 * 1.01, param_moved_share=1e-2,
                   param_moved_atol=1e-6)
CENTERNET_PARTS = {
    "stage1": ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_"),
    "stages2_4": ("backbone.layer2_", "backbone.layer3_", "backbone.layer4_"),
    "neck": ("neck.",), "head": ("head.",)}
CHECK_RES_DCN4 = 512  # phase 5d's image side


def _centernet_part_rel_l2(grads, ref, prefixes) -> float:
    names = [n for n in ref if n.startswith(prefixes)
             and not (n.startswith("neck.") and n.endswith("up.bias"))]
    return _rel_l2(torch.cat([grads[n].double().reshape(-1) for n in names]),
                   torch.cat([ref[n].double().reshape(-1) for n in names]))


def _state_checks(g, r, t, label, bad, result):
    """Post-step parameters and BN statistics of snapshot ``g`` against
    ``r``: at most ``param_moved_share`` of the elements more than
    ``param_moved_atol`` apart and none more than ``param_atol``; every
    statistic within ``stat_atol + stat_rtol * |r|``."""
    diffs = {n: (g["params"][n] - v).abs() for n, v in r["params"].items()}
    result[f"{label}param_max_abs_err"] = max(
        float(d.max()) for d in diffs.values())
    moved = sum(int((d > t["param_moved_atol"]).sum())
                for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    result[f"{label}param_moved_share"] = moved / total
    if (result[f"{label}param_max_abs_err"] > t["param_atol"]
            or moved / total > t["param_moved_share"]):
        bad.append(f"{label}post-step params")
    stat_err = 0.0
    for n, v in r["stats"].items():
        e = (g["stats"][n] - v).abs()
        stat_err = max(stat_err, float(e.max()))
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"{label}BN statistic {n}")
    result[f"{label}stat_max_abs_err"] = stat_err


def check_train_step_f32(dev, gen, dcn4: bool = False, res: int = 512):
    """Phase 5 (5d with ``dcn4``: DCN in all four backbone stages): one f32
    train step on the card against the same step on the CPU (the plain
    path), at res x res and batch CHECK_BATCH, from the same weights
    (``randomize_for_check``) and batch, with the same step in f64 compute
    on the CPU as referee. Phase 5 holds the card to the f32 CPU
    (TRAIN_TOL) and to the referee (REFEREE_TOL); 5d to the referee, and
    reports the f32 CPU. Both report each f32 run's distance from the
    referee part by part (stem and stage 1, stages 2-4, neck, head)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import (NUM_CLASSES, centernet_loss,
                                         build_model, synthetic_boxes)
    from minddet_tpu_torch.ops.targets import centernet_targets_batch
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = randomize_for_check(
        build_model("cpu", dtype=torch.float32, dcn4=dcn4), gen)
    models = {"gpu": build_model(dev, dtype=torch.float32, dcn4=dcn4),
              "cpu": cpu,
              "referee": build_model("cpu", dtype=torch.float64, dcn4=dcn4),
              "probe": build_model(dev, dtype=torch.float32, dcn4=dcn4)}
    for name in ("gpu", "referee", "probe"):
        models[name].load_state_dict(cpu.state_dict())
    boxes = synthetic_boxes(CHECK_BATCH, res=res)
    image = torch.randn(CHECK_BATCH, res, res, 3, generator=gen)
    step = make_train_step(centernet_loss)
    snaps, seconds = {}, {}
    # "probe" is the card's step on the image scaled by 1 + 1e-6: how far
    # f32 rounding-sized changes of the input move the gradients here
    for name in ("gpu", "cpu", "referee", "probe"):
        model = models[name]
        img = image * (1 + 1e-6) if name == "probe" else image
        d = next(model.parameters()).device
        b = {k: torch.from_numpy(v).to(d) for k, v in boxes.items()}
        targets = centernet_targets_batch(b["boxes"], b["classes"],
                                          b["mask"], res // 4, res // 4,
                                          NUM_CLASSES, 0.7)
        state = TrainState.create(model, adamw(5e-4, clip_global_norm=35.0))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": img.to(d),
                                      "targets": targets})
        snaps[name] = _train_snapshot(state, metrics)
        seconds[name] = time.perf_counter() - t0
        print(f"  {name} step {seconds[name]:.1f} s, loss "
              f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
        if d.type == "cuda":
            launches = {k.name: k.launches for k in kernels.KERNELS}
            if launches != _sampler_launches(1, dcn4):
                raise AssertionError(f"f32 train step launched {launches} "
                                     f"(want {_sampler_launches(1, dcn4)})")
        del state
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32

    g, c, r = snaps["gpu"], snaps["cpu"], snaps["referee"]
    result = {"res": res, "seconds": seconds, "tolerance": TRAIN_TOL,
              "referee_tolerance": REFEREE_TOL}
    bad = []
    rt = REFEREE_TOL
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{k}_{name}_vs_referee"] = abs(
                snap["metrics"][k] - r["metrics"][k]) / abs(r["metrics"][k])
        if result[f"{k}_card_vs_referee"] > rt["loss_rtol"]:
            bad.append(f"{k} against the referee")
    for name, snap in (("card", g), ("cpu", c)):
        result[f"grad_norm_{name}_vs_referee"] = abs(
            snap["metrics"]["grad_norm"] - r["metrics"]["grad_norm"]) / \
            r["metrics"]["grad_norm"]
    if result["grad_norm_card_vs_referee"] > rt["grad_norm_rtol"]:
        bad.append("grad_norm against the referee")
    for part, prefixes in CENTERNET_PARTS.items():
        for name, snap in (("card", g), ("cpu", c), ("probe",
                                                     snaps["probe"])):
            result[f"grad_{part}_{name}_vs_referee"] = \
                _centernet_part_rel_l2(snap["grads"], r["grads"], prefixes)
        if result[f"grad_{part}_card_vs_referee"] > rt["grad_rel_l2"]:
            bad.append(f"gradient of {part} against the referee")
    _state_checks(g, r, rt, "referee_", bad, result)

    t = TRAIN_TOL
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        err = abs(g["metrics"][k] - c["metrics"][k]) / abs(c["metrics"][k])
        result[f"{k}_rel_err"] = err
        if err > t["loss_rtol"] and not dcn4:
            bad.append(k)
    err = abs(g["metrics"]["grad_norm"] - c["metrics"]["grad_norm"]) / \
        c["metrics"]["grad_norm"]
    result["grad_norm"] = c["metrics"]["grad_norm"]
    result["grad_norm_rel_err"] = err
    if err > t["grad_norm_rtol"] and not dcn4:
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
    if rel[worst] > t["grad_rel_l2"] and not dcn4:
        bad.append(f"gradient of {worst}")
    _state_checks(g, c, t, "", bad if not dcn4 else [], result)
    print("  f32 train step card vs CPU and vs the f64 referee: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if "tolerance" not in k), flush=True)
    if bad:
        raise AssertionError(f"f32 train step: {bad} outside {t} / {rt}: "
                             f"{result}")
    return result


# bilinear_sample_2d's gradients, card vs CPU (phase 5b): out and dx as in
# phase 3; dys and dxs are sums of four dcw (each a 384-term f32 dot product
# of values ~N(0, 1), summed in another order) times weight derivatives <= 1
SAMPLE_GRAD_TOL = dict(out=(1e-5, 1e-5), dx=(1e-5, 1e-5), dys=(1e-3, 1e-4),
                       dxs=(1e-3, 1e-4))


def check_sample_grads_f32(dev, gen, model):
    """Phase 5b: ``bilinear_sample_2d`` differentiated with respect to the
    map, ``ys`` and ``xs`` on the card (K3f forward, K3dx and K3dcw backward,
    one launch each, counted from 0) against the CPU (the plain versions),
    f32, at the second stage's shape: ``model``'s BEV map at batch 2 and 640
    sample points per map, some off it."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.ops.bilinear import bilinear_sample_2d

    bev, fy, fx = _second_stage_inputs(model, 2, gen, "cpu")
    g = torch.randn(2, fy.shape[1], bev.shape[1], generator=gen)
    out = {}
    kernels.reset_launches()
    for name, d in (("gpu", dev), ("cpu", "cpu")):
        x = bev.to(d).permute(0, 2, 3, 1).requires_grad_()
        ys, xs = fy.to(d).requires_grad_(), fx.to(d).requires_grad_()
        y = bilinear_sample_2d(x, ys, xs)
        y.backward(g.to(d))
        out[name] = dict(out=y.detach().cpu(), dx=x.grad.cpu(),
                         dys=ys.grad.cpu(), dxs=xs.grad.cpu())
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = {k.name: int(k.name.startswith("bilinear_gather"))
            for k in kernels.KERNELS}
    result = dict(shape=list(bev.shape), points=fy.shape[1],
                  launches=launches, tolerance=SAMPLE_GRAD_TOL)
    bad = [] if launches == want else [f"launches {launches}"]
    for key, (atol, rtol) in SAMPLE_GRAD_TOL.items():
        a, r = out["gpu"][key], out["cpu"][key]
        result[f"{key}_max_abs_err"] = float((a - r).abs().max())
        result[f"{key}_max_abs"] = float(r.abs().max())
        if not torch.allclose(a, r, rtol=rtol, atol=atol):
            bad.append(key)
    if min(result["dys_max_abs"], result["dxs_max_abs"]) == 0.0:
        bad.append("the coordinates get no gradient")
    print("  bilinear_sample_2d gradients card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"bilinear_sample_2d gradients, card vs CPU: "
                             f"{bad}: {result}")
    return result


# f32 two-stage CenterPoint train step, card vs CPU (phase 5c); the
# reasons for the tolerances are TRAIN_TOL's. The second stage is first
# compared on the same proposals: two right f32 forwards may rank two of
# the 6 x 128 candidates the other way round, and then the sets of 128
# proposals, and everything computed from them, differ.
# The refine head sees 128 rows, 16 or so of them foreground, which carry
# the box loss: one of its 2 x 128 x 128 ReLU inputs within rounding of
# zero moves a foreground row's gradient, and through the row the BEV map's
# and the parameters', by a few percent. So on the same proposals the
# features' gradient is compared row by row (a share of the rows must agree
# to ``row_rel_l2``), and the summed gradients only to a kink-sized bound.
# The whole step's gradients differ more between card and CPU than
# CenterNet's (TRAIN_TOL), and not because both f32 runs are equally noisy:
# the same step runs once more on the CPU with f64 compute over the same f32
# parameters, on the card's proposals (the referee), and the card lies 4 to
# 4000 times closer to it than the f32 CPU does (measured on an H100 host:
# the CPU's train-mode BEV map is 1.6e-4 from the referee's, the card's
# 6e-6; on one BEV map both second stages agree with the referee to 6e-6;
# ``--probe`` shows the distance open at the RPN's first train-mode BN on
# the CPU, more with fewer threads, and grow through the 17 that follow).
# So the card is held to the referee (the ``referee_*`` bounds, kink-sized:
# one ReLU input within rounding of zero moves a part's gradient by up to a
# percent; a part's gradient is compared over its parameters together), and
# to the f32 CPU by the wider bounds that run's own distance from the
# referee asks for.
CP_TRAIN_TOL = dict(loss_rtol=1e-4, stage2_loss_rtol=5e-3,
                    grad_norm_rtol=2e-3, grad_rel_l2=0.15, stat_atol=1e-4,
                    stat_rtol=1e-4, row_rel_l2=5e-2, row_share=0.9,
                    stage2_grad_rel_l2=0.25, same_box_m=1e-2,
                    referee_loss_rtol=1e-4, referee_grad_norm_rtol=1e-3,
                    referee_row_rel_l2=1e-3, referee_grad_rel_l2=3e-2)
CP_CHECK_BATCH = 1
CP_CHECK_GT = 32
CP_PARTS = ("reader", "rpn", "head", "refine")


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _cancelled_bias(name: str) -> bool:
    """A conv bias that a train-mode BN cancels: its gradient is rounding
    noise around 0 (the head's shared conv and each branch's first conv)."""
    return name.endswith("_conv0.bias") or name.endswith("shared_conv.bias")


def _part_rel_l2(grads, ref, part: str) -> float:
    """Relative L2 distance of ``grads`` from ``ref`` over all parameters
    whose name starts with ``part`` taken as one vector (cancelled biases
    left out)."""
    names = [n for n in ref if n.startswith(part) and not _cancelled_bias(n)]
    return _rel_l2(torch.cat([grads[n].double().reshape(-1) for n in names]),
                   torch.cat([ref[n].double().reshape(-1) for n in names]))


def _stage2_on(model, boxes, batch):
    """The second stage's losses of ``model`` (train mode) on the proposals
    ``boxes``, with their gradients with respect to the sampled features
    (B, K, 5 C), the BEV map and the refine head's parameters, and the
    train-mode BEV map itself (f64, on the CPU)."""
    d = next(model.parameters()).device
    batch = {k: v.to(d) for k, v in batch.items()}
    with torch.no_grad():
        bev = model.bev_from_points_stream(batch["points"],
                                           batch["points_mask"])
    bev.requires_grad_()
    sampled = []

    def keep(module, args, out):
        out.retain_grad()
        sampled.append(out)

    hook = model.extractor.register_forward_hook(keep)
    model.zero_grad(set_to_none=True)
    parts = model.stage2_loss(bev, boxes.to(d), batch)
    hook.remove()
    (parts["stage2_score"] + parts["stage2_box"]).backward()
    grads = {"feats": sampled[0].grad.float().cpu(),
             "bev": bev.grad.float().cpu()}
    grads.update({f"refine.{n}": p.grad.float().cpu()
                  for n, p in model.refine.named_parameters()})
    model.zero_grad(set_to_none=True)
    return ({k: float(v.detach()) for k, v in parts.items()}, grads,
            bev.detach().double().cpu())


def _one_centerpoint_step(model, batch, forced=None):
    """One train step of ``model`` (AdamW 1e-3, clip 35) from its present
    weights; with ``forced`` the second stage is given those proposals
    instead of the ones the model decodes. Returns the step's snapshot, the
    proposals used (on the CPU), the kernels' launch counts and the
    seconds."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import centerpoint_loss
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    d = next(model.parameters()).device
    decode, used = model.proposals, []

    def proposals(preds):
        used.append(decode(preds) if forced is None else forced.to(d))
        return used[-1]

    model.proposals = proposals
    state = TrainState.create(model, adamw(1e-3, clip_global_norm=35.0))
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = make_train_step(centerpoint_loss)(
        state, {k: v.to(d) for k, v in batch.items()})
    snap = _train_snapshot(state, metrics)
    del model.proposals
    launches = {k.name: k.launches for k in kernels.KERNELS}
    return snap, used[0].cpu(), launches, time.perf_counter() - t0


def check_centerpoint_train_f32(dev, gpu):
    """Phase 5c: one f32 two-stage CenterPoint train step at batch
    CP_CHECK_BATCH on the card against the same step on the CPU (TF32 off),
    with the step in f64 compute on the CPU as referee.
    ``gpu`` is the serving model on the card; its heads are calibrated here
    in train mode (batch statistics), so that the proposals' scores spread.
    First the second stage alone on the same proposals (K3f, K4 and K3dx on
    the card): both losses, the BEV map's gradient and the refine head's;
    some ground-truth boxes are moved onto proposals so that there is
    foreground.
    Then the whole step from the same weights: the loss and every part,
    grad_norm, every parameter's gradient by relative L2 and the BN
    statistics after the step. The referee takes the card's proposals, and
    the card is held to it by the ``referee_*`` bounds; where the CPU's
    proposals are not the card's, the f32 CPU's step runs again on the
    card's and that run is compared. The card's and the f32 CPU's distances
    from the referee are reported part by part."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (build_centerpoint,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.models.detectors.centerpoint import (
        CenterPointTwoStage)

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        CP_CHECK_BATCH, gpu.pc_range, seed=4).items()}
    gpu.train()
    calibrate_centerpoint(gpu, batch["points"].to(dev),
                          batch["points_mask"].to(dev))
    # the proposals both second stages are given: the card's, from a forward
    # made before the weights and statistics are copied
    with torch.no_grad():
        boxes = gpu.proposals(gpu.head(gpu.bev_from_points_stream(
            batch["points"].to(dev), batch["points_mask"].to(dev)))).cpu()
    # random boxes overlap no proposal: the first CP_CHECK_GT ground-truth
    # boxes become copies of proposals, every other one 0.1 m off
    # (foreground) and the rest 1 m off (IoU 0.3 to 0.65, by the yaw), and
    # every coordinate a little off, because the L1 box loss has its kink
    # where a target equals the prediction it was decoded from
    k = CP_CHECK_GT
    gt = boxes[:, :k].clone()
    gt[:, ::2, 0] += 0.1
    gt[:, 1::2, 0] += 1.0
    gt[..., 1] += 0.07
    gt[..., 2] += 0.1
    gt[..., 3:6] *= 1.05
    gt[..., 6:8] += 0.1
    gt[..., 8] += 0.02
    batch["gt_boxes"][:, :k] = gt
    batch["gt_mask"][:, :k] = True
    cpu = build_centerpoint("cpu").train()
    cpu.load_state_dict(gpu.state_dict())
    referee = CenterPointTwoStage(dtype=torch.float64).to(
        memory_format=torch.channels_last).train()
    referee.load_state_dict(cpu.state_dict())

    t = CP_TRAIN_TOL
    result, bad = {"tolerance": t}, []

    def hold_to_referee(key, card, host, ref, part):
        """Report both f32 runs' distances from the referee over ``part``'s
        gradients and hold the card's to ``referee_grad_rel_l2``."""
        result[f"{key}_card_vs_referee"] = _part_rel_l2(card, ref, part)
        result[f"{key}_cpu_vs_referee"] = _part_rel_l2(host, ref, part)
        if result[f"{key}_card_vs_referee"] > t["referee_grad_rel_l2"]:
            bad.append(f"{key} against the referee")

    kernels.reset_launches()
    parts_g, grads_g, bev_g = _stage2_on(gpu, boxes, batch)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != _centerpoint_launches(
            1, CP_SERVE_KERNELS + ("bilinear_gather_bwd_dx",)):
        bad.append(f"the second stage launched {launches}")
    parts_c, grads_c, bev_c = _stage2_on(cpu, boxes, batch)
    parts_r, grads_r, bev_r = _stage2_on(referee, boxes, batch)
    # how far each f32 forward (train-mode BN) is from the f64 one
    result["bev_card_vs_referee"] = _rel_l2(bev_g, bev_r)
    result["bev_cpu_vs_referee"] = _rel_l2(bev_c, bev_r)
    del bev_g, bev_c, bev_r
    for k, v in parts_c.items():
        result[f"same_proposals_{k}"] = v
        result[f"same_proposals_{k}_rel_err"] = abs(parts_g[k] - v) / max(
            abs(v), 1e-30)
        result[f"same_proposals_{k}_cpu_vs_referee"] = abs(
            parts_r[k] - v) / max(abs(parts_r[k]), 1e-30)
        if result[f"same_proposals_{k}_rel_err"] > t["stage2_loss_rtol"]:
            bad.append(f"{k} on the same proposals")
    rows_g, rows_c = grads_g.pop("feats")[0], grads_c.pop("feats")[0]
    rows_r = grads_r.pop("feats")[0]
    row_err = (rows_g - rows_c).norm(dim=-1) / rows_c.norm(
        dim=-1).clamp_min(1e-30)
    result["same_proposals_rows_agreeing"] = float(
        (row_err <= t["row_rel_l2"]).float().mean())
    result["same_proposals_row_rel_l2_median"] = float(row_err.median())
    for name, rows in (("card", rows_g), ("cpu", rows_c)):
        err = (rows - rows_r).norm(dim=-1) / rows_r.norm(dim=-1).clamp_min(
            1e-30)
        result[f"same_proposals_row_rel_l2_median_{name}_vs_referee"] = float(
            err.median())
        result[f"same_proposals_rows_agreeing_{name}_vs_referee"] = float(
            (err <= t["referee_row_rel_l2"]).float().mean())
    if min(result["same_proposals_rows_agreeing"],
           result["same_proposals_rows_agreeing_card_vs_referee"]) < t[
               "row_share"]:
        bad.append("the features' gradient on the same proposals")
    rel = {n: _rel_l2(grads_g[n], v) for n, v in grads_c.items()}
    result["same_proposals_bev_grad_rel_l2"] = rel["bev"]
    worst = max(rel, key=rel.get)
    result["same_proposals_grad_rel_l2_max"] = rel[worst]
    result["same_proposals_grad_rel_l2_worst"] = worst
    if rel[worst] > t["stage2_grad_rel_l2"]:
        bad.append(f"gradient of {worst} on the same proposals")
    for part in ("bev", "refine"):
        hold_to_referee(f"same_proposals_{part}_grad", grads_g, grads_c,
                        grads_r, part)

    # the whole step, all three from the same weights and statistics (the
    # second stage's forwards above moved the running statistics)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu.load_state_dict(start)
    referee.load_state_dict(start)
    g, pg, launches, seconds = _one_centerpoint_step(gpu, batch)
    print(f"  card step {seconds:.1f} s, loss {g['metrics']['loss']:.6f}",
          flush=True)
    if launches != _centerpoint_launches(1, CP_TRAIN_KERNELS):
        bad.append(f"the train step launched {launches}")
    c, pc, _, seconds = _one_centerpoint_step(cpu, batch)
    print(f"  CPU step {seconds:.1f} s, loss {c['metrics']['loss']:.6f}",
          flush=True)
    r, _, _, seconds = _one_centerpoint_step(referee, batch, forced=pg)
    print(f"  CPU f64 step on the card's proposals {seconds:.1f} s, loss "
          f"{r['metrics']['loss']:.6f}", flush=True)
    # the same proposals, in whatever order: every CPU box has a card box
    # within ``same_box_m`` of it
    dist = (pg[:, :, None, :8] - pc[:, None, :, :8]).abs().amax(-1)
    same = bool((dist.amin(1) < t["same_box_m"]).all())
    result["proposals_same_set"] = same
    result["proposals_unmatched"] = int(
        (dist.amin(1) >= t["same_box_m"]).sum())
    result["proposals_worst_match"] = float(dist.amin(1).max())
    result["proposals_same_order"] = bool(
        ((pg - pc)[..., :8].abs() < t["same_box_m"]).all())
    if not same:
        cpu.load_state_dict(start)
        c, _, _, seconds = _one_centerpoint_step(cpu, batch, forced=pg)
        print(f"  CPU step on the card's proposals {seconds:.1f} s, loss "
              f"{c['metrics']['loss']:.6f}", flush=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32

    for k, v in c["metrics"].items():
        if k == "grad_norm":
            continue
        err = abs(g["metrics"][k] - v) / max(abs(v), 1e-30)
        result[f"{k}_rel_err"] = err
        stage2 = k.startswith("stage2") or k == "loss"
        if err > (t["stage2_loss_rtol"] if stage2 else t["loss_rtol"]):
            bad.append(k)
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{k}_{name}_vs_referee"] = abs(
                snap["metrics"][k] - r["metrics"][k]) / max(
                    abs(r["metrics"][k]), 1e-30)
        if result[f"{k}_card_vs_referee"] > t["referee_loss_rtol"]:
            bad.append(f"{k} against the referee")
    result["loss"] = c["metrics"]["loss"]
    result["stage2_box"] = c["metrics"]["stage2_box"]
    result["grad_norm"] = c["metrics"]["grad_norm"]
    err = abs(g["metrics"]["grad_norm"] - result["grad_norm"]) / \
        result["grad_norm"]
    result["grad_norm_rel_err"] = err
    for name, snap in (("card", g), ("cpu", c)):
        result[f"grad_norm_{name}_vs_referee"] = abs(
            snap["metrics"]["grad_norm"] - r["metrics"]["grad_norm"]) / \
            r["metrics"]["grad_norm"]
    if err > t["grad_norm_rtol"]:
        bad.append("grad_norm")
    if result["grad_norm_card_vs_referee"] > t["referee_grad_norm_rtol"]:
        bad.append("grad_norm against the referee")
    rel = {n: _rel_l2(g["grads"][n], v) for n, v in c["grads"].items()
           if not _cancelled_bias(n)}
    for part in CP_PARTS:
        result[f"grad_rel_l2_{part}_max"] = max(
            v for n, v in rel.items() if n.startswith(part + "."))
        hold_to_referee(f"grad_{part}", g["grads"], c["grads"], r["grads"],
                        part + ".")
    worst = max(rel, key=rel.get)
    result["grad_rel_l2_worst"] = [
        f"{n} {v:.2e}" for n, v in sorted(rel.items(),
                                          key=lambda kv: -kv[1])[:6]]
    if rel[worst] > t["grad_rel_l2"]:
        bad.append(f"gradient of {worst}")
    stat_err = 0.0
    for n, v in c["stats"].items():
        e = (g["stats"][n] - v).abs()
        stat_err = max(stat_err, float(e.max()))
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"BN statistic {n}")
        e = (g["stats"][n] - r["stats"][n]).abs()
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"BN statistic {n} against the referee")
    result["stat_max_abs_err"] = stat_err
    print("  f32 CenterPoint train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 CenterPoint train step, card vs CPU: "
                             f"{bad} outside {t}: {result}")
    return result


def probe_train_forward(dev):
    """``--probe``: the train-mode forward of the two-stage CenterPoint
    (reader and RPN, batch 1, seeded weights, TF32 off) layer by layer on
    the card, on the CPU in f32 with all threads and with one, each against
    the CPU in f64 compute (relative L2 of every leaf module's output, then
    of the BEV map). Shows where an f32 run leaves the f64 one."""
    from minddet_tpu_torch.entry import (build_centerpoint,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.models.detectors.centerpoint import (
        CenterPointTwoStage)

    def trace(model):
        d = next(model.parameters()).device
        outs, hooks = [], []
        for name, m in model.named_modules():
            if name.startswith(("reader", "rpn")) and not list(m.children()):
                hooks.append(m.register_forward_hook(
                    lambda mod, args, out, name=name: outs.append(
                        (name, out.detach().double().cpu()))))
        with torch.no_grad():
            bev = model.bev_from_points_stream(batch["points"].to(d),
                                               batch["points_mask"].to(d))
        for h in hooks:
            h.remove()
        return outs + [("bev", bev.double().cpu())]

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = build_centerpoint(dev).train()
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        CP_CHECK_BATCH, gpu.pc_range, seed=4).items()}
    cpu = build_centerpoint("cpu").train()
    cpu.load_state_dict(gpu.state_dict())
    referee = CenterPointTwoStage(dtype=torch.float64).to(
        memory_format=torch.channels_last).train()
    referee.load_state_dict(gpu.state_dict())
    ref, card, host = trace(referee), trace(gpu), trace(cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    host1 = trace(cpu)
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    rows = []
    for (name, r), (_, g), (_, c), (_, c1) in zip(ref, card, host, host1):
        rows.append(dict(layer=name, shape=list(r.shape),
                         card=_rel_l2(g, r), cpu=_rel_l2(c, r),
                         cpu_one_thread=_rel_l2(c1, r)))
        print(f"  {name:24s} card {rows[-1]['card']:.2e}  CPU ({threads} "
              f"threads) {rows[-1]['cpu']:.2e}  CPU (1 thread) "
              f"{rows[-1]['cpu_one_thread']:.2e}", flush=True)
    return dict(threads=threads, layers=rows)


def train_main_path(dev, dcn4: bool = False):
    """Phase 6b (6g with ``dcn4``), a CenterNet training main path:
    ``train_entry`` (``centernet_dcn4_train_entry``) at TRAIN_BATCH,
    TRAIN_WARMUP + TRAIN_STEPS steps on one batch, launch counts from 0."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import centernet_dcn4_train_entry, train_entry

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    make = centernet_dcn4_train_entry if dcn4 else train_entry
    step_fn, (state, batch) = make(device=dev, batch=TRAIN_BATCH)
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
    want = _sampler_launches(steps, dcn4)
    if launches != want:
        raise AssertionError(f"{launches} in {steps} train steps (want "
                             f"{want})")
    print(f"  kernels: {launches} for {steps} steps == "
          f"{_sampler_launches(1, dcn4)} x steps: True", flush=True)
    return out, (step_fn, state, batch)


def centerpoint_train_main_path(dev):
    """Phase 6e, the CenterPoint training main path:
    ``centerpoint_train_entry`` at TRAIN_CP_BATCH, TRAIN_WARMUP +
    TRAIN_STEPS steps on one batch, launch counts from 0."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import centerpoint_train_entry

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batch) = centerpoint_train_entry(device=dev,
                                                      batch=TRAIN_CP_BATCH)
    kernels.reset_launches()
    history, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    losses = [m["loss"] for m in history]
    out = dict(batch=TRAIN_CP_BATCH, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               clouds_per_s=TRAIN_CP_BATCH / mean_s,
               max_memory_allocated=peak, losses=losses,
               first_step=history[0], last_step=history[-1],
               launches=launches)
    print(f"  CenterPoint train bf16 batch {TRAIN_CP_BATCH}: "
          f"{mean_s * 1e3:.3f} ms/step (p50 {out['ms_p50']:.3f}), "
          f"{out['clouds_per_s']:.1f} clouds/s, peak {peak / 2 ** 30:.2f} "
          f"GiB allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    print("  last step: " + " ".join(f"{k}={v:.4f}"
                                     for k, v in history[-1].items()),
          flush=True)
    finite = all(math.isfinite(v) for m in history for v in m.values())
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"CenterPoint train loss not finite and "
                             f"falling: {history}")
    if launches != _centerpoint_launches(steps, CP_TRAIN_KERNELS):
        raise AssertionError(
            f"{launches} in {steps} CenterPoint train steps (want one each "
            f"of {CP_TRAIN_KERNELS} per step, no bilinear_gather_bwd_dcw, "
            f"no sampler)")
    print(f"  kernels: {launches} for {steps} steps: one each of "
          f"{len(CP_TRAIN_KERNELS)} kernels per step: True", flush=True)
    return out, (step_fn, state, batch)


def serve(programs):
    """Phases 6a and 6f, a CenterNet serving main path: bf16 predict
    requests at batch 1 and 16."""
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


def _check_pointpillars_detections(det, b):
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


def _check_centerpoint_detections(det, b):
    """Refined detections of the calibrated nuScenes model: (b, 6 * 83)
    slots, every task's 83 filled (1000 valid candidates each), labels of
    the ten classes, scores sqrt(stage 1 x quality) in (0, 1], positive
    sizes; dropped slots would be label -1 with zero score and box."""
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    slots = CP_TASKS * CP_NMS_POST
    kept = labels >= 0
    ok = (boxes.shape == (b, slots, 9) and scores.shape == (b, slots)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all())
          and bool((kept.sum(1) > CP_NMS_POST).all())
          and bool((labels <= 9).all())
          and bool(((scores > 0) == kept).all()) and bool((scores <= 1).all())
          and bool((boxes[..., 3:6][kept] > 0).all())
          and bool((boxes[~kept] == 0).all()))
    if not ok:
        raise AssertionError(f"CenterPoint predict_refined at batch {b}: "
                             f"boxes {tuple(boxes.shape)}, kept "
                             f"{kept.sum(1).tolist()}, finite "
                             f"{bool(torch.isfinite(boxes).all())}")


def serve_clouds(label, programs, dev, check):
    """Phases 6c and 6d, a lidar model's serving main path: f32 requests
    from raw points at each batch size, with the peak memory, the NMS's
    passes per request and the detections kept per cloud; ``check(det,
    batch)`` raises on a malformed answer."""
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
        check(det, b)
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, clouds_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            nms_passes=passes, kept=(det["labels"] >= 0).sum(1).tolist())
        print(f"  {label} f32 batch {b}: {mean_s * 1e3:8.3f} ms/request"
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
    # kernels and copies, not the ranges that mark a host-side region on the
    # device's timeline (the optimizer's step)
    kevents = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
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


def profile_clouds(label, programs, requests: int = 3):
    """Where a lidar model's request's time goes, per batch size."""
    result = {}
    for b, (predict, args) in programs.items():
        result[f"b{b}"] = r = _profile(lambda: predict(*args), requests)
        _print_profile(f"{label} batch {b}", r)
    return result


def profile_train(label, step_fn, state, batch, steps: int = 3):
    """Where a train step's time goes."""
    r = _profile(lambda: step_fn(state, batch), steps)
    _print_profile(label, r)
    return r


def _kernel_row(kernel, launches, main_cases, calls_per_shape, cases,
                library: bool = False):
    """One kernel's entry of the ``{"kernels": [...]}`` line: times and
    bounds summed over ``main_cases``, the kernel's calls in one pass of
    each main path that launches it (one request at the largest batch, one
    train step), and ``main_shapes`` with the same numbers case by case;
    ``library`` where the cases timed one PyTorch call beside the kernel."""
    from minddet_tpu_torch import kernels

    if not main_cases:
        raise AssertionError(f"{kernel.name}: no phase 3 case at a main "
                             f"path's shape")
    tot = lambda key: calls_per_shape * sum(c[key] for c in main_cases)
    keys = ("shape", "against", "points", "samples", "dtype", "spread",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "grid_sample_ms", "fallback_share", "repeat")
    return dict(
        main_shapes=[{k: c[k] for k in keys if k in c} for c in main_cases],
        name=kernel.name, route="cuda",
        source=str(kernel.source.relative_to(kernels.CSRC.parent.parent)),
        replaces=kernel.replaces.split()[0], launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes"
                                for c in main_cases) else "operations",
        library_ms=tot("library_ms") if library else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--probe", action="store_true",
                    help="also compare the f32 CenterPoint train-mode "
                         "forward layer by layer, card and CPU, with the "
                         "CPU's in f64")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving requests of the three "
                         "models and 3 train steps of each trained model "
                         "(torch.profiler)")
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
    flat_cases = check_flat_kernel(dev, gen)
    flat_bwd_cases = check_flat_bwd_kernel(dev, gen)
    bias_rounding = check_dcn_bias_rounding(dev)
    torch.cuda.empty_cache()
    from minddet_tpu_torch.entry import build_centerpoint

    centerpoint = build_centerpoint(dev)
    iou_cases = check_rotated_iou_kernel(dev, gen, centerpoint.pc_range)
    seg_cases = check_seg_max_kernel(dev, centerpoint)
    gather_cases = check_bilinear_kernel(dev, gen, centerpoint)
    seg_bwd_cases = check_seg_max_bwd_kernel(dev, centerpoint)
    gather_dx_cases, gather_dcw_cases = check_bilinear_bwd_kernels(
        dev, gen, centerpoint)

    print("phase 4: end to end, f32 predict, card vs CPU", flush=True)
    e2e = check_end_to_end_f32(dev, gen)
    print("phase 4b: end to end, f32 PointPillars predict, card vs CPU",
          flush=True)
    pp_f32 = check_pointpillars_f32(dev)
    print("phase 4c: end to end, f32 two-stage CenterPoint predict, card vs "
          "CPU", flush=True)
    cp_f32 = check_centerpoint_f32(dev, centerpoint)
    print("phase 4d: end to end, f32 predict with DCN in all four backbone "
          "stages, card vs CPU", flush=True)
    e2e_dcn4 = check_end_to_end_f32(dev, gen, dcn4=True)

    print("phase 5: end to end, f32 train step, card vs CPU and the f64 "
          "referee", flush=True)
    train_f32 = check_train_step_f32(dev, gen)
    print("phase 5b: bilinear_sample_2d gradients, card vs CPU", flush=True)
    sample_grads = check_sample_grads_f32(dev, gen, centerpoint)
    print("phase 5c: end to end, f32 two-stage CenterPoint train step, card "
          "vs CPU", flush=True)
    cp_train_f32 = check_centerpoint_train_f32(dev, centerpoint)
    del centerpoint
    print(f"phase 5d: end to end, f32 train step with DCN in all four "
          f"backbone stages at {CHECK_RES_DCN4}x{CHECK_RES_DCN4}, card vs the "
          f"f64 referee", flush=True)
    train_f32_dcn4 = check_train_step_f32(dev, gen, dcn4=True,
                                          res=CHECK_RES_DCN4)
    forward_probe = None
    if args.probe:
        print("probe: f32 CenterPoint train-mode forward against f64, layer "
              "by layer", flush=True)
        forward_probe = probe_train_forward(dev)
    torch.cuda.empty_cache()

    print("phase 6a: main path, bf16 serving", flush=True)
    from minddet_tpu_torch.entry import entry

    programs = {b: entry(device=dev, batch=b) for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, gen)
    kernels.reset_launches()
    serving, forwards = serve(programs)
    serve_launches = {k.name: k.launches for k in kernels.KERNELS}
    taps = serve_launches["hat_sample_taps_fwd"]
    if serve_launches != _sampler_launches(forwards, train=False):
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
        profiled["train"] = profile_train(f"train batch {TRAIN_BATCH}",
                                          *train_program)
    del train_program
    torch.cuda.empty_cache()

    print("phase 6f: main path, bf16 serving with DCN in all four backbone "
          "stages", flush=True)
    from minddet_tpu_torch.entry import centernet_dcn4_entry

    programs = {b: centernet_dcn4_entry(device=dev, batch=b)
                for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, gen)
    kernels.reset_launches()
    serving_dcn4, forwards_dcn4 = serve(programs)
    serve_dcn4_launches = {k.name: k.launches for k in kernels.KERNELS}
    want = _sampler_launches(forwards_dcn4, dcn4=True, train=False)
    if serve_dcn4_launches != want:
        raise AssertionError(f"serving with DCN in four stages launched "
                             f"{serve_dcn4_launches} for {forwards_dcn4} "
                             f"forwards (want {want})")
    print(f"  kernels: {serve_dcn4_launches} forwards={forwards_dcn4}: "
          f"hat_sample_flat_fwd == 2 x forwards, hat_sample_taps_fwd == 9 x "
          f"forwards: True", flush=True)
    if args.profile:
        print("profile: bf16 serving with DCN in four stages", flush=True)
        profiled["serving_dcn4"] = profile_serving(programs)
    del programs
    torch.cuda.empty_cache()

    print(f"phase 6g: main path, bf16 train step with DCN in all four "
          f"backbone stages at batch {TRAIN_BATCH}", flush=True)
    training_dcn4, train_program = train_main_path(dev, dcn4=True)
    if args.profile:
        print("profile: bf16 train step with DCN in four stages", flush=True)
        profiled["train_dcn4"] = profile_train(
            f"train (DCN in four stages) batch {TRAIN_BATCH}", *train_program)
    del train_program
    torch.cuda.empty_cache()

    print("phase 6c: main path, PointPillars f32 serving", flush=True)
    from minddet_tpu_torch.entry import pointpillars_entry

    pp_programs = {b: pointpillars_entry(device=dev, batch=b)
                   for b in PP_BATCHES}
    kernels.reset_launches()
    pp_serving, predicts = serve_clouds("PointPillars", pp_programs, dev,
                                        _check_pointpillars_detections)
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
        profiled["pointpillars"] = profile_clouds("PointPillars",
                                                  pp_programs)
    del pp_programs
    torch.cuda.empty_cache()

    print("phase 6d: main path, two-stage CenterPoint f32 serving",
          flush=True)
    from minddet_tpu_torch.entry import centerpoint_entry

    cp_programs = {b: centerpoint_entry(device=dev, batch=b)
                   for b in CP_BATCHES}
    for predict, clouds in cp_programs.values():
        calibrate_centerpoint(predict.__self__, *clouds)
    kernels.reset_launches()
    cp_serving, cp_predicts = serve_clouds("CenterPoint", cp_programs, dev,
                                           _check_centerpoint_detections)
    cp_launches = {k.name: k.launches for k in kernels.KERNELS}
    if cp_launches != _centerpoint_launches(cp_predicts):
        raise AssertionError(f"CenterPoint serving launched {cp_launches} "
                             f"for {cp_predicts} requests (want one each of "
                             f"seg_full_max, rotated_iou_intersect and "
                             f"bilinear_gather_fwd per request, no sampler)")
    print(f"  kernels: {cp_launches} requests={cp_predicts} seg_full_max == "
          f"rotated_iou_intersect == bilinear_gather_fwd == requests: True",
          flush=True)
    if args.profile:
        print("profile: CenterPoint serving", flush=True)
        profiled["centerpoint"] = profile_clouds("CenterPoint", cp_programs)
    del cp_programs
    torch.cuda.empty_cache()

    print(f"phase 6e: main path, two-stage CenterPoint bf16 train step at "
          f"batch {TRAIN_CP_BATCH}", flush=True)
    cp_training, cp_train_program = centerpoint_train_main_path(dev)
    if args.profile:
        print("profile: CenterPoint bf16 train step", flush=True)
        profiled["centerpoint_train"] = profile_train(
            f"CenterPoint train batch {TRAIN_CP_BATCH}", *cp_train_program)
    del cp_train_program
    torch.cuda.empty_cache()

    # the summary rows: K1f is one bf16 batch-16 forward's nine calls (3 at
    # each DCN shape, the spread-1.5 cases); K1b one bf16 train step's nine
    # calls at the train batch (spread 1.5: offsets that moved)
    fwd_main = [c for c in cases
                if c["dtype"] == "bfloat16" and c["spread"] == 1.5]
    bwd_main = [c for c in bwd_cases
                if c["shape"][0] == TRAIN_BATCH and c["spread"] == 1.5]
    train_launches = training["launches"]
    cp_train_launches = cp_training["launches"]
    # K5b, K3dx and K3dcw: one bf16 batch-8 CenterPoint train step's call
    train_case = lambda cs: [
        c for c in cs if c["dtype"] == "bfloat16"
        and c["shape"][0] == TRAIN_CP_BATCH and c.get("stream", "uniform")
        == "uniform"]
    train_dcn4_launches = training_dcn4["launches"]
    # K2f: one bf16 batch-16 forward's two calls and one train step's two
    # at batch 128 (spread 1.5); K2b: one train step's two at batch 128
    flat_fwd_main = [c for c in flat_cases
                     if c["dtype"] == "bfloat16" and c["spread"] == 1.5
                     and c["shape"][0] in (BATCH, TRAIN_BATCH)
                     and c["shape"][1:] == [FLAT_SHAPE[0]] * 2
                     + [FLAT_SHAPE[1]]]
    flat_bwd_main = [c for c in flat_bwd_cases
                     if c["shape"][0] == TRAIN_BATCH and c["spread"] == 1.5]
    rows = [
        _kernel_row(kernels.HAT_SAMPLE_TAPS_FWD,
                    taps + train_launches["hat_sample_taps_fwd"]
                    + serve_dcn4_launches["hat_sample_taps_fwd"]
                    + train_dcn4_launches["hat_sample_taps_fwd"], fwd_main,
                    DCN_CALLS_PER_SHAPE, cases),
        _kernel_row(kernels.HAT_SAMPLE_TAPS_BWD,
                    train_launches["hat_sample_taps_bwd"]
                    + train_dcn4_launches["hat_sample_taps_bwd"], bwd_main,
                    DCN_CALLS_PER_SHAPE, bwd_cases),
        # K4: one batch-8 PointPillars request's call, one batch-4
        # CenterPoint request's and one CenterPoint train step's
        _kernel_row(kernels.ROTATED_IOU,
                    pp_launches["rotated_iou_intersect"]
                    + cp_launches["rotated_iou_intersect"]
                    + cp_train_launches["rotated_iou_intersect"],
                    [c for c in iou_cases if c["shape"][:2] in (
                        [PP_BATCHES[-1], PP_CANDIDATES],
                        [CP_TASKS * CP_BATCHES[-1], CP_CANDIDATES],
                        [TRAIN_CP_BATCH, CP_PROPOSALS])], 1, iou_cases),
        # K5f and K3f: one f32 batch-4 CenterPoint request's call and one
        # bf16 batch-8 train step's
        _kernel_row(kernels.SEG_FULL_MAX, cp_launches["seg_full_max"]
                    + cp_train_launches["seg_full_max"],
                    [c for c in seg_cases if c["dtype"] == "float32"
                     and c["shape"][0] == CP_BATCHES[-1]]
                    + train_case(seg_cases), 1, seg_cases),
        _kernel_row(kernels.SEG_FULL_MAX_BWD,
                    cp_train_launches["seg_full_max_bwd"],
                    train_case(seg_bwd_cases), 1, seg_bwd_cases),
        _kernel_row(kernels.BILINEAR_GATHER_FWD,
                    cp_launches["bilinear_gather_fwd"]
                    + cp_train_launches["bilinear_gather_fwd"],
                    [c for c in gather_cases if c["dtype"] == "float32"
                     and c["shape"][0] == CP_BATCHES[-1]]
                    + train_case(gather_cases), 1, gather_cases,
                    library=True),
        _kernel_row(kernels.BILINEAR_GATHER_BWD_DX,
                    cp_train_launches["bilinear_gather_bwd_dx"],
                    train_case(gather_dx_cases), 1, gather_dx_cases,
                    library=True),
        # K3dcw: no entry point reaches it yet (the train step's proposals
        # are detached), so its count on the main paths is 0; phase 5b's
        # launch, through bilinear_sample_2d's gradient to the coordinates,
        # stands beside it under its own key
        dict(_kernel_row(kernels.BILINEAR_GATHER_BWD_DCW,
                         cp_train_launches["bilinear_gather_bwd_dcw"],
                         train_case(gather_dcw_cases), 1, gather_dcw_cases),
             launches_in_phase_5b=sample_grads["launches"][
                 "bilinear_gather_bwd_dcw"]),
        _kernel_row(kernels.HAT_SAMPLE_FLAT_FWD,
                    serve_dcn4_launches["hat_sample_flat_fwd"]
                    + train_dcn4_launches["hat_sample_flat_fwd"],
                    flat_fwd_main, FLAT_LAYERS, flat_cases),
        _kernel_row(kernels.HAT_SAMPLE_FLAT_BWD,
                    train_dcn4_launches["hat_sample_flat_bwd"],
                    flat_bwd_main, FLAT_LAYERS, flat_bwd_cases),
    ]
    wall_s = time.perf_counter() - t_start
    print(f"  chip_smoke wall time {wall_s:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           wall_s=wall_s, taps_cases=cases,
                           taps_bwd_cases=bwd_cases, flat_cases=flat_cases,
                           flat_bwd_cases=flat_bwd_cases,
                           dcn_bias_rounding=bias_rounding,
                           end_to_end_f32_dcn4=e2e_dcn4,
                           train_step_f32_dcn4=train_f32_dcn4,
                           serving_dcn4=serving_dcn4,
                           serving_dcn4_launches=serve_dcn4_launches,
                           forwards_dcn4=forwards_dcn4,
                           training_dcn4=training_dcn4,
                           rotated_iou_cases=iou_cases,
                           seg_full_max_cases=seg_cases,
                           bilinear_gather_cases=gather_cases,
                           seg_full_max_bwd_cases=seg_bwd_cases,
                           bilinear_gather_bwd_dx_cases=gather_dx_cases,
                           bilinear_gather_bwd_dcw_cases=gather_dcw_cases,
                           sample_grads_f32=sample_grads,
                           centerpoint_train_f32=cp_train_f32,
                           centerpoint_forward_probe=forward_probe,
                           centerpoint_training=cp_training,
                           end_to_end_f32=e2e, pointpillars_f32=pp_f32,
                           centerpoint_f32=cp_f32,
                           train_step_f32=train_f32, serving=serving,
                           serving_launches=serve_launches,
                           forwards=forwards, training=training,
                           pointpillars_serving=pp_serving,
                           pointpillars_launches=pp_launches,
                           centerpoint_serving=cp_serving,
                           centerpoint_launches=cp_launches,
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
