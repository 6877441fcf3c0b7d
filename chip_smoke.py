#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``minddet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it, in f32 and bf16, with its time (CUDA events,
   warm L2), the plain version's time and the memory/compute bound;
4. end to end in f32 (TF32 off): ``CenterNet`` predict on the card against
   the same model on the CPU (the plain path);
5. the main path: the flagship serving program (CenterNet-R18-DCNv2, 80
   classes, 512x512, bf16, top-100) answers requests at batch 1 and 16, with
   every kernel's launch count set to 0 before and read after.

The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. ``--json PATH`` also writes every measurement there;
``--profile`` also breaks the serving requests down with ``torch.profiler``.
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


def _taps_bound(x, ys, xs):
    """(bound_ms, bound_by) of the taps sampler on these inputs: the output
    written once, the x rows these samples touch read once, the three
    coordinate arrays read once; 9 f32 operations per output value (4 FMAs
    and the scale)."""
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    rows = 0
    for bi in range(b):
        touched = []
        for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
            inb = (cy[bi] >= 0) & (cy[bi] < h) & (cx[bi] >= 0) & (cx[bi] < w)
            touched.append((cy[bi] * w + cx[bi])[inb].long())
        rows += int(torch.unique(torch.cat(touched)).numel())
    elt = x.element_size()
    nbytes = b * p * k * c * elt + rows * c * elt + 3 * b * k * p * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 9 * b * p * k * c / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def serve(programs):
    """Phase 5, the main path: bf16 predict requests at batch 1 and 16."""
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


def profile_serving(programs, requests: int = 3):
    """Where a request's time goes: ``torch.profiler`` over ``requests``
    warm requests per batch size; the device's busy time (union of kernel
    intervals) against the host clock of the window, and the kernels with
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    result = {}
    for b, (predict, (image,)) in programs.items():
        predict(image)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(requests):
                predict(image)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kevents = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if not kevents:
            raise RuntimeError("the profiler recorded no device time")
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kevents)
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
        result[f"b{b}"] = dict(
            batch=b, requests=requests, wall_ms_per_request=wall_us / 1e3
            / requests, device_busy_ms_per_request=busy / 1e3 / requests,
            idle_share=1 - busy / wall_us,
            kernel_launches_per_request=len(kevents) / requests,
            top_kernels=[dict(name=n, ms_per_request=t / 1e3 / requests,
                              share_of_busy=t / busy) for n, t in top])
        r = result[f"b{b}"]
        print(f"  profile batch {b:2d}: wall {r['wall_ms_per_request']:.3f}"
              f" ms/request (profiled), device busy "
              f"{r['device_busy_ms_per_request']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, "
              f"{r['kernel_launches_per_request']:.0f} kernels/request")
        for k in r["top_kernels"]:
            print(f"    {k['ms_per_request']:8.3f} ms {k['share_of_busy']:6.1%}"
                  f"  {k['name'][:100]}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving requests (torch.profiler)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    from minddet_tpu_torch import kernels

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

    print("phase 4: end to end, f32, card vs CPU", flush=True)
    e2e = check_end_to_end_f32(dev, gen)

    print("phase 5: main path, bf16 serving", flush=True)
    from minddet_tpu_torch.entry import entry

    programs = {b: entry(device=dev, batch=b) for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, gen)
    kernels.reset_launches()
    serving, forwards = serve(programs)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    taps = launches["hat_sample_taps_fwd"]
    if taps != DCN_LAYERS * forwards:
        raise AssertionError(f"hat_sample_taps_fwd launched {taps} times "
                             f"for {forwards} forwards (want 9 each)")
    print(f"  kernels: hat_sample_taps_fwd launches={taps} forwards="
          f"{forwards} launches == 9 x forwards: True", flush=True)

    # the summary row: one bf16 forward at batch 16 makes 3 calls at each
    # DCN shape; times and bounds are those of the spread-1.5 cases
    main_cases = [c for c in cases
                  if c["dtype"] == "bfloat16" and c["spread"] == 1.5]
    tot = lambda key: DCN_CALLS_PER_SHAPE * sum(c[key] for c in main_cases)
    taps_kernel = kernels.HAT_SAMPLE_TAPS_FWD
    row = dict(
        name=taps_kernel.name, route="cuda",
        source=str(taps_kernel.source.relative_to(
            kernels.CSRC.parent.parent)),
        replaces=taps_kernel.replaces.split()[0],
        launches=taps,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes"
                                for c in main_cases) else "operations",
        library_ms=None)

    profiled = None
    if args.profile:
        print("profile: bf16 serving", flush=True)
        profiled = profile_serving(programs)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           taps_cases=cases, end_to_end_f32=e2e,
                           serving=serving, launches=launches,
                           forwards=forwards, profile=profiled,
                           kernels=[row]), f, indent=1)
    print(card)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
