"""Time the row gather's forward (K3f) and its weight backward (K3dcw) at
the shapes the port's main paths give them, on one CUDA card.

The package is imported from ``--root`` (default: this checkout), so the
same cases can be timed on two checkouts in turns, each in its own
process, to compare their kernels:

    python3 scripts/time_gather.py --root PARENT --json a.json
    python3 scripts/time_gather.py --json b.json

``--wide`` launches both kernels with 64-bit thread and warp indices (the
plans' ``wide``) at every size, where they would take 32-bit ones below
2**31: the cost of the 32-bit fast path's absence, in the same checkout.

Cases: K3f at the R-CNN ROIAlign shapes (each FPN level of a 512 x 512
image, C = 256, the box head's 512 x 196 points and the mask head's 100 x
784 per image, batch 1 and 8, bf16), at CenterPoint's second-stage shapes
(a (B, 128 * 128, 384) BEV map, 2490 points per image at serving batches
1 and 4, 640 at train batch 8; f32 and bf16), and K3dcw at the train
shape. Each time is the median of 5 windows of 20 back-to-back calls,
timed with CUDA events. Prints the card's name and power limit first and
one line per case.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

HOST_AHEAD_CYCLES = 20_000_000  # ~10 ms of GPU clock: the host queues ahead


def _ms(fn, iters: int = 20, windows: int = 5) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def _rois(b: int, r: int, gen, res: int = 512) -> torch.Tensor:
    """Rois drawn like a 512 x 512 request's proposals: sizes log-uniform
    over 4-512 px, centres uniform, clipped; every tenth a zero slot."""
    wh = torch.exp(math.log(4) + math.log(res / 4) * torch.rand(
        b, r, 2, generator=gen))
    xy = res * torch.rand(b, r, 2, generator=gen) - wh / 2
    rois = torch.cat([xy, xy + wh], -1).clamp(0, res)
    rois[:, ::10] = 0.0
    return rois


def _roi_points(boxes: torch.Tensor, size: int, s: int = 2):
    """ROIAlign's s x s samples a bin (aligned=False), (B, R * (size*s)^2)."""
    b, r = boxes.shape[:2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    g = (torch.arange(size * s, dtype=torch.float32,
                      device=boxes.device) + 0.5) / s
    ys = y1[..., None] + (y2 - y1).clamp(min=1.0)[..., None] / size * g
    xs = x1[..., None] + (x2 - x1).clamp(min=1.0)[..., None] / size * g
    n = size * s
    return (ys[..., :, None].expand(b, r, n, n).reshape(b, -1),
            xs[..., None, :].expand(b, r, n, n).reshape(b, -1))


def cases(dev):
    """(name, kernel, x, ci, cw) of every case."""
    from minddet_tpu_torch.ops import bilinear as bl

    gen = torch.Generator().manual_seed(0)
    for b in (1, 8):
        for kind, r, size in (("box", 512, 7), ("mask", 100, 14)):
            boxes = _rois(b, r, gen).to(dev)
            for stride in (4, 8, 16, 32):
                side = 512 // stride
                ys, xs = _roi_points(boxes / stride, size)
                ci, cw = bl.bilinear_corners(ys, xs, side, side)
                x = torch.randn(b, side * side, 256, generator=gen).to(
                    dev, torch.bfloat16)
                yield (f"K3f rcnn_{kind} b{b} P{int(math.log2(stride))} "
                       f"bfloat16", "fwd", x, ci, cw)
    for b, p in ((1, 2490), (4, 2490), (8, 640)):
        ys = 128 * torch.rand(b, p, generator=gen)
        xs = 128 * torch.rand(b, p, generator=gen)
        ci, cw = bl.bilinear_corners(ys.to(dev), xs.to(dev), 128, 128)
        x32 = torch.randn(b, 128 * 128, 384, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            yield (f"K3f centerpoint b{b} P={p} {name}", "fwd",
                   x32.to(dtype), ci, cw)
            if b == 8:
                yield (f"K3dcw centerpoint b{b} P={p} {name}", "dcw",
                       x32.to(dtype), ci, cw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent
                                          .parent),
                    help="the checkout whose minddet_tpu_torch is timed")
    ap.add_argument("--json", help="also write the times here")
    ap.add_argument("--wide", action="store_true",
                    help="64-bit thread and warp indices at every size")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gather: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from minddet_tpu_torch.ops import bilinear as bl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"  package {Path(bl.__file__).resolve()}, wide={args.wide}",
          flush=True)
    if args.wide:
        for plan in ("gather_fwd_plan", "gather_dcw_plan"):
            def wide(*a, _plan=getattr(bl, plan)):
                return dict(_plan(*a), wide=True)
            setattr(bl, plan, wide)
    dev = torch.device("cuda", 0)
    out = dict(card=card, root=str(Path(args.root).resolve()),
               wide=args.wide, cases={})
    for name, kind, x, ci, cw in cases(dev):
        if kind == "fwd":
            def call():
                return bl.bilinear_gather(x, ci, cw)
        else:
            g = torch.randn(ci.shape[0], ci.shape[1], x.shape[2],
                            device=dev).to(x.dtype)

            def call():
                return bl.bilinear_gather_bwd_dcw(g, x, ci, cw)
        ms = _ms(call)
        out["cases"][name] = ms
        print(f"  {name:40s} {ms * 1e3:9.2f} us", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
