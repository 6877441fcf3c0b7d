"""Time K5f and K5b (``csrc/seg_full_max.cu``, ``csrc/seg_full_max_bwd.cu``)
with 32-bit and with 64-bit indices (the C entries' ``wide`` argument: K5f's
thread indices, K5b's row offsets) at the shapes the CenterPoint main paths
give them, in turns, on one CUDA card:

    python3 scripts/seg_max_index_width.py [--json PATH]

The streams are those of ``chip_smoke.py``'s phase 3: the port's voxelizer
on synthetic nuScenes-sized clouds (120,000 points each), serving batch 4
in f32 and train batch 8 in bf16, at the PFN's C = 32 and at C = 18 (padded
to 24). Each time is the device time per call of 200 back-to-back calls
(CUDA events), 8 times per width, the widths alternating in ABBA order;
the two widths' outputs must be bit-equal. Prints the card's name and power
limit first, then one line per kernel and shape: the eight times of each
width and their medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROUNDS = 8
ITERS = 200
CASES = ((4, torch.float32, 32), (8, torch.bfloat16, 32),
         (8, torch.bfloat16, 18))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the times here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seg_max_index_width: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import build_centerpoint
    from minddet_tpu_torch.ops import seg_max as sm
    from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch

    print(cs._card(), flush=True)
    kernels.build_all([kernels.SEG_FULL_MAX, kernels.SEG_FULL_MAX_BWD])
    dev = torch.device("cuda", 0)
    model = build_centerpoint(dev)
    bound = model.max_points_per_voxel
    dgen = torch.Generator(device=dev).manual_seed(2)
    fwd, bwd = kernels.SEG_FULL_MAX.fn(), kernels.SEG_FULL_MAX_BWD.fn()
    stream = kernels.cuda_stream(dev)
    results = {}
    for b, dtype, c in CASES:
        points, mask = cs._nusc_clouds(model, b, 2, dev)
        sv = voxelize_stream_batch(points, mask, model.voxel_size,
                                   model.pc_range, model.max_voxels, bound,
                                   model.voxel_drop_order)
        first, last = sv.first, sv.last
        n = first.shape[1]
        x = sm.pad_channels(torch.randn(b, n, c, generator=dgen,
                                        device=dev).to(dtype))
        ch = x.shape[-1]
        g = torch.randn(x.shape, generator=dgen, device=dev).to(dtype)
        code = sm._DTYPE_CODE[dtype]
        out = torch.empty_like(x)
        plan = sm.seg_max_bwd_plan(b, n, ch, dtype, bound)
        launch = {
            "K5f": lambda wide: fwd(
                x.data_ptr(), first.data_ptr(), last.data_ptr(),
                out.data_ptr(), b, n, ch, bound, code, wide, stream),
            "K5b": lambda wide: bwd(
                x.data_ptr(), g.data_ptr(), first.data_ptr(),
                last.data_ptr(), out.data_ptr(), b, n, ch, ch, bound,
                plan["tile_rows"], plan["chunk"], plan["smem"], code, wide,
                stream)}
        for name, fn in launch.items():
            outs = []
            for wide in (0, 1):
                kernels.SEG_FULL_MAX.check(fn(wide))
                torch.cuda.synchronize()
                outs.append(out.clone())
            if not torch.equal(*outs):
                raise AssertionError(f"{name} {[b, n, c]}: the 32-bit and "
                                     f"64-bit indices disagree")
            us = {0: [], 1: []}
            for r in range(ROUNDS):
                for wide in ((0, 1) if r % 2 == 0 else (1, 0)):
                    us[wide].append(1e3 * cs._cuda_ms(
                        lambda: fn(wide), iters=ITERS, warmup=5))
            key = f"{name} {[b, n, c]} {str(dtype).replace('torch.', '')}"
            results[key] = dict(
                us_32bit=us[0], us_64bit=us[1],
                median_us_32bit=statistics.median(us[0]),
                median_us_64bit=statistics.median(us[1]))
            print(f"{key}: 32-bit {[round(v, 2) for v in us[0]]} median "
                  f"{statistics.median(us[0]):.3f} us; 64-bit "
                  f"{[round(v, 2) for v in us[1]]} median "
                  f"{statistics.median(us[1]):.3f} us", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
