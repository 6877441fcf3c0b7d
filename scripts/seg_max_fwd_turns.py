"""Hold K5f (``csrc/seg_full_max.cu``) against the kernel it replaced, on one
CUDA card:

    python3 scripts/seg_max_fwd_turns.py --against OLD_CHECKOUT \
        [--tiles 32,64,128,256] [--chunks 2,4,8] [--rounds 4] [--json PATH]

``OLD_CHECKOUT`` is a checkout (``git archive`` of a commit) whose
``minddet_tpu_torch/csrc/seg_full_max.cu`` has the C entry of the per-row
kernel before the tiled design: ``seg_full_max(x, first, last, out, B, N,
C, bound, dtype, wide, stream)``. Both sources are built here. The streams
are those of ``chip_smoke.py``'s phase 3 K5f cases (``seg_fwd_streams``):
nuScenes-sized uniform clouds (f32 at B = 1, 2 and 4, bf16 at B = 1 and 8,
C = 18 bf16 at B = 8), the Waymo-like frames (f32 at B = 1, 2 and 4) and
clustered clouds (pillars at the cap of 20 points, x in {-0, 0, 1, 2,
NaN}, f32 and bf16). On every stream the two kernels' outputs must be bit
for bit equal, compared as bytes. Then, in turns (old, new, new, old;
``--rounds`` times), each the median of 5 windows of 20 back-to-back calls
timed with CUDA events:

- the two kernels (each one launch on x padded beforehand: C = 18 to 24);
- the new kernel at each tile height of ``--tiles`` and each chunk of
  ``--chunks`` 16-byte vectors a block (the wrapper with the plan's
  constants set so that it takes them as they are).

Each stream's kept-row bound (``chip_smoke.py:_seg_fwd_bound``) is printed
beside its times. Prints the card's name and power limit first, then one
line per stream.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _turns(fns: dict, rounds: int, ms) -> dict:
    """{name: [ms per round]}: the functions timed in turns, the order
    reversed every other round."""
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(ms(fns[k]))
    return times


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="checkout holding the kernel before the redesign")
    ap.add_argument("--tiles", default="32,64,128,256",
                    help="tile heights to time the new kernel at")
    ap.add_argument("--chunks", default="2,4,8",
                    help="vectors a block to time the new kernel at")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--json", help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seg_max_fwd_turns: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import build_centerpoint, waymo_config
    from minddet_tpu_torch.ops import seg_max as sm

    card = cs._card()
    print(card, flush=True)
    _p, _i = ctypes.c_void_p, ctypes.c_int
    old = kernels.CudaKernel("seg_full_max", "seg_full_max.cu",
                             [_p] * 4 + [_i] * 6 + [_p], replaces="")
    old.source = (Path(args.against) / "minddet_tpu_torch" / "csrc"
                  / "seg_full_max.cu")
    kernels.build_all([old, kernels.SEG_FULL_MAX])
    dev = torch.device("cuda", 0)
    stream = kernels.cuda_stream(dev)
    shapes = [(int(t), int(c)) for t in args.tiles.split(",")
              for c in args.chunks.split(",")]
    default = (sm.SEG_FWD_TILE, sm.SEG_FWD_CHUNK, sm.SEG_FWD_WORK,
               sm.SEG_SLOTS)
    ms = lambda fn: cs._cuda_ms(fn, iters=20, windows=5)
    nan_values = lambda shape, dgen, dev: cs.clustered_values(shape, dgen,
                                                              dev, nan=True)
    f32, bf16, width = torch.float32, torch.bfloat16, cs.PFN_HALF_WIDTH
    train_batch, eval_batch = cs._waymo_batch_sizes()
    groups = (
        ("nuscenes", lambda: build_centerpoint(dev), None, None, None),
        ("waymo", lambda: build_centerpoint(dev, waymo_config(
            two_stage=True)), tuple((b, f32, width) for b in (
                1, eval_batch, train_batch)), cs._waymo_clouds, None),
        ("clustered", lambda: build_centerpoint(dev), (
            (1, f32, width), (1, bf16, width)), cs._clustered_clouds,
         nan_values))

    results = []
    for name, model_fn, stream_shapes, clouds, values in groups:
        model = model_fn()
        bound = model.max_points_per_voxel

        def old_fwd(first, last, x):
            """The per-row kernel on a padded x."""
            out = torch.empty_like(x)
            b, n, ch = x.shape
            old.check(old.fn()(
                x.data_ptr(), first.data_ptr(), last.data_ptr(),
                out.data_ptr(), b, n, ch, bound, sm._DTYPE_CODE[x.dtype],
                int(sm.seg_max_plan(b, n, ch, x.dtype, bound)["wide"]),
                stream))
            return out

        for b, dtype, c, sv, x in cs.seg_fwd_streams(
                dev, model, stream_shapes, clouds, values):
            first, last = sv.first, sv.last
            xp = sm.pad_channels(x)
            new = sm.seg_full_max_bounded(first, last, xp, bound)
            was = old_fwd(first, last, xp)
            torch.cuda.synchronize()
            equal = torch.equal(_bits(new), _bits(was))
            nan_rows = int(torch.isnan(x.float()).any(-1).sum())
            del new, was
            kernel = _turns({
                "old": lambda: old_fwd(first, last, xp),
                "new": lambda: sm.seg_full_max_bounded(first, last, xp,
                                                       bound)},
                args.rounds, ms)
            bound_ms, _ = cs._seg_fwd_bound(x, sv.keep)

            def at(tile, chunk):
                def run():
                    (sm.SEG_FWD_TILE, sm.SEG_FWD_CHUNK, sm.SEG_FWD_WORK,
                     sm.SEG_SLOTS) = tile, chunk, tile * chunk, 0
                    try:
                        sm.seg_full_max_bounded(first, last, xp, bound)
                    finally:
                        (sm.SEG_FWD_TILE, sm.SEG_FWD_CHUNK, sm.SEG_FWD_WORK,
                         sm.SEG_SLOTS) = default
                return run

            sweep = _turns({tc: at(*tc) for tc in shapes}, args.rounds, ms)
            plan = sm.seg_max_plan(*xp.shape, dtype, bound)
            case = dict(
                stream=name, shape=[b, first.shape[1], c],
                dtype=str(dtype).replace("torch.", ""),
                kept_share=float(sv.keep.float().mean()),
                nan_rows=nan_rows, bit_equal=equal,
                plan=[plan["tile_rows"], plan["chunk"]],
                bound_us=1e3 * bound_ms,
                kernel_us={k: [1e3 * t for t in v]
                           for k, v in kernel.items()},
                tile_us={f"{t}x{ch}": [1e3 * v for v in vs]
                         for (t, ch), vs in sweep.items()})
            med = lambda v: statistics.median(v)
            o, nw = (med(case["kernel_us"][k]) for k in ("old", "new"))
            print(f"{name:10s} x{case['shape']} {case['dtype']:8s} kept "
                  f"{case['kept_share']:.3f} bit-equal {equal}; kernel old "
                  f"{o:7.2f} new {nw:7.2f} us, bound {case['bound_us']:6.2f}"
                  f" us ({o / case['bound_us']:.2f}x -> "
                  f"{nw / case['bound_us']:.2f}x), plan {case['plan']}; "
                  f"tiles " + ", ".join(
                      f"{t}: {med(v):.2f}"
                      for t, v in case["tile_us"].items()), flush=True)
            results.append(case)
            del xp
        del model
        cs._WAYMO_CLOUDS.clear()
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, cases=results), f, indent=1)
    if not all(c["bit_equal"] for c in results):
        print("seg_max_fwd_turns: the kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
