"""Hold K5b (``csrc/seg_full_max_bwd.cu``) against the kernel it replaced, on
one CUDA card:

    python3 scripts/seg_max_bwd_turns.py --against OLD_CHECKOUT \
        [--tiles 64,128,256,512] [--chunks 2,4,8] [--rounds 4] [--json PATH]

``OLD_CHECKOUT`` is a checkout (``git archive`` of a commit) whose
``minddet_tpu_torch/csrc/seg_full_max_bwd.cu`` has the C entry of the
kernel before the tiled design: ``seg_full_max_bwd(x, m, g, first, last,
dx, B, N, C, bound, dtype, wide, stream)``, m the forward's output and g
contiguous. Both sources are built here. On every stream of
``chip_smoke.py``'s phase 3 K5b cases (``seg_bwd_streams``: uniform and
clustered voxelizer streams, f32 and bf16, C = 32 and 18, the strided g of
the main paths' shapes) the two kernels' dx must be bit for bit equal.
Then, in turns (old, new, new, old; ``--rounds`` times), each the median
of 5 windows of 20 back-to-back calls timed with CUDA events:

- the kernels on a contiguous g (each one launch; C = 18 padded to 24
  beforehand);
- at the strided cases, the routes: the old one made the cat's gradient
  slice contiguous and launched the old kernel, the new one is the wrapper
  on the slice as it comes;
- the new kernel at each tile height of ``--tiles`` and each chunk of
  ``--chunks`` 16-byte vectors a block (the wrapper with the plan's
  constants set so that it takes them as they are).

Prints the card's name and power limit first, then one line per case.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="checkout holding the kernel before the redesign")
    ap.add_argument("--tiles", default="64,128,256,512",
                    help="tile heights to time the new kernel at")
    ap.add_argument("--chunks", default="2,4,8",
                    help="vectors a block to time the new kernel at")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--json", help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seg_max_bwd_turns: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import build_centerpoint
    from minddet_tpu_torch.ops import seg_max as sm

    card = cs._card()
    print(card, flush=True)
    _p, _i = ctypes.c_void_p, ctypes.c_int
    old = kernels.CudaKernel(
        "seg_full_max_bwd", "seg_full_max_bwd.cu",
        [_p] * 6 + [_i] * 6 + [_p], replaces="")
    old.source = (Path(args.against) / "minddet_tpu_torch" / "csrc"
                  / "seg_full_max_bwd.cu")
    kernels.build_all([old, kernels.SEG_FULL_MAX, kernels.SEG_FULL_MAX_BWD])
    dev = torch.device("cuda", 0)
    stream = kernels.cuda_stream(dev)
    model = build_centerpoint(dev)
    bound = model.max_points_per_voxel
    shapes = [(int(t), int(c)) for t in args.tiles.split(",")
              for c in args.chunks.split(",")]
    default = (sm.SEG_BWD_TILE, sm.SEG_BWD_CHUNK, sm.SEG_BWD_WORK,
               sm.SEG_SLOTS)
    ms = lambda fn: cs._cuda_ms(fn, iters=20, windows=5)

    def old_bwd(first, last, x, m, g):
        """The old route on padded, contiguous x, m and g."""
        c = x.shape[-1]
        x, m, g = (sm.pad_channels(t.contiguous()) for t in (x, m, g))
        dx = torch.empty_like(x)
        b, n, ch = x.shape
        old.check(old.fn()(
            x.data_ptr(), m.data_ptr(), g.data_ptr(), first.data_ptr(),
            last.data_ptr(), dx.data_ptr(), b, n, ch, bound,
            sm._DTYPE_CODE[x.dtype],
            int(sm.seg_max_plan(b, n, ch, x.dtype)["wide"]), stream))
        return sm.unpad_channels(dx, c)

    results = []
    for b, dtype, kind, c, sv, x, g in cs.seg_bwd_streams(dev, model):
        first, last = sv.first, sv.last
        m = sm.seg_full_max_bounded(first, last, x, bound)
        gc = g.contiguous()
        new = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
        was = old_bwd(first, last, x, m, gc)
        torch.cuda.synchronize()
        equal = torch.equal(new.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32),
                            was.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
        del new, was
        # the kernels alone: inputs padded and contiguous beforehand
        xp, mp, gp = (sm.pad_channels(t) for t in (x, m, gc))
        kernel = _turns({
            "old": lambda: old_bwd(first, last, xp, mp, gp),
            "new": lambda: sm.seg_full_max_bounded_bwd(first, last, xp, mp,
                                                       gp, bound)},
            args.rounds, ms)
        case = dict(shape=[b, first.shape[1], c],
                    dtype=str(dtype).replace("torch.", ""), stream=kind,
                    bit_equal=equal, kernel_us={
                        k: [1e3 * t for t in v] for k, v in kernel.items()})
        if not g.is_contiguous():
            route = _turns({
                "old": lambda: old_bwd(first, last, x, m, g),
                "new": lambda: sm.seg_full_max_bounded_bwd(first, last, x,
                                                           m, g, bound)},
                args.rounds, ms)
            case["route_us"] = {k: [1e3 * t for t in v]
                                for k, v in route.items()}

        def at(tile, chunk):
            def run():
                (sm.SEG_BWD_TILE, sm.SEG_BWD_CHUNK, sm.SEG_BWD_WORK,
                 sm.SEG_SLOTS) = tile, chunk, tile * chunk, 0
                try:
                    sm.seg_full_max_bounded_bwd(first, last, xp, mp, gp,
                                                bound)
                finally:
                    (sm.SEG_BWD_TILE, sm.SEG_BWD_CHUNK, sm.SEG_BWD_WORK,
                     sm.SEG_SLOTS) = default
            return run

        sweep = _turns({tc: at(*tc) for tc in shapes}, args.rounds, ms)
        case["tile_us"] = {f"{t}x{c}": [1e3 * v for v in vs]
                           for (t, c), vs in sweep.items()}
        med = lambda v: statistics.median(v)
        line = (f"{kind:18s} x{case['shape']} {case['dtype']:8s} bit-equal "
                f"{equal}; kernel old {med(case['kernel_us']['old']):7.2f} "
                f"new {med(case['kernel_us']['new']):7.2f} us")
        if "route_us" in case:
            line += (f"; route old {med(case['route_us']['old']):7.2f} new "
                     f"{med(case['route_us']['new']):7.2f} us")
        line += "; tiles " + ", ".join(
            f"{t}: {med(v):.2f}" for t, v in case["tile_us"].items())
        print(line, flush=True)
        results.append(case)
        del xp, mp, gp, m, gc
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, cases=results), f, indent=1)
    if not all(c["bit_equal"] for c in results):
        print("seg_max_bwd_turns: the kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
