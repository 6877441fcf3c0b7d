"""How far apart two runs of the CenterNet train CLI end on one CUDA card,
against how far a resumed run ends from a straight one:

    python3 scripts/cli_resume_spread.py [--json PATH] [--steps N]

Runs ``minddet_tpu_torch.train.train.main`` on
``configs/centernet_r18_coco.yaml`` with ``--synthetic`` (512^2, batch 16,
f32) in a temporary workdir: twice for N steps (3 by default), once for
N - 1 steps and then ``--resume`` for one more, and twice for one step.
For each pair (straight vs straight, resumed vs straight, one step vs one
step) and each group of a checkpoint's tensors (the parameters, the BN
statistics, Adam's two moments) it prints the largest absolute difference,
the share of elements more than 1e-6 and 1e-4 apart, and the group's
relative L2 distance. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GROUPS = ("params", "stats", "exp_avg", "exp_avg_sq")


def _group(key: str):
    if key.startswith("model."):
        if "num_batches" in key:
            return None
        return "stats" if "running" in key else "params"
    return next((g for g in ("exp_avg_sq", "exp_avg")
                 if key.endswith("." + g)), None)


def distances(a, b) -> dict:
    """Per group of ``chip_smoke._cli_state_tensors``' entries: max |a -
    b|, the shares of elements more than 1e-6 and 1e-4 apart, and |a - b|
    / |b| over the group (L2, f64)."""
    out = {}
    for g in GROUPS:
        keys = [k for k in b if _group(k) == g]
        diffs = [(a[k].double() - b[k].double()).abs() for k in keys]
        total = sum(d.numel() for d in diffs)
        num = sum(float(d.pow(2).sum()) for d in diffs)
        den = sum(float(b[k].double().pow(2).sum()) for k in keys)
        out[g] = dict(
            max_abs=max(float(d.max()) for d in diffs),
            share_1e6=sum(int((d > 1e-6).sum()) for d in diffs) / total,
            share_1e4=sum(int((d > 1e-4).sum()) for d in diffs) / total,
            rel_l2=(num / max(den, 1e-300)) ** 0.5)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the distances here")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cli_resume_spread: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.train import train

    print(chip_smoke._card(), flush=True)
    torch.zeros(1, device="cuda")
    kernels.build_all(kernels.KERNELS)
    config = str(ROOT / "configs" / "centernet_r18_coco.yaml")
    n = args.steps
    with tempfile.TemporaryDirectory() as tmp:
        def run(work, steps, *extra):
            return chip_smoke._cli_state_tensors(train.main([
                "--config", config, "--synthetic", "--steps", str(steps),
                "--workdir", f"{tmp}/{work}", *extra]))

        first, second = run("a", n), run("b", n)
        run("c", n - 1)
        resumed = run("c", 1, "--resume")
        one_a, one_b = run("d", 1), run("e", 1)
    result = {"straight_vs_straight": distances(second, first),
              "resumed_vs_straight": distances(resumed, first),
              "one_step_vs_one_step": distances(one_b, one_a)}
    for pair, groups in result.items():
        for g, d in groups.items():
            print(f"{pair:22s} {g:10s} max_abs={d['max_abs']:.3e} "
                  f">1e-6: {d['share_1e6']:.4f} >1e-4: {d['share_1e4']:.4f} "
                  f"rel_l2={d['rel_l2']:.3e}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
