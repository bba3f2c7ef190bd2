"""Demo harness: the reference `main()` scene (SURVEY.md C11).

Reproduces the hard-coded 32-object scene of ``Kernel.cu:1003-1218`` —
10x10 surface, one distance + one angle relationship, two clearances,
alternating off-limits rects, harness weights — runs MH suggestions and
prints the resulting poses plus the (real) per-chain cost breakdowns.

Usage: python examples/demo_layout.py [--chains N] [--iters N] [--objects N]
"""

from __future__ import annotations

# script-launch robustness: make the repo root importable even when the
# dev .pth is absent (fresh environments)
import os as _os, sys as _sys
_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _ROOT not in _sys.path:
    _sys.path.insert(0, _ROOT)

import argparse
import time

import jax

from mh_tpu import SamplerConfig, demo_scene, suggest_layouts
from mh_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--objects", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    enable_compile_cache()
    print(f"devices: {jax.devices()}")
    spec = demo_scene(args.objects)
    cfg = SamplerConfig(iterations=args.iters, n_chains=args.chains)

    t0 = time.perf_counter()
    res = suggest_layouts(spec, cfg, key=args.seed)
    dt = time.perf_counter() - t0

    for c in range(args.chains):
        print(f"\nSuggestion {c}  (accept rate {res.accept_rate[c]:.2f})")
        names = type(res).COST_FIELDS
        print("  costs: " + "  ".join(f"{n}={v:.3f}" for n, v in zip(names, res.costs[c])))
        for j in range(min(args.objects, 8)):
            x, y, z, rx, ry, rz = res.points[c, j]
            print(f"  obj[{j}] x,y,z: {x:.3f}, {y:.3f}, {z:.3f}  rot: {rx:.3f}, {ry:.3f}, {rz:.3f}")
        if args.objects > 8:
            print(f"  ... ({args.objects - 8} more objects)")

    total_props = args.chains * args.iters
    print(f"\n{total_props} proposals in {dt:.2f}s (incl. compile) on {jax.devices()[0].platform}")


if __name__ == "__main__":
    main()
