"""Huge-scene layout sampling: shard the O(N^2) objective across devices.

The reference's own README flags quadratic cost growth as its scaling
limit (``/root/reference/Readme.md:6`` — the symmetry and off-limits terms
build N x N matrices, ``Kernel.cu:283-318,485-514``). The answer here is
a 2-D (chains x objs) device mesh: chains stay data-parallel on one axis
while each chain's N x N cost rows are sharded over the other and
psum-reduced across devices every step.

Run on any platform with at least ``--objs-devices`` devices — four GPUs,
or the 8-virtual-device CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/huge_scene.py --objects 2048 --objs-devices 4
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--objs-devices", type=int, default=4)
    args = ap.parse_args()

    import jax

    from mh_tpu.api import suggest_layouts
    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_dev = jax.device_count()
    if n_dev % args.objs_devices:
        raise SystemExit(
            f"--objs-devices {args.objs_devices} does not divide the "
            f"{n_dev} visible devices"
        )
    print(f"{n_dev} {jax.devices()[0].platform} devices; "
          f"{args.objects}-object scene, objective rows sharded over "
          f"{args.objs_devices} of them")

    spec = demo_scene(args.objects)
    cfg = SamplerConfig(iterations=args.iters, n_chains=args.chains)
    t0 = time.time()
    res = suggest_layouts(spec, cfg, key=0, objs_devices=args.objs_devices)
    dt = time.time() - t0
    for c in range(args.chains):
        print(f"chain {c}: total={res.costs[c, 0]:.2f} "
              f"accept_rate={res.accept_rate[c]:.2f}")
    print(f"{args.chains * args.iters} proposals over a "
          f"{args.objects}x{args.objects} objective in {dt:.1f}s "
          f"(incl. compile)")


if __name__ == "__main__":
    main()
