"""Profile the chain loop on the device and reduce the trace to metrics.

    python benchmarks/trace_headline.py [--objects 100] [--chains 1024]
        [--iters 200] [--out chiprun_out/trace_headline]

Compiles and warms the plain XLA engine (``run_chains``, what
``suggest_layouts(engine="auto")`` runs on one device), then traces one
call of ``--iters`` MH steps with ``jax.profiler`` and prints one JSON line:

- ``per_step_us_wall``: host wall time of the traced call / iterations;
- ``per_step_us_device``: device window (first event start to last event
  end) / iterations;
- ``events_per_step``: device events (kernels and copies) per MH step;
- ``idle_share``: 1 - (union of device event intervals) / window;
- ``top``: the device events that take the most time, by name.

The reduction reads only the GPU planes of the trace (``/device:GPU:*``)
and their stream lines; a trace without device events is an error.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_events(xplane_path: str) -> list[tuple[str, str, int, int]]:
    """``(line, name, start_ns, end_ns)`` of every event on the stream
    lines of the first GPU plane."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(f"no GPU plane in {xplane_path}: "
                         f"{[p.name for p in pd.planes]}")
    plane = min(planes, key=lambda p: p.name)
    out = []
    for line in plane.lines:
        if "stream" not in line.name.lower():
            continue  # XLA Modules / XLA Ops lines repeat the stream events
        for e in line.events:
            out.append((line.name, e.name, int(e.start_ns), int(e.end_ns)))
    return out


def reduce_events(events, n_steps: int) -> dict:
    """Window, busy union, idle share and per-step counts of device events."""
    if not events:
        raise ValueError("no device events in the trace")
    spans = sorted((s, e) for _, _, s, e in events)
    busy = 0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    by_name = collections.Counter()
    for _, name, s, e in events:
        by_name[name] += e - s
    return {
        "events": len(events),
        "events_per_step": len(events) / n_steps,
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "per_step_us_device": window / n_steps / 1e3,
        "lines": sorted({line for line, _, _, _ in events}),
        "top": [
            {"name": n[:120], "total_ns": t, "share_of_busy": t / busy}
            for n, t in by_name.most_common(12)
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_headline"))
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.sampler.mh import run_chains
    from mh_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    spec = demo_scene(args.objects)
    scene, pose0 = spec.build(), spec.initial_pose()
    cfg = SamplerConfig(iterations=args.iters, n_chains=args.chains)
    key = jax.random.key(0)
    for _ in range(2):
        jax.block_until_ready(run_chains(key, pose0, scene, cfg))

    jax.profiler.start_trace(args.out)
    t0 = time.perf_counter()
    jax.block_until_ready(run_chains(key, pose0, scene, cfg))
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()

    paths = sorted(glob.glob(os.path.join(args.out, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    out = reduce_events(device_events(paths[-1]), args.iters)
    d = jax.devices()[0]
    print(json.dumps({
        "objects": args.objects, "chains": args.chains, "iters": args.iters,
        "platform": d.platform, "device_kind": d.device_kind,
        "per_step_us_wall": wall / args.iters * 1e6, **out,
    }))


if __name__ == "__main__":
    main()
