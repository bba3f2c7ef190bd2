"""Benchmark harness — prints ONE JSON line on stdout (details on stderr).

Headline metric (BASELINE.md config 3/4): MH proposals/s on the 100-object
layout scene, 1024 chains batched on one device, full objective per
proposal.

The parent process never initialises JAX. It runs each measurement in a
child process of its own, one after another, so exactly one process holds
the accelerator at a time; the child prints its result on a protocol line
``@MHBENCH {json}``. Each measurement gets one attempt: a failure is a
fault to see, printed to stderr. A failed headline exits non-zero; a
failed secondary costs only its keys.

Every line names the device it ran on (``platform``, ``device_kind``,
``device_count``) and, where ``nvidia-smi`` exists, the card's name and
power limit.

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
anchor is the *reference-math single-core baseline* — the same objective +
MH loop executed by the straight-Python/NumPy oracle (tests/oracle.py, a
faithful loop-for-loop implementation of Kernel.cu's math). The divisor is
a PINNED calibration constant (below): a live 30-iteration timing swung
1.9x between rounds with machine load, which made vs_baseline noise. A
live re-measurement still runs (CPU subprocess) and is printed to stderr
as a sanity check against calibration rot.

Usage:
  python bench.py                # headline + BASELINE configs 2, 4, 5
  python bench.py --all          # additionally the MC-pi estimator and
                                 # the K=64 block-proposal config
  python bench.py --engine NAME  # child mode: one measurement (internal)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# ---------------------------------------------------------------------------
# Pinned oracle baseline (proposals/s, single-core NumPy, 100 objects).
# Calibration: fixed seed, 200 iterations, median of 5 runs on one idle
# CPU core (24.3, 25.2, 22.2, 20.9 across four idle measurements -> 23).
# Re-calibrate with `python bench.py --engine oracle` on an idle machine;
# the live stderr value drifting >2x from it signals rot.
ORACLE_BASELINE_PROPOSALS_PER_S = 23.0

_PROTO = "@MHBENCH "


# ---------------------------------------------------------------------------
# measurement helpers (run in CHILD processes only)


def _time_best(fn, repeats: int = 4) -> float:
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _per_step_linfit(run, lengths, repeats: int = 6) -> float:
    """Per-step seconds as the slope of min wall time over scan lengths.

    ``run(n)`` must block until the device is done. The slope cancels the
    fixed per-call cost (dispatch, host transfer); three or more lengths
    expose a misfit as a residual instead of folding it into the slope.
    """
    import numpy as np

    mins = {}
    for it in lengths:
        run(it)  # compile/warm
        mins[it] = math.inf
    for _ in range(repeats):
        for it in lengths:
            t0 = time.perf_counter()
            run(it)
            mins[it] = min(mins[it], time.perf_counter() - t0)
    xs = np.array(lengths, float)
    ys = np.array([mins[it] for it in lengths])
    # the floor only guards the downstream division against a <= 0 slope
    # in a noise-dominated fit; it sits far below any real slope
    return max(float(np.polyfit(xs, ys, 1)[0]), 1e-15)


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
    }


def bench_oracle(n_objs: int = 100, iters: int = 200, repeats: int = 5) -> dict:
    """Reference-math MH loop (NumPy oracle) single-core proposals/s.

    Median of ``repeats`` timed runs (fixed seed) — the live counterpart
    of the pinned calibration constant.
    """
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import oracle  # noqa: PLC0415

    from mh_tpu.models.scene import demo_scene  # noqa: PLC0415

    spec = demo_scene(n_objs)

    def one() -> float:
        pose = np.asarray(spec.positions, np.float64).copy()
        rng = np.random.default_rng(0)
        cur = oracle.breakdown(spec, pose, parity=True)["total"]
        t0 = time.perf_counter()
        for _ in range(iters):
            star = pose.copy()
            i = rng.integers(n_objs)
            star[i, 0:2] += rng.normal(size=2) * 10 / 16
            s = oracle.breakdown(spec, star, parity=True)["total"]
            if rng.random() < min(1.0, math.exp(min(2.0 * (s - cur), 0.0))):
                pose, cur = star, s
        return iters / (time.perf_counter() - t0)

    vals = sorted(one() for _ in range(repeats))
    return {
        "proposals_per_s": vals[len(vals) // 2],
        "pinned": ORACLE_BASELINE_PROPOSALS_PER_S,
    }


def bench_layout(n_objs: int, n_chains: int, iterations: int, n_moves: int = 1) -> dict:
    """Steady-state MH throughput (scene-specialized XLA engine) via a
    3-length linearity fit."""
    import jax
    import numpy as np

    from mh_tpu.config import SamplerConfig  # noqa: PLC0415
    from mh_tpu.models.scene import demo_scene  # noqa: PLC0415
    from mh_tpu.sampler.mh import compile_chains  # noqa: PLC0415

    spec = demo_scene(n_objs)
    scene = spec.build()
    key = jax.random.key(0)
    pose0 = spec.initial_pose()
    # the iteration count is a runtime value, so one compile serves all
    # three linearity-fit lengths
    runner = compile_chains(
        scene,
        SamplerConfig(iterations=iterations, n_chains=n_chains,
                      n_moves_per_step=n_moves),
    )

    def run(iters):
        states, _ = runner(key, pose0, iterations=iters)
        return jax.block_until_ready(states)

    short = max(iterations // 10, 1)
    mid = max(iterations // 2, 2)
    per_step = _per_step_linfit(run, (short, mid, iterations))
    states = run(iterations)
    accept_rate = float(np.mean(np.asarray(states.accept_rate)))
    return {
        "proposals_per_s": n_moves * n_chains / per_step,
        "accepted_per_s": n_chains * accept_rate / per_step,
        "accept_rate": accept_rate,
        "per_step_ms": per_step * 1e3,
        **_device_info(),
    }


def bench_pi(n_samples: int = 1 << 28) -> dict:
    import jax

    from mh_tpu.models.pi import estimate_pi  # noqa: PLC0415

    key = jax.random.key(0)

    def run():
        return float(estimate_pi(key, n_samples=n_samples))

    est = run()
    dt = _time_best(run)
    return {"samples_per_s": n_samples / dt, "pi_estimate": est, "wall_s": dt}


def bench_collective(n_objs: int, n_chains: int) -> dict:
    """Config 4: chains + collective psum acceptance adaptation (1 mesh)."""
    import jax
    import numpy as np

    from mh_tpu.config import SamplerConfig  # noqa: PLC0415
    from mh_tpu.models.scene import demo_scene  # noqa: PLC0415
    from mh_tpu.parallel.mesh import chain_mesh  # noqa: PLC0415
    from mh_tpu.parallel.sharded import run_chains_collective  # noqa: PLC0415

    spec = demo_scene(n_objs)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)
    mesh = chain_mesh()
    cfg = SamplerConfig(iterations=0, n_chains=n_chains, adapt_rate=0.1)

    def run(rounds):
        states, rates, _ = run_chains_collective(
            key, pose0, scene, cfg, mesh, rounds=rounds, steps_per_round=10
        )
        return jax.block_until_ready(rates)

    rates = run(12)
    per_step = _per_step_linfit(run, (2, 7, 12), repeats=5) / 10.0
    return {
        "proposals_per_s": n_chains / per_step,
        "final_accept_rate": float(np.asarray(rates)[-1]),
    }


def bench_tempering_smc(n_objs: int = 32, n_replicas: int = 64) -> dict:
    """Config 5: parallel tempering + annealed SMC on the ambient mesh.

    On a single device the mesh has one device (the boundary ppermute is a
    self-loop); the multi-device behaviour is covered by the CPU
    virtual-mesh tests (tests/test_parallel.py).
    """
    import jax
    import numpy as np

    from mh_tpu.config import SamplerConfig  # noqa: PLC0415
    from mh_tpu.models.scene import demo_scene  # noqa: PLC0415
    from mh_tpu.parallel.mesh import chain_mesh  # noqa: PLC0415
    from mh_tpu.sampler.smc import run_smc  # noqa: PLC0415
    from mh_tpu.sampler.tempering import run_tempered  # noqa: PLC0415

    spec = demo_scene(n_objs)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)
    mesh = chain_mesh()
    cfg = SamplerConfig()

    def run_t(rounds):
        states, swaps = run_tempered(
            key, pose0, scene, cfg, mesh, n_replicas,
            exchange_every=5, rounds=rounds,
        )
        return jax.block_until_ready(swaps)

    swaps = np.asarray(run_t(24))
    per_step = _per_step_linfit(run_t, (4, 14, 24), repeats=5) / 5.0

    def run_s():
        states, diag = run_smc(
            key, pose0, scene, cfg, mesh, n_replicas, n_stages=8, mutate_steps=5
        )
        return jax.block_until_ready(diag)

    diag = run_s()
    t_smc = _time_best(run_s, repeats=2)
    return {
        "tempering_sweeps_per_s": n_replicas / per_step,
        "mean_swap_rate": float(swaps.mean()),
        "smc_wall_s": t_smc,
        "smc_log_evidence": float(np.asarray(diag["log_evidence"])),
    }


# ---------------------------------------------------------------------------
# child entry


def _run_child(engine: str, args) -> None:
    """Run one measurement and print its result on a protocol line."""
    if engine == "oracle":
        # pure-NumPy measurement: keep the accelerator free
        os.environ["JAX_PLATFORMS"] = "cpu"
    else:
        from mh_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    if engine == "oracle":
        out = bench_oracle(args.objects)
    elif engine == "xla_headline":
        out = bench_layout(args.objects, args.chains, args.iters)
    elif engine == "pi":
        out = bench_pi()
    elif engine == "layout_small":
        out = bench_layout(10, 1, 2000)
    elif engine == "layout_block":
        out = bench_layout(args.objects, min(args.chains, 256), 500, n_moves=64)
    elif engine == "collective":
        out = bench_collective(args.objects, 1024)
    elif engine == "tempering_smc":
        out = bench_tempering_smc()
    else:
        raise SystemExit(f"unknown engine {engine!r}")
    print(_PROTO + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# parent orchestration (never imports JAX)


def card_info() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them,
    or ``"not available"`` where there is no nvidia-smi or no GPU."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else "not available"


def run_engine(engine: str, args, timeout_s: float = 1500) -> dict | None:
    """Measure one engine in a fresh child process; None on failure."""
    cmd = [
        sys.executable, os.path.abspath(__file__), "--engine", engine,
        "--objects", str(args.objects),
        "--chains", str(args.chains),
        "--iters", str(args.iters),
    ]
    try:
        proc = subprocess.run(
            cmd, timeout=timeout_s, capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired as e:
        print(f"# {engine} FAILED: timeout after {timeout_s:.0f}s; stderr "
              f"tail: {(e.stderr or '')[-900:]}", file=sys.stderr)
        return None
    tail = "\n".join((proc.stderr or "").splitlines()[-12:])
    if proc.returncode == 0:
        for line in (proc.stdout or "").splitlines():
            if line.startswith(_PROTO):
                out = json.loads(line[len(_PROTO):])
                print(f"# {engine}: {json.dumps(out)}", file=sys.stderr)
                return out
    print(f"# {engine} FAILED: rc={proc.returncode}; stderr tail:\n{tail}",
          file=sys.stderr)
    return None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true", help="run all BASELINE configs")
    ap.add_argument("--engine", help="child mode: run ONE measurement")
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args()

    if args.engine:
        _run_child(args.engine, args)
        return

    card = card_info()
    print(f"# card: {card}", file=sys.stderr)
    extras: dict = {}
    if args.all:
        pi = run_engine("pi", args)
        if pi:
            extras["pi_samples_per_s"] = round(pi["samples_per_s"], 0)
        blk = run_engine("layout_block", args)
        if blk:
            extras["block64_proposals_per_s"] = round(blk["proposals_per_s"], 1)

    head = run_engine("xla_headline", args)
    if head is None:
        raise SystemExit("the headline measurement failed")

    # BASELINE measurement configs 2, 4 and 5
    small = run_engine("layout_small", args, timeout_s=900)
    if small:
        extras["single_chain_10obj_proposals_per_s"] = round(
            small["proposals_per_s"], 1
        )
    coll = run_engine("collective", args, timeout_s=1200)
    if coll:
        extras["collective_1024_proposals_per_s"] = round(
            coll["proposals_per_s"], 1
        )
        extras["collective_final_accept_rate"] = round(
            coll["final_accept_rate"], 4
        )
    tsmc = run_engine("tempering_smc", args, timeout_s=1200)
    if tsmc:
        extras["tempering_smc_sweeps_per_s"] = round(
            tsmc["tempering_sweeps_per_s"], 1
        )
        extras["tempering_mean_swap_rate"] = round(tsmc["mean_swap_rate"], 4)

    # live oracle sanity check (CPU subprocess; non-fatal)
    base = ORACLE_BASELINE_PROPOSALS_PER_S
    live = run_engine("oracle", args, timeout_s=420)
    if live:
        print(
            f"# oracle live: {live['proposals_per_s']:.1f} proposals/s "
            f"(pinned {base}, drift x{live['proposals_per_s'] / base:.2f})",
            file=sys.stderr,
        )

    result = {
        "metric": f"mh_proposals_per_s_per_chip_{args.objects}obj_{args.chains}chains",
        "value": round(head["proposals_per_s"], 1),
        "unit": "proposals/s",
        "vs_baseline": round(head["proposals_per_s"] / base, 2),
        "engine": "xla_specialized",
        "per_step_ms": round(head["per_step_ms"], 4),
        "accepted_per_s": round(head["accepted_per_s"], 1),
        "platform": head["platform"],
        "device_kind": head["device_kind"],
        "device_count": head["device_count"],
        "card": card,
        **extras,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
