"""Command-line interface: ``python -m mh_tpu <command>``.

The config/flag subsystem the reference lacks (SURVEY.md §5: two POD structs
and unused CLI helpers): scene specs and sampler configs load from JSON
files or flags; results write as JSON.

Commands:
  suggest   run MH layout suggestions on a scene (file or built-in demo)
  demo      run + pretty-print the reference demo scene
  pi        Monte-Carlo pi estimate
  devices   report the JAX device topology (reference C10)
  temper    parallel tempering over the mesh (--adapt-ladder for the
            swap-rate-adaptive ladder)
  smc       annealed SMC over the mesh (--adaptive --init prior for
            ESS-targeted tempering from the beta=0 prior)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_sampler_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--moves-per-step", type=int, default=1)
    p.add_argument(
        "--accept-draws", type=int, default=1,
        help="K independent accept decisions per proposal (Kernel.cu:819 "
             "emulation; set = --moves-per-step for reference-default "
             "blockxDim semantics)",
    )
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--mode", choices=["parity", "fixed"], default="parity")
    p.add_argument("--adapt", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", help="JSON file of SamplerConfig overrides")
    p.add_argument(
        "--log", help="append a structured JSONL event stream here "
                      "(run_config / round / result events; utils/runlog)",
    )
    p.add_argument(
        "--log-every", type=int, default=0,
        help="emit a `round` stats event every N steps (default: "
             "iterations/10 when --log is set; plain XLA engine only)",
    )


def _sampler_config(args):
    from mh_tpu.config import CostMode, SamplerConfig
    from mh_tpu.utils.serialization import sampler_config_from_dict

    if args.config:
        with open(args.config) as f:
            return sampler_config_from_dict(json.load(f))
    return SamplerConfig(
        iterations=args.iters,
        n_chains=args.chains,
        n_moves_per_step=args.moves_per_step,
        accept_draws=args.accept_draws,
        beta=args.beta,
        adapt=args.adapt,
        mode=CostMode(args.mode),
    )


def _log_kwargs(args) -> dict:
    """--log/--log-every -> suggest_layouts logging kwargs.

    With --log but no --log-every, default to ~10 rounds of events.
    """
    if not getattr(args, "log", None):
        return {}
    every = getattr(args, "log_every", 0) or max(args.iters // 10, 1)
    return {"log": args.log, "log_every": every}


def cmd_suggest(args) -> int:
    from mh_tpu.api import suggest_layouts
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.utils.serialization import load_scene

    spec = load_scene(args.scene) if args.scene else demo_scene(args.objects)
    res = suggest_layouts(
        spec, _sampler_config(args), key=args.seed, engine=args.engine,
        serve=args.serve, objs_devices=args.objs_devices,
        **_log_kwargs(args),
    )
    out = {
        "points": np.asarray(res.points, np.float64).tolist(),
        "costs": {
            name: np.asarray(res.costs[:, i], np.float64).tolist()
            for i, name in enumerate(type(res).COST_FIELDS)
        },
        "accept_rate": np.asarray(res.accept_rate, np.float64).tolist(),
    }
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


def cmd_demo(args) -> int:
    from mh_tpu.api import suggest_layouts
    from mh_tpu.models.scene import demo_scene

    spec = demo_scene(args.objects)
    res = suggest_layouts(
        spec, _sampler_config(args), key=args.seed, **_log_kwargs(args)
    )
    for c in range(res.points.shape[0]):
        print(f"Suggestion {c}  (accept rate {res.accept_rate[c]:.2f})")
        print(
            "  costs: "
            + "  ".join(
                f"{n}={v:.3f}" for n, v in zip(type(res).COST_FIELDS, res.costs[c])
            )
        )
    return 0


def cmd_pi(args) -> int:
    import jax

    from mh_tpu.models.pi import estimate_pi

    est = estimate_pi(jax.random.key(args.seed), n_samples=args.samples)
    print(f"pi ~= {float(est):.6f}  ({args.samples} samples)")
    return 0


def cmd_devices(_args) -> int:
    from mh_tpu.parallel.mesh import device_report

    print(device_report())
    return 0


def cmd_temper(args) -> int:
    import jax

    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.mesh import chain_mesh
    from mh_tpu.sampler.tempering import run_tempered
    from mh_tpu.utils.serialization import load_scene

    spec = load_scene(args.scene) if args.scene else demo_scene(args.objects)
    out = run_tempered(
        jax.random.key(args.seed), spec.initial_pose(), spec.build(),
        _sampler_config(args), chain_mesh(), n_replicas=args.replicas,
        exchange_every=args.exchange_every, rounds=args.rounds,
        adapt_ladder=args.adapt_ladder,
    )
    states, swap_rates = out[0], out[1]
    result = {
        "swap_rates": np.asarray(swap_rates, np.float64).tolist(),
        "target_total_cost": float(np.asarray(states.costs.total)[-1]),
    }
    if args.adapt_ladder:
        result["betas"] = np.asarray(out[2], np.float64).tolist()
    if args.log:
        from mh_tpu.utils.runlog import RunLogger

        with RunLogger(args.log) as lg:
            lg.log_config(_sampler_config(args), engine="tempering",
                          n_objs=args.objects, n_chains=args.replicas)
            lg.event("result", engine="tempering", **result)
    print(json.dumps(result))
    return 0


def cmd_smc(args) -> int:
    import jax

    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.mesh import chain_mesh
    from mh_tpu.sampler.smc import run_smc
    from mh_tpu.utils.serialization import load_scene

    spec = load_scene(args.scene) if args.scene else demo_scene(args.objects)
    states, diag = run_smc(
        jax.random.key(args.seed), spec.initial_pose(), spec.build(),
        _sampler_config(args), chain_mesh(), n_particles=args.particles,
        n_stages=args.stages, mutate_steps=args.mutate_steps,
        adaptive=args.adaptive, init=args.init,
    )
    result = {
        "log_evidence": float(diag["log_evidence"]),
        "betas": np.asarray(diag["betas"], np.float64).tolist(),
        "ess": np.asarray(diag["ess"], np.float64).tolist(),
        "resampled": np.asarray(diag["resampled"]).astype(int).tolist(),
        "best_total_cost": float(np.asarray(states.costs.total).max()),
    }
    if args.log:
        from mh_tpu.utils.runlog import RunLogger

        with RunLogger(args.log) as lg:
            lg.log_config(_sampler_config(args), engine="smc",
                          n_objs=args.objects, n_chains=args.particles)
            lg.event("result", engine="smc", **result)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mh_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("suggest", help="run MH layout suggestions")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--out", help="write results JSON here")
    p.add_argument(
        "--engine", default="auto",
        choices=["auto", "xla", "xla_specialized"],
        help="sampling engine (see suggest_layouts)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="scene will be sampled repeatedly: let auto pick the "
             "scene-specialized engine (one compile per scene)",
    )
    p.add_argument(
        "--objs-devices", type=int, default=None,
        help="shard the O(N^2) objective within each chain over this many "
             "devices (huge-scene model parallelism; 2-D chains x objs mesh)",
    )
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_suggest)

    p = sub.add_parser("demo", help="reference demo scene, pretty-printed")
    p.add_argument("--objects", type=int, default=32)
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("pi", help="Monte-Carlo pi estimate")
    p.add_argument("--samples", type=int, default=1 << 22)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_pi)

    p = sub.add_parser("devices", help="device/mesh report")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser("temper", help="parallel tempering over the mesh")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--replicas", type=int, default=16)
    p.add_argument("--exchange-every", type=int, default=5)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--adapt-ladder", action="store_true",
                   help="swap-rate-targeted ladder adaptation")
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_temper)

    p = sub.add_parser("smc", help="annealed SMC over the mesh")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--particles", type=int, default=64)
    p.add_argument("--stages", type=int, default=10)
    p.add_argument("--mutate-steps", type=int, default=5)
    p.add_argument("--adaptive", action="store_true",
                   help="ESS-targeted adaptive tempering")
    p.add_argument("--init", choices=["pose0", "prior"], default="pose0")
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_smc)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
