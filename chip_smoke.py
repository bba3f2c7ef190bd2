"""On-card smoke test: the layout sampler's main path on a GPU, checked.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-cards  # four GPUs: the multi-device phase only

Phases, all in this one process (one process per card):

1. device — JAX must report GPUs; prints the card's name and power limit
   (``nvidia-smi``), the JAX version and the compile-cache directory;
2. main path — the deployments of BASELINE.md through
   ``suggest_layouts(engine="auto")``, each recomputed with the float64
   oracle (``tests/oracle.py``) term by term, with cold and warm wall times;
   the ``serve=True`` run must equal ``engine="xla"`` bitwise;
3. swap exactness — a swap-only step must leave the pose rows an exact
   permutation of the input rows, at coordinates TF32 cannot hold;
4. CLI — ``python -m mh_tpu``'s ``main()`` in this process, ``demo`` and
   ``suggest`` on ``examples/scenes/living_room.json``.

``--four-cards`` runs only the multi-device paths on four GPUs, each
compared with its one-device result: chain sharding (bitwise), the
collective (psum) adaptation, tempering (ppermute) and SMC (all_gather)
(in their statistics; bitwise equality reported), and object-axis
sharding of a 2048-object scene.

Any failed check exits non-zero. The last line of stdout is one JSON
object, ``{"ok": true, "device": {...}}``, printed only when every phase
passed. There is no fallback: no CPU, no interpreter, no fewer devices.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LIVING_ROOM = os.path.join(ROOT, "examples", "scenes", "living_room.json")

# the tolerance tests/test_costs.py holds every term to against the oracle
RTOL, ATOL = 2e-4, 2e-3
ORACLE_CHAINS = 16


class SmokeFailure(Exception):
    """A check failed; the message says which."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 1: device ---------------------------------------------------------


def card_info() -> list[str]:
    """One ``name, power.limit`` line per GPU, as nvidia-smi gives them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e
    lines = [l.strip() for l in proc.stdout.splitlines() if l.strip()]
    check(proc.returncode == 0 and bool(lines),
          f"nvidia-smi rc={proc.returncode}: {proc.stderr.strip()}")
    return lines


def require_gpus(count: int):
    """The first ``count`` GPUs, or a failure (never a CPU fallback)."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (default platform {devs[0].platform!r})")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    return devs[:count]


def import_program():
    """Import the package that sits beside this script, and only that."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import mh_tpu

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(mh_tpu.__file__)))
    check(pkg_root == ROOT,
          f"mh_tpu imported from {pkg_root}, not from beside this script")
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # the float64 oracle


# --- phase 2: main path ------------------------------------------------------


def oracle_errors(spec, res, parity: bool, n_chains: int = ORACLE_CHAINS) -> dict:
    """Compare every cost term of the first ``n_chains`` results with the
    float64 oracle on the returned poses; returns the worst error per term."""
    import numpy as np
    import oracle

    fields = type(res).COST_FIELDS
    worst = {k: 0.0 for k in fields}
    for c in range(min(n_chains, res.points.shape[0])):
        want = oracle.breakdown(spec, np.asarray(res.points[c], np.float64),
                                parity=parity)
        for i, k in enumerate(fields):
            got = float(res.costs[c, i])
            err = abs(got - want[k])
            check(err <= ATOL + RTOL * abs(want[k]),
                  f"chain {c} term {k}: engine {got!r} vs oracle {want[k]!r}")
            worst[k] = max(worst[k], err)
    return worst


def run_layout(name: str, spec, cfg, card: str, serve: bool = False,
               engine: str = "auto"):
    """One ``suggest_layouts`` deployment: cold + warm call, output checks,
    the oracle comparison; returns the warm result."""
    import numpy as np

    from mh_tpu.api import suggest_layouts
    from mh_tpu.config import CostMode

    t0 = time.perf_counter()
    cold = suggest_layouts(spec, cfg, key=0, engine=engine, serve=serve)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = suggest_layouts(spec, cfg, key=0, engine=engine, serve=serve)
    warm_s = time.perf_counter() - t0

    n = spec.n_objs
    check(res.points.shape == (cfg.n_chains, n, 6), f"{name}: points shape")
    check(res.costs.shape == (cfg.n_chains, 8), f"{name}: costs shape")
    check(bool(np.isfinite(res.points).all()), f"{name}: non-finite poses")
    check(bool(np.isfinite(res.costs).all()), f"{name}: non-finite costs")
    check(bool(np.isfinite(res.accept_rate).all()), f"{name}: non-finite accept_rate")
    check(np.array_equal(cold.points, res.points), f"{name}: not deterministic")
    worst = oracle_errors(spec, res, parity=cfg.mode is CostMode.PARITY)
    log(json.dumps({
        "run": name, "objects": n, "chains": cfg.n_chains,
        "iterations": cfg.iterations, "mode": cfg.mode.name, "serve": serve,
        "engine": engine, "cold_wall_s": cold_s, "warm_wall_s": warm_s,
        "warm_per_step_ms": warm_s / cfg.iterations * 1e3,
        "mean_accept_rate": float(np.mean(res.accept_rate)),
        "oracle_chains": ORACLE_CHAINS,
        "oracle_worst_abs_err": worst, "card": card,
    }))
    return res


def main_path(card: str) -> None:
    import dataclasses

    import numpy as np

    from mh_tpu.config import CostMode, SamplerConfig
    from mh_tpu.models.scene import demo_scene

    parity = CostMode.PARITY
    runs = [
        # (name, scene, chains, iterations, mode, serve)
        ("reference_harness", demo_scene(32), 64, 100, parity, False),
        ("headline", demo_scene(100), 1024, 1000, parity, False),
        ("large_scene", demo_scene(256), 1024, 200, parity, False),
        ("weighted_fixed",
         dataclasses.replace(demo_scene(100), w_offlimits=1.0),
         1024, 200, CostMode.FIXED, False),
        ("serve", demo_scene(100), 1024, 200, parity, True),
    ]
    for name, spec, chains, iters, mode, serve in runs:
        cfg = SamplerConfig(iterations=iters, n_chains=chains, mode=mode)
        res = run_layout(name, spec, cfg, card, serve=serve)
        if serve:
            ref = run_layout("serve_vs_xla", spec, cfg, card, engine="xla")
            for f in ("points", "costs", "accept_rate", "step_scale"):
                check(np.array_equal(getattr(res, f), getattr(ref, f)),
                      f"serve=True differs from engine='xla' in {f}")
            log("serve=True (xla_specialized) == engine='xla': bitwise equal")


# --- phase 3: swap exactness -------------------------------------------------


def hard_pose(n: int):
    """f32[n, 6] coordinates with full 24-bit mantissas (TF32 keeps 10)."""
    import numpy as np

    base = 1.2345678 + 0.0123456789 * np.arange(n * 6, dtype=np.float64)
    return np.asarray(base.reshape(n, 6) * (1 + np.arange(n)[:, None]), np.float32)


def swap_exactness(n_objs: int = 100, n_chains: int = 1024, seed: int = 0) -> dict:
    """A swap-only step, through ``_apply_move`` and through the
    incremental engine's proposal, vmapped over ``n_chains`` random pairs:
    every output must be the input with exactly rows (i, j) exchanged."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.sampler import incremental
    from mh_tpu.sampler.proposal import _apply_move

    scene = demo_scene(n_objs).build()
    n = scene.n_pad_objs
    pose = hard_pose(n)
    rng = np.random.default_rng(seed)
    i1 = rng.integers(0, n_objs, n_chains)
    i2 = rng.integers(0, n_objs, n_chains)
    eye = np.eye(n, dtype=np.float32)
    cfg = SamplerConfig()

    def expected(a, b):
        out = np.repeat(pose[None], len(a), axis=0)
        rows = np.arange(len(a))
        out[rows, a], out[rows, b] = pose[b], pose[a]
        return out

    step = jax.jit(jax.vmap(lambda s1, s2: _apply_move(
        jnp.asarray(pose), scene, cfg, jnp.float32(1.0), jnp.int32(2), s1, s2,
        jnp.zeros((3,), jnp.float32),
    )))
    got = np.asarray(step(eye[i1], eye[i2]))
    check(np.array_equal(got, expected(i1, i2)),
          "swap via _apply_move is not an exact row permutation")

    # incremental engine: u[0] in [2/3, 1) selects the swap move
    u = rng.uniform(0.0, 1.0, (n_chains, 8)).astype(np.float32)
    u[:, 0] = 0.9
    inc = jax.jit(jax.vmap(lambda uu: incremental._propose_with_info(
        uu, jnp.asarray(pose), scene, cfg)))
    star, k1, k2 = (np.asarray(x) for x in inc(jnp.asarray(u)))
    check(np.array_equal(star, expected(k1, k2)),
          "swap via the incremental proposal is not an exact row permutation")

    # diagnostic only: the one-hot product this replaced, at default precision
    prod = np.asarray(jax.jit(jax.vmap(lambda s: s @ jnp.asarray(pose)))(eye[i1]))
    return {
        "chains": n_chains, "objects": n_objs,
        "distinct_pairs": int(np.sum(i1 != i2)),
        "onehot_matmul_rows_inexact": int(np.sum(np.any(prod != pose[i1], axis=1))),
    }


# --- phase 4: CLI ------------------------------------------------------------


def cli_phase() -> dict:
    """``python -m mh_tpu`` demo + suggest, in this process."""
    import numpy as np

    from mh_tpu.cli import main
    from mh_tpu.config import CostMode, SamplerConfig
    from mh_tpu.api import LayoutResult
    from mh_tpu.utils.serialization import load_scene

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["demo", "--chains", "4", "--iters", "100"])
    check(rc == 0 and "Suggestion 3" in buf.getvalue(), "CLI demo failed")

    chains = 8
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["suggest", "--scene", LIVING_ROOM, "--chains", str(chains),
                   "--iters", "100"])
    check(rc == 0, f"CLI suggest rc={rc}")
    out = json.loads(buf.getvalue())
    spec = load_scene(LIVING_ROOM)
    points = np.asarray(out["points"], np.float32)
    costs = np.stack([np.asarray(out["costs"][k], np.float32)
                      for k in LayoutResult.COST_FIELDS], axis=1)
    check(points.shape == (chains, spec.n_objs, 6), "CLI suggest points shape")
    check(bool(np.isfinite(costs).all()), "CLI suggest: non-finite costs")
    res = LayoutResult(points=points, costs=costs,
                       accept_rate=np.asarray(out["accept_rate"]),
                       step_scale=np.ones(chains))
    default_mode = SamplerConfig().mode
    worst = oracle_errors(spec, res, parity=default_mode is CostMode.PARITY)
    return {"scene": os.path.basename(LIVING_ROOM), "objects": spec.n_objs,
            "oracle_worst_abs_err": worst}


# --- --four-cards ------------------------------------------------------------


def four_cards(card: str, n_objs: int = 100, n_chains: int = 1024,
               iters: int = 1000, n_replicas: int = 64,
               big_objs: int = 2048) -> None:
    """The multi-device paths on four devices, each against one device."""
    import jax
    import numpy as np

    from mh_tpu.api import suggest_layouts
    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.mesh import chain_mesh
    from mh_tpu.parallel.objshard import chain_obj_mesh
    from mh_tpu.parallel.sharded import run_chains_collective
    from mh_tpu.sampler.smc import run_smc
    from mh_tpu.sampler.tempering import run_tempered

    check(jax.device_count() == 4,
          f"need exactly 4 devices, JAX sees {jax.device_count()}")
    spec = demo_scene(n_objs)
    scene, pose0 = spec.build(), spec.initial_pose()
    key = jax.random.key(0)

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    # chain sharding: the default mesh over all four cards vs one card
    cfg = SamplerConfig(iterations=iters, n_chains=n_chains)
    r4, t4 = timed(lambda: suggest_layouts(spec, cfg, key=0))
    r1, t1 = timed(lambda: suggest_layouts(spec, cfg, key=0, mesh=chain_mesh(1)))
    for f in ("points", "costs", "accept_rate", "step_scale"):
        check(np.array_equal(getattr(r4, f), getattr(r1, f)),
              f"4-card suggest_layouts differs from 1 card in {f}")
    log(json.dumps({"run": "sharded_chains", "objects": n_objs,
                    "chains": n_chains, "iterations": iters,
                    "bitwise_equal_1_card": True,
                    "wall_s_4_cards_cold": t4, "wall_s_1_card_cold": t1,
                    "card": card}))

    # The collective samplers reduce across devices (psum, ppermute,
    # all_gather), so a device count may change a float by an ulp and a
    # near-tie accept with it: their results must agree with one card in
    # their statistics; whether they also agree bitwise is reported.
    def same(a, b):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))

    ccfg = SamplerConfig(iterations=0, n_chains=n_chains, adapt_rate=0.1)
    s4, rates4, _ = run_chains_collective(
        key, pose0, scene, ccfg, chain_mesh(4), rounds=10, steps_per_round=10)
    s1, rates1, _ = run_chains_collective(
        key, pose0, scene, ccfg, chain_mesh(1), rounds=10, steps_per_round=10)
    check(bool(np.isfinite(np.asarray(s4.costs.total)).all()),
          "collective: non-finite costs")
    np.testing.assert_allclose(np.asarray(rates4), np.asarray(rates1), atol=1e-2)
    log(json.dumps({"run": "collective_psum", "chains": n_chains,
                    "bitwise_equal_1_card": same(s4.pose, s1.pose),
                    "max_rate_diff": float(np.abs(np.asarray(rates4) - np.asarray(rates1)).max()),
                    "final_accept_rate": float(np.asarray(rates4)[-1])}))

    tcfg = SamplerConfig(iterations=0)
    st4, sw4 = run_tempered(key, pose0, scene, tcfg, chain_mesh(4),
                            n_replicas=n_replicas, exchange_every=5, rounds=20)
    st1, sw1 = run_tempered(key, pose0, scene, tcfg, chain_mesh(1),
                            n_replicas=n_replicas, exchange_every=5, rounds=20)
    check(bool(np.isfinite(np.asarray(st4.costs.total)).all()),
          "tempering: non-finite costs")
    np.testing.assert_allclose(np.mean(np.asarray(sw4)), np.mean(np.asarray(sw1)),
                               atol=5e-2)
    sm4, d4 = run_smc(key, pose0, scene, tcfg, chain_mesh(4),
                      n_particles=n_replicas, n_stages=8, mutate_steps=5)
    sm1, d1 = run_smc(key, pose0, scene, tcfg, chain_mesh(1),
                      n_particles=n_replicas, n_stages=8, mutate_steps=5)
    check(bool(np.isfinite(float(d4["log_evidence"]))), "SMC: non-finite evidence")
    np.testing.assert_allclose(float(d4["log_evidence"]),
                               float(d1["log_evidence"]), rtol=1e-3)
    log(json.dumps({"run": "tempering_smc", "replicas": n_replicas,
                    "tempering_bitwise_equal_1_card": same(st4.pose, st1.pose),
                    "smc_bitwise_equal_1_card": same(sm4.pose, sm1.pose),
                    "mean_swap_rate": [float(np.mean(np.asarray(sw4))),
                                       float(np.mean(np.asarray(sw1)))],
                    "smc_log_evidence": [float(d4["log_evidence"]),
                                         float(d1["log_evidence"])]}))

    # object-axis sharding of a 2048-object scene
    big = demo_scene(big_objs)
    bcfg = SamplerConfig(iterations=10, n_chains=4)
    ro, to = timed(lambda: suggest_layouts(big, bcfg, key=1, objs_devices=4))
    rm = suggest_layouts(big, bcfg, key=1, mesh=chain_obj_mesh(1, 4))
    check(np.array_equal(ro.points, rm.points) and np.array_equal(ro.costs, rm.costs),
          "objs_devices=4 differs from the explicit chain_obj_mesh(1, 4)")
    ru = suggest_layouts(big, bcfg, key=1, mesh=chain_mesh(1))
    check(np.array_equal(ro.accept_rate, ru.accept_rate),
          "objs-sharded accept decisions differ from the unsharded run")
    np.testing.assert_allclose(ro.costs, ru.costs, rtol=1e-4, atol=1e-2)
    log(json.dumps({"run": "objs_sharded", "objects": big_objs, "objs_devices": 4,
                    "bitwise_equal_explicit_mesh": True,
                    "matches_unsharded": True, "wall_s_cold": to}))


# --- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phase, on four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    try:
        import jax

        devs = require_gpus(count)
        import_program()
        from mh_tpu.utils.compile_cache import enable_compile_cache

        cache = enable_compile_cache()
        cards = card_info()
        card = cards[0]
        for line in cards:
            log(f"card: {line}")
        log(f"jax {jax.__version__}; devices {[d.device_kind for d in devs]}; "
            f"compile cache {cache}")
        if args.four_cards:
            four_cards(card)
        else:
            main_path(card)
            log("swap: " + json.dumps(swap_exactness()))
            log("cli: " + json.dumps(cli_phase()))
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(card)  # nvidia-smi's own line, just before the result
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
