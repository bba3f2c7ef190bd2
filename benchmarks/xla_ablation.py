"""Per-term ablation of the XLA scan engine.

Prices each cost term's share of the XLA specialized scan: each run zeroes one cost-term group at trace time
(``MH_XLA_SKIP`` in mh_tpu/ops/costs.py) in a FRESH subprocess (the knob
is read at import) and re-measures the headline config with bench.py's
3-length linearity fit. Shares = 1 - skip_time/baseline_time.

    python benchmarks/xla_ablation.py [objects] [chains]

Prints one JSON line per variant and a final summary line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROTO = "@MHBENCH "

VARIANTS = ("", "sym", "rel", "vb", "fp", "clr", "sa", "sym,rel,vb,fp,clr,sa")


def run_variant(skip: str, objects: int, chains: int) -> dict | None:
    env = dict(os.environ)
    if skip:
        env["MH_XLA_SKIP"] = skip
    else:
        env.pop("MH_XLA_SKIP", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "bench.py"),
         "--engine", "xla_headline",
         "--objects", str(objects), "--chains", str(chains),
         "--iters", "1000"],
        env=env, capture_output=True, text=True, timeout=1800,
    )
    for line in (proc.stdout or "").splitlines():
        if line.startswith(_PROTO):
            return json.loads(line[len(_PROTO):])
    print(f"# skip={skip!r} FAILED: {(proc.stderr or '')[-400:]}",
          file=sys.stderr)
    return None


def main() -> None:
    objects = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    chains = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    results = {}
    for skip in VARIANTS:
        out = run_variant(skip, objects, chains)
        if out:
            results[skip or "none"] = out["per_step_ms"]
            print(json.dumps({"skip": skip or "none",
                              "per_step_ms": round(out["per_step_ms"], 4)}),
                  flush=True)
    base = results.get("none")
    if base:
        shares = {
            k: round(1.0 - v / base, 3)
            for k, v in results.items() if k != "none"
        }
        print(json.dumps({"baseline_ms": round(base, 4), "shares": shares}))


if __name__ == "__main__":
    main()
