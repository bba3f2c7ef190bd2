"""chip_smoke.py's phases at tiny sizes on the CPU, and the whole script
on a GPU where there is one (``gpu`` marker)."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from mh_tpu.config import CostMode, SamplerConfig  # noqa: E402
from mh_tpu.models.scene import demo_scene  # noqa: E402


@pytest.mark.parametrize("serve", [False, True])
def test_main_path_phase_matches_oracle(serve, capsys):
    spec = demo_scene(8)
    cfg = SamplerConfig(iterations=20, n_chains=8, mode=CostMode.PARITY)
    res = chip_smoke.run_layout("tiny", spec, cfg, "not measured", serve=serve)
    assert res.points.shape == (8, 8, 6)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["run"] == "tiny" and line["oracle_chains"] == 16
    assert set(line["oracle_worst_abs_err"]) == set(type(res).COST_FIELDS)


def test_oracle_check_catches_a_wrong_term():
    spec = demo_scene(8)
    cfg = SamplerConfig(iterations=5, n_chains=2)
    res = chip_smoke.run_layout("tiny", spec, cfg, "not measured")
    costs = res.costs.copy()
    costs[1, 4] += 0.5  # symmetry off by far more than the tolerance
    res = dataclasses.replace(res, costs=costs)
    with pytest.raises(chip_smoke.SmokeFailure, match="symmetry"):
        chip_smoke.oracle_errors(spec, res, parity=True)


def test_swap_phase():
    out = chip_smoke.swap_exactness(n_objs=8, n_chains=32)
    assert out["distinct_pairs"] > 0
    assert out["onehot_matmul_rows_inexact"] == 0  # exact on the CPU


def test_cli_phase():
    out = chip_smoke.cli_phase()
    assert out["scene"] == "living_room.json"
    assert out["objects"] > 0


def test_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    """The whole script on the card, from a child process (this one stays
    on the CPU): its last line is the ok record."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is True
    assert lines[-2] == gpu_card


def test_four_card_phase_on_four_virtual_devices():
    """The --four-cards phase, at tiny sizes, on four virtual CPU devices
    (a process of its own: the device count is fixed at start-up)."""
    code = (
        "import sys; sys.path.insert(0, %r); import chip_smoke; "
        "chip_smoke.four_cards('not measured', n_objs=8, n_chains=16, "
        "iters=20, n_replicas=16, big_objs=64)" % REPO
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    runs = [json.loads(l)["run"] for l in proc.stdout.splitlines()]
    assert runs == ["sharded_chains", "collective_psum", "tempering_smc",
                    "objs_sharded"]
