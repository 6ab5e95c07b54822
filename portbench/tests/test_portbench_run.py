"""A run's outer behaviour: no card, no program, the result line's keys,
and a CPU run of a test-size cell through the whole harness."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.tests.conftest import ROOT, make_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "card", "compared"]


def run_cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "bp_1024.short", "--seed", "3000000001",
                           "--seconds", "1", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    import torch

    out = run_cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    if not torch.cuda.is_available():
        assert out.returncode == 2 and "CUDA card" in out.stderr


def test_with_only_the_benchmark_it_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path, "--trace", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("config", ["cascl_128_l8", "bp_128"])
def test_a_cpu_run_prints_the_contracts_keys(config, trace):
    from portbench.run import run_cell

    cell = make_cell(config)
    out = run_cell(cell, 2**31 + 17, 0.5, trace, "cpu", time.perf_counter())
    json.dumps(out)
    assert list(out) == KEYS[:3] + (["breakdown"] if trace else []) + KEYS[3:]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in out["compared"].values())
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert "frame_step.host_ms" in out["metrics"]
        # no device ran: no device metric is read, none is made up
        assert not any(k.endswith("_pct") for k in out["metrics"])
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(out["metrics"]) == {"frames_per_s", "point_s_p95", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_the_same_seed_does_the_same_work():
    from portbench.cell import Program
    from portbench.traffic import Traffic

    cell = make_cell("cascl_128_l8")
    prog = Program(cell.config, cell.traffic["batch"], "cpu")
    runs = []
    for seed in (5, 5, 6):
        w = prog.window(Traffic(cell.traffic, seed), 0.3)
        runs.append(([p.plan.seed for p in w.points], w.counts()))
    n = min(len(r[0]) for r in runs[:2])
    assert runs[0][0][:n] == runs[1][0][:n]
    assert runs[0][0][:6] != runs[2][0][:6]


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct(cuda_card):
    from portbench.run import run_cell
    from portbench.spec import load_cell

    out = run_cell(load_cell("bp_1024.short"), 2**31 + 3, 2.0, False, cuda_card,
                   time.perf_counter())
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["metrics"]["frames_per_s"]["value"] > 0
