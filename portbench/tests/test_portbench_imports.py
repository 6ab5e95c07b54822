"""The benchmark loads no JAX and no module of the JAX package, compared by
whole top-level name; its reference loads nothing of the measured program."""
import json
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "polardecoding_tpu"}
MODULES = ["portbench.run", "portbench.cell", "portbench.check", "portbench.context",
           "portbench.control", "portbench.spec", "portbench.tracing",
           "portbench.traffic", "portbench.peaks", "portbench.reference.step",
           "portbench.entry", "portbench.waves", "portbench.wave_check",
           "portbench.reference.bp_es"]


def top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_metrics_load_no_jax():
    code = "\n".join(f"import {m}" for m in MODULES) + (
        "\nfrom portbench.spec import metric_reader, load_json\n"
        "for m in load_json('BENCHMARK.json')['per_layer']: metric_reader(m['name'])\n"
        "from portbench.cell import Program\n"
        "import polardecoding_tpu_torch.parallel.harness\n")
    names = top_level_after(code)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "polardecoding_tpu_torch" in names  # the port, which is allowed


def test_reference_loads_nothing_of_the_program():
    names = top_level_after("import portbench.reference.step, portbench.reference.bp_es")
    assert not names & (FORBIDDEN | {"polardecoding_tpu_torch"})


def test_run_names_the_forbidden_modules_whole():
    from portbench import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    names = ["polardecoding_tpu_torch.parallel.harness", "numpy", "jaxlib.xla_client",
             "polardecoding_tpu.models.bp", "flaxen", "jax"]
    assert run.forbidden_modules(names) == ["jax", "jaxlib", "polardecoding_tpu"]
