"""The port's benchmark entry points on the CPU, where they run the plain
versions: bench_step and bench_waves at tiny sizes, bench.main's JSON line
with exactly the JAX package's bench.py keys, `cli bench`, and the options
that have no counterpart on the card."""
import ast
import json
import os
import subprocess
import sys

import pytest

from polardecoding_tpu_torch import bench
from polardecoding_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cheapest legs: plain versions at batch 2, one step, no warmup
CHEAP = ["--device", "cpu", "--bp-batch", "2", "--scl-batch", "2",
         "--iters", "1", "--warmup", "0"]


def _bench_py_keys():
    """The keys of the record bench.py prints (bench.py:266-289), read from
    its source: the dict literal assigned to `rec` in main()."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py builds no `rec`")


@pytest.mark.parametrize("name,batch,kw", [
    ("BP_128", 8, {}), ("SCL_128_L8", 4, {}),
    ("BP_128", 8, {"channel": "mc"}), ("SCL_128_L8_FASTR1", 4, {})])
def test_bench_step_on_cpu(name, batch, kw):
    fps = bench.bench_step(name, batch, iters=1, warmup=1, device="cpu", **kw)
    assert fps > 0


@pytest.mark.parametrize("kw", [
    {"engine": "fused"}, {"engine": "fused", "fused": False},
    {"engine": "mc", "wave_iters": 32, "cadence": 2},
    {"engine": "fused", "itermax": 16}])
def test_bench_waves_on_cpu(kw):
    fps = bench.bench_waves("BP_128", 8, steps=2, warmup=1, steps_per_call=2,
                            device="cpu", **kw)
    assert fps > 0


def test_bench_main_prints_bench_py_keys(capsys):
    rec = bench.main(CHEAP + ["--skip-wave", "--scl-preset", "SCL_1024_L8"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rec
    assert set(rec) == _bench_py_keys()
    assert rec["bp_1024_wave_fps"] is None and rec["wave_engine"] is None
    assert rec["scl_fps"] == rec["scl_1024_l8_fps"] > 0
    assert rec["value"] == min(rec["bp_1024_fixed100_fps"], rec["scl_fps"])
    assert "cpu" in rec["metric"]


def test_bench_main_value_is_the_worse_of_wave_and_scl(monkeypatch, capsys):
    """With the wave leg, value is min(wave leg, SCL leg), not the fixed BP
    leg; the wave leg is stubbed (its own test runs it)."""
    seen = {}

    def waves(*args, **kw):
        seen.update(kw, preset=args[0], batch=args[1])
        return 1.0

    monkeypatch.setattr(bench, "bench_waves", waves)
    rec = bench.main(CHEAP + ["--wave-batch", "4"])
    assert set(rec) == _bench_py_keys()
    assert rec["bp_1024_wave_fps"] == 1.0 and rec["value"] == 1.0
    assert rec["wave_preset"] == "BP_1024_FASTCHK" and rec["wave_engine"] == "mc"
    assert rec["wave_itermax"] == 100
    assert seen["preset"] == "BP_1024_FASTCHK" and seen["batch"] == 4
    assert (seen["wave_iters"], seen["cadence"], seen["noise"]) == (32, 2,
                                                                    "kernel")
    assert rec["scl_preset"] == "SCL_1024_L8_FASTR1"
    assert rec["scl_fps"] > 0 and rec["scl_1024_l8_fps"] > 0


def test_cli_bench_prints_preset_and_rate(capsys):
    tcli.main(["bench", "--preset", "BP_128", "--batch", "8", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"preset", "frames_per_sec"}
    assert out["preset"] == "BP_128" and out["frames_per_sec"] > 0


@pytest.mark.parametrize("argv", [["--prng", "rbg"], ["--wave-noise", "hw"],
                                  []])
def test_bench_refuses_tpu_only_options_and_a_missing_card(argv, capsys):
    """rbg and hw name the TPU's hardware generators; with no card and no
    --device cpu there is nothing to measure.  Each exits non-zero with a
    message before running a leg."""
    import torch

    if not argv and torch.cuda.is_available():
        pytest.skip("a card is present")
    if argv:
        argv = argv + ["--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert ("TPU" in err) if argv else ("no CUDA device" in err)


def test_bench_waves_refuses_hw_noise():
    with pytest.raises(ValueError, match="hardware"):
        bench.bench_waves("BP_128", 8, engine="mc", noise="hw", device="cpu")


_NO_JAX = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "polardecoding_tpu"):
            raise ImportError("the benchmark imported " + name)
        return None

for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
from polardecoding_tpu_torch import bench
bench.main(["--device", "cpu", "--prng", "rbg"])
"""


def test_bench_imports_no_jax():
    """The benchmark module loads and parses its options with JAX and the
    JAX package refused (it exits 2 on the TPU-only option)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    assert "TPU" in out.stderr and "ImportError" not in out.stderr
