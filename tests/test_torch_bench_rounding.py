"""The port's benchmark line and `cli bench` round their rates as the JAX
package's bench.py (bench.py:270-288) and cli (polardecoding_tpu/cli.py:142)
do: `value`, the four frames/s legs and cli bench's frames_per_sec to one
decimal, the two vs_baseline keys to four.  Runs the plain versions on the
CPU at test_torch_bench.py's smallest settings."""
import json

import pytest

from polardecoding_tpu_torch import bench
from polardecoding_tpu_torch import cli as tcli
from test_torch_bench import CHEAP, _bench_py_keys

RATE_KEYS = ("value", "bp_1024_wave_fps", "bp_1024_fixed100_fps", "scl_fps",
             "scl_1024_l8_fps")
RATIO_KEYS = ("vs_baseline", "vs_baseline_fixed_iters")


def _check_rounding(rec):
    assert set(rec) == _bench_py_keys()
    for k in RATE_KEYS:
        if rec[k] is not None:
            assert isinstance(rec[k], float) and rec[k] == round(rec[k], 1), k
    for k in RATIO_KEYS:
        assert isinstance(rec[k], float) and rec[k] == round(rec[k], 4), k


@pytest.mark.parametrize("wave", [None, 12345.678901])
def test_bench_line_rounds_as_bench_py(wave, monkeypatch, capsys):
    """Every rate of the printed record to one decimal and the baseline
    ratios to four, with the wave leg skipped and with a wave leg (stubbed
    with a rate of many decimals, which then sets value)."""
    argv = CHEAP + ["--skip-wave", "--scl-preset", "SCL_1024_L8"]
    if wave is not None:
        monkeypatch.setattr(bench, "bench_waves", lambda *a, **kw: wave)
        argv = CHEAP + ["--wave-batch", "4"]
    rec = bench.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    _check_rounding(rec)
    if wave is not None:
        assert rec["bp_1024_wave_fps"] == 12345.7
        assert rec["value"] == min(12345.7, rec["scl_fps"])
    assert rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_FRAMES_PER_SEC, 4)


def test_cli_bench_rounds_as_the_jax_cli(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_step", lambda *a, **kw: 4321.98765)
    tcli.main(["bench", "--preset", "BP_128", "--batch", "8", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"preset": "BP_128", "frames_per_sec": 4322.0}


def test_cli_bench_rate_on_cpu_is_rounded(capsys):
    tcli.main(["bench", "--preset", "BP_128", "--batch", "8", "--device", "cpu"])
    fps = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "frames_per_sec"]
    assert fps > 0 and fps == round(fps, 1)
