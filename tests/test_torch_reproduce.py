"""The port's reference-curve reproduction (polardecoding_tpu_torch.reproduce)
against the JAX repository's scripts and package: the four plans equal the
scripts' RUNS / PLANS; a small sweep through the run half on the CPU equals
the JAX package's run_sweep record for record; JAX_CPU_PINS recomputed with
the JAX package (SC_128, BP_128) and with the port (SC_128) at batch 4096;
the report half on hand-made records (z, same counts, the L-monotonicity
line, the curves); and the refusal of any output path in the TPU archive.
"""
import importlib.util
import inspect
import json
import math
import os
import sys

import pytest

from polardecoding_tpu.configs import preset as jpreset
from polardecoding_tpu.parallel.harness import run_sweep as jrun_sweep
from polardecoding_tpu_torch import reproduce as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def scripts():
    """The four JAX scripts as modules, the environment they set on import
    put back."""
    env = dict(os.environ)
    mods = {}
    try:
        for name in ("reproduce_curves", "reproduce_extra", "reproduce_r4",
                     "scl_lsweep"):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(REPO, "scripts", name + ".py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mods


def test_plans_equal_the_scripts(scripts):
    assert R.MAIN == scripts["reproduce_curves"].RUNS
    assert R.EXTRA == scripts["reproduce_extra"].RUNS
    assert R.R4 == scripts["reproduce_r4"].RUNS
    assert R.LSWEEP == scripts["scl_lsweep"].PLANS
    assert f"for L in {R.LSWEEP_LISTS}:" in inspect.getsource(
        scripts["scl_lsweep"].main)
    # every run at batch 4096 into <preset>.json / <preset>_lsweep.json
    assert "batch=4096" in inspect.getsource(scripts["reproduce_curves"].main)
    assert R.BATCH == 4096
    runs = R.plan()
    assert [len([p for r in runs if r.set == s for p in r.snrs])
            for s in R.SETS] == [54, 20, 12, 55]
    assert {r.file for r in runs if r.set == "lsweep"} == {
        f"SCL_{n}_L{L}_lsweep.json" for n in (128, 1024)
        for L in (2, 4, 8, 16, 32)}
    assert [r.preset for r in R.plan(["lsweep"], ncode="128")] == [
        f"SCL_128_L{L}" for L in (2, 4, 8, 16, 32)]
    # --quick: the target x 0.25, at least 25 (reproduce_curves.py:41)
    assert [r.blocks for r in R.plan(["main"], quick=True)] == [
        max(25, int(b * 0.25)) for _, _, b, _ in scripts["reproduce_curves"].RUNS]


def test_pins_cover_the_plans():
    """A pin for every preset of the four plans but BP_128_SPA (held
    statistically: its exp/log1p are each framework's own), at the first
    point of the first plan that holds it."""
    names = {r.preset for r in R.plan()}
    assert set(R.JAX_CPU_PINS) == names - {"BP_128_SPA"}
    pinned = R.pinned_runs()
    assert sorted(r.preset for r in pinned) == sorted(R.JAX_CPU_PINS)
    assert all(r.snrs == [1.0] for r in pinned)
    for name, (errbit, errblock, frames) in R.JAX_CPU_PINS.items():
        assert 0 < errblock <= frames and errbit >= errblock
        assert frames == 4096 or name == "BP_1024_GA"


@pytest.mark.parametrize("name", ["SC_128", "BP_128"])
def test_pins_recomputed_with_jax(name):
    run = next(r for r in R.pinned_runs() if r.preset == name)
    res = jrun_sweep(jpreset(name), batch=4096, snr_points=run.snrs,
                     error_blocks=run.blocks, max_frames=run.cap)
    assert (res[0].errbit, res[0].errblock, res[0].frames) == R.JAX_CPU_PINS[name]


def test_pin_through_the_run_half():
    """SC_128's pinned point through chip_smoke's reproduce_pins phase on
    the CPU (run_presets with the plain versions, which launch nothing;
    the card must give the same counts)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    got = chip_smoke.reproduce_pin_results("cpu", ["SC_128"])
    assert list(got) == ["SC_128"]
    r = got["SC_128"]
    assert r["got"] == r["pin"] == list(R.JAX_CPU_PINS["SC_128"])
    assert r["kernels"] == ["scl_decode", "frame_channel"]
    assert r["launches"] == {}


@pytest.mark.parametrize("name", ["SC_128", "CASCL_128_fag_L8"])
def test_small_sweep_equals_jax(name, tmp_path):
    """A sweep through the run half at batch 64 equals the JAX package's
    run_sweep with the same arguments, record for record (elapsed_s
    aside), and its rerun resumes without running a frame."""
    run = R.Run("extra", name, [1.0], 40, 100_000, f"{name}.json")
    logged = []
    done = R.run_presets([run], str(tmp_path / "port"), device="cpu", batch=64,
                         log=logged.append, commit="test")
    jpath = str(tmp_path / "jax.json")
    want = [r.to_json(jpreset(name).code.num_info) for r in jrun_sweep(
        jpreset(name), batch=64, snr_points=[1.0], error_blocks=40,
        max_frames=100_000, checkpoint_path=jpath)]

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in recs]

    got = done[run.file]["records"]
    assert strip(got) == strip(want)
    assert strip(_read(tmp_path / "port" / run.file)) == strip(_read(jpath))
    assert got[0]["frames"] > 64  # more than one step
    entry = _read(tmp_path / "port" / R.RUNS_FILE)[run.file]
    assert entry["frames"] == got[0]["frames"] and entry["commit"] == "test"
    assert entry["launches"] == {}  # the plain versions launch nothing
    assert any(m.startswith(f"== {name} [extra] done in ") for m in logged)
    assert any(m.startswith("   1.0 dB: ") and m.endswith(" s") for m in logged)
    again = R.run_presets([run], str(tmp_path / "port"), device="cpu", batch=64,
                          log=None, commit="other")
    assert strip(again[run.file]["records"]) == strip(got)
    assert _read(tmp_path / "port" / R.RUNS_FILE)[run.file] == entry


def test_two_proportion_z():
    assert R.two_proportion_z(1743, 4096, 1743, 4096) == 0.0
    p = (30 + 50) / (1000 + 2000)
    want = (0.03 - 0.025) / math.sqrt(p * (1 - p) * (1 / 1000 + 1 / 2000))
    assert R.two_proportion_z(30, 1000, 50, 2000) == pytest.approx(want, rel=1e-12)
    assert R.two_proportion_z(0, 10, 0, 20) == 0.0


def _rec(name, snr, errbit, errblock, frames, elapsed=1.5):
    return {"preset": name, "snr_db": snr, "errbit": errbit,
            "errblock": errblock, "frames": frames, "bler": errblock / frames,
            "ber": 0.0, "seed": 1024, "elapsed_s": elapsed, "pm_ties": 0}


def test_report_only_on_hand_made_records(tmp_path, capsys):
    """--report-only against the archive: SCL_128_L32 at 1.0 dB with the
    archive's counts (z 0, same counts), SCL_128_L2 with others (the z of
    the formula), the L-monotonicity line; then SC_128 for
    REPRODUCTION.md and curves_128.png."""
    arch = next(r for r in _read(os.path.join(R.ARCHIVE, "SCL_128_L2_lsweep.json"))
                if r["snr_db"] == 1.0)
    out = tmp_path / "out"
    out.mkdir()
    l2 = _rec("SCL_128_L2", 1.0, 23000, 1300, 4096)
    l32 = next(r for r in _read(os.path.join(R.ARCHIVE, "SCL_128_L32_lsweep.json"))
               if r["snr_db"] == 1.0)
    _write(out / "SCL_128_L2_lsweep.json", [l2])
    _write(out / "SCL_128_L32_lsweep.json", [l32])
    assert R.main(["--report-only", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "SCL_LSWEEP.md: 2 points, 2 with an archived record" in printed
    text = (out / "SCL_LSWEEP.md").read_text()
    z = R.two_proportion_z(1300, 4096, arch["errblock"], arch["frames"])
    assert (f"| 2 | 1.0 | {1300 / 4096:.4g} | 1300 | 4096 | 1.500 | "
            f"{arch['errblock'] / arch['frames']:.4g} | {arch['errblock']} | "
            f"{z:+.2f} | no |") in text
    assert f"| 32 | 1.0 | {l32['bler']:.4g} | {l32['errblock']} |" in text
    assert f"| +0.00 | yes |" in text
    assert (f"L-monotonicity at 1.0 dB: L32 {l32['bler']:.3e} <= L2 "
            f"{l2['bler']:.3e} (OK)") in text
    assert "the archive's (errbit, errblock, frames) exactly at 1 of 2" in text
    assert not (out / "REPRODUCTION.md").exists()

    _write(out / "SC_128.json", [_rec("SC_128", 1.0, 34537, 1743, 4096)])
    assert R.main(["--report-only", "--out", str(out)]) == 0
    text = (out / "REPRODUCTION.md").read_text()
    assert "| SC_128 | 1.0 | 0.3968 | 1.07 | 0.4255 | 1743 | 4096 |" in text
    assert "| +0.00 | yes |" in text
    assert (out / "curves_128.png").stat().st_size > 0
    assert not (out / "curves_1024.png").exists()


def test_refuses_the_archive(tmp_path):
    """No output path in the archive but results/h100: nothing there is
    read as a finished point, written or touched."""
    before = {f: os.stat(os.path.join(R.ARCHIVE, f)).st_mtime_ns
              for f in os.listdir(R.ARCHIVE)}
    run = next(r for r in R.pinned_runs() if r.preset == "SC_128")
    for out in (R.ARCHIVE, os.path.join(R.ARCHIVE, "hw_queue_r5"),
                os.path.join(R.ARCHIVE, "h100", "..")):
        with pytest.raises(ValueError, match="TPU archive"):
            R.run_presets([run], out, device="cpu", log=None)
        with pytest.raises(ValueError, match="TPU archive"):
            R.write_reports(out)
        assert R.main(["--out", out, "--device", "cpu", "--set", "main"]) == 2
    R.check_out(R.DEFAULT_OUT)
    R.check_out(os.path.join(R.DEFAULT_OUT, "quick"))
    R.check_out(str(tmp_path))
    assert {f: os.stat(os.path.join(R.ARCHIVE, f)).st_mtime_ns
            for f in os.listdir(R.ARCHIVE)} == before
