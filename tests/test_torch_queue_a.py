"""ROADMAP queue A's drivers (the ab_chkfast study and scripts/torch_*.py:
verify_drive, bench_scl, ab_r1, bench_wave, ab_wavecheck) against the JAX
repository's scripts and TPU logs, without running JAX: each driver's
constants equal its script's (read with ast); every TPU log they are held
against or cite reads into the rows each arm uses; the verdict rule and z
on hand-made numbers; each driver on the CPU at tiny settings (its
constants patched) exits 0 and writes the script's keys; without a card
each exits 2 and writes nothing; QUEUE_A.md from hand-made records.
"""
import ast
import importlib.util
import json
import math
import os

import pytest
import torch

from polardecoding_tpu_torch import studies as S
from polardecoding_tpu_torch.studies import _common, ab_chkfast, queue_a

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain decoders run thousands of small tensor operations, for which
    intra-op threads cost far more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def _script(name):
    """scripts/<name>.py as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(tree):
    """{--flag: its default} of every add_argument call with a flag."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument" and isinstance(node.args[0], ast.Constant)
                and node.args[0].value.startswith("--")):
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (ast.literal_eval(kw["default"])
                                       if "default" in kw else None)
    return out


def _assigned(tree, name, kind=ast.Assign):
    """The literal values assigned to `name` (Assign or AugAssign), in order;
    an `a if c else b` gives (a, b), `int(x) if c else d` gives d."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, kind):
            continue
        targets = node.targets if kind is ast.Assign else [node.target]
        if any(getattr(t, "id", None) == name for t in targets):
            v = node.value
            if isinstance(v, ast.IfExp):
                try:
                    out.append((ast.literal_eval(v.body), ast.literal_eval(v.orelse)))
                except ValueError:
                    out.append(ast.literal_eval(v.orelse))
            else:
                out.append(ast.literal_eval(v))
    return out


def _calls(tree, func):
    """(positional constants, {keyword: its source}) of every call of func."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and func in (
                getattr(node.func, "id", None), getattr(node.func, "attr", None)):
            out.append(([a.value for a in node.args if isinstance(a, ast.Constant)],
                        {k.arg: ast.unparse(k.value) for k in node.keywords}))
    return out


def _defaults(tree, func):
    """{argument: default} of a function definition."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            args = node.args.args[len(node.args.args) - len(node.args.defaults):]
            return {a.arg: ast.literal_eval(d)
                    for a, d in zip(args, node.args.defaults)}
    raise KeyError(func)


def _env(tree):
    return {n.args[0].value: n.args[1].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "get"
            and ast.unparse(n.func.value) == "os.environ" and len(n.args) == 2}


def test_ab_chkfast_constants_equal_the_script():
    t = _tree("scripts/ab_chkfast.py")
    assert _flags(t) == {"--perf": None, "--bler": None,
                         "--bler-snr": ab_chkfast.BLER_SNR,
                         "--error-blocks": ab_chkfast.ERROR_BLOCKS}
    assert _defaults(t, "bler_ab") == {"error_blocks": ab_chkfast.ERROR_BLOCKS,
                                       "max_frames": ab_chkfast.MAX_FRAMES}
    src = ast.unparse(t)
    assert f"for base in {ab_chkfast.BASES!r}".replace("'", '"') in src.replace(
        "'", '"')
    assert src.count(f"range({ab_chkfast.PERF_REPS})") == 2
    assert f'register_fast_twin({ab_chkfast.PERF_PRESET!r})'.replace(
        "'", '"') in src.replace("'", '"')
    port = _tree("polardecoding_tpu_torch/studies/ab_chkfast.py")
    for func, n in (("bench_step", "iters"), ("bench_waves", "steps")):
        (pos, kw), = _calls(t, func)
        assert pos == [ab_chkfast.PERF_BATCH, ab_chkfast.PERF_SNR]
        (_, mine), = _calls(port, func)
        assert mine["warmup"] == kw["warmup"]
        assert int(kw[n]) == (ab_chkfast.FIXED_ITERS if n == "iters"
                              else ab_chkfast.WAVE_STEPS)
    args = S.parser().parse_args(["--study", "ab_chkfast"])
    assert ab_chkfast.main_args(args) == dict(perf=True, bler=False, bler_snr=4.0,
                                              error_blocks=1000, batch=None)
    args = S.parser().parse_args(["--bler"])
    assert ab_chkfast.main_args(args)["perf"] is False
    assert S.STUDIES["ab_chkfast"] is ab_chkfast


def test_verify_drive_constants_equal_the_script():
    t = _tree("scripts/verify_drive.py")
    v = _script("torch_verify_drive")
    assert _assigned(t, "CHECKS") == [v.CHECKS]
    assert _assigned(t, "CHECKS", ast.AugAssign) == [v.FULL_CHECKS]
    assert f"min({v.BATCH}, frames)" in ast.unparse(t)
    (_, kw), = _calls(t, "run_point")
    assert eval(kw["error_blocks"]) == v.ERROR_BLOCKS
    assert set(v.JAX_CPU) == {c[0] for c in v.CHECKS}
    for name, snr, frames, _, _ in v.CHECKS:
        assert v.JAX_CPU[name][2] == frames


def test_scl_drivers_constants_equal_the_scripts():
    t = _tree("scripts/bench_scl.py")
    b = _script("torch_bench_scl")
    assert _assigned(t, "grid") == [(b.QUICK_GRID, b.GRID)]
    assert _defaults(t, "bench_kernel") == {"snr": b.SNR, "iters": b.ITERS,
                                            "warmup": b.WARMUP}
    full = [(pos[0], pos[1], pos[2], int(kw["iters"]), int(kw["warmup"]))
            for pos, kw in _calls(t, "bench_step")]
    assert full == [tuple(f) for f in b.FULL_MC]
    assert _flags(t) == {"--quick": None}
    t = _tree("scripts/ab_r1.py")
    r = _script("torch_ab_r1")
    assert tuple(_assigned(t, n)[0] for n in ("N", "L", "B", "iters", "reps")) \
        == r.DEFAULTS
    assert _env(t) == {"PD_R1S": r.R1S}
    assert _assigned(t, "sub") == [r.PARITY_FRAMES]
    assert all(kw.get("wloop") == str(r.WLOOP) for _, kw in
               _calls(t, "scl_decode_fast"))
    assert queue_a.R1_LOGS == {(1024, 8, 8192): "hw_queue_r4/step17.log",
                               (128, 8, 16384): "hw_queue_r4/step20.log",
                               (1024, 16, 8192): "hw_queue_r4/step22.log",
                               (1024, 32, 4096): "hw_queue_r4/step23.log"}


def test_wave_drivers_constants_equal_the_scripts():
    t = _tree("scripts/bench_wave.py")
    w = _script("torch_bench_wave")
    assert _flags(t) == {"--snr": w.SNR, "--quick": None, "--ab-fused": None,
                         "--reps": w.REPS, "--retune": None}
    grids = _assigned(t, "grid")
    assert len(grids) == 3 and all(g in grids for g in (
        (w.RETUNE_QUICK_GRID, w.RETUNE_GRID), (w.AB_QUICK_GRID, w.AB_GRID),
        (w.QUICK_GRID, w.GRID)))
    for pos, kw in _calls(t, "bench_waves"):
        assert (int(kw["steps"]), int(kw["warmup"])) == (w.STEPS, w.WARMUP)
    assert {c[0][0] for c in _calls(t, "bench_waves")} == {
        w.RETUNE_PRESET, w.WAVE_PRESET}
    (pos, kw), = _calls(t, "bench_step")
    assert (pos[0], pos[1], int(kw["iters"]), int(kw["warmup"])) == w.PLAIN
    t = _tree("scripts/ab_wavecheck.py")
    c = _script("torch_ab_wavecheck")
    assert tuple(_assigned(t, n)[0] for n in ("B", "steps", "reps", "snr", "K")) \
        == c.DEFAULTS
    assert _assigned(t, "CES") == [c.CES]
    assert _env(t) == {"PD_WAVE_PRESET": c.PRESET}
    assert f"range({c.WARMUP_STEPS})" in ast.unparse(t)


def test_every_log_reads_into_its_rows():
    """step4 into A1's four arms and two verdicts; the three verify runs into
    the same four rows; step7 into the SCL grid's (N, L); each r1 log into
    its parity line and both variants at its (N, L, B); the wave logs into
    their summary lines."""
    arms = {(n, 4.0): ab_chkfast.tpu_row(preset=n, snr_db=4.0) for n in (
        "BP_128", "BP_128_FASTCHK", "BP_1024", "BP_1024_FASTCHK")}
    assert {k[0]: (v["errblock"], v["frames"]) for k, v in arms.items()} == {
        "BP_128": (1021, 550043), "BP_128_FASTCHK": (1019, 550057),
        "BP_1024": (932, 30006424), "BP_1024_FASTCHK": (924, 30006326)}
    assert all(v["file"] == "results/hw_queue_r2/step4.log" for v in arms.values())
    assert [ab_chkfast.tpu_row(N=n)["verdict"] for n in (128, 1024)] == ["OK", "OK"]
    assert ab_chkfast.tpu_row(preset="BP_128", snr_db=2.0) is None
    rows = [queue_a.verify_rows(p) for p in queue_a.VERIFY_LOGS]
    assert rows[0] == rows[1] == rows[2]
    tpu = queue_a.verify_tpu()
    assert {k: (v["errblock"], v["frames"], v["ok"]) for k, v in tpu.items()} == {
        "BP_128": (3809, 32768, True), "SC_128": (787, 32768, True),
        "SCL_128_L8": (933, 16384, True), "CASCL_128_L8": (637, 16384, True)}
    v = _script("torch_verify_drive")
    for name, snr, frames, want, tol in v.CHECKS:
        assert (tpu[name]["snr_db"], tpu[name]["frames"]) == (snr, frames)
        assert tpu[name]["bler"] == round(tpu[name]["errblock"] / frames, 5)
    step7 = _common.read_log(queue_a.SCL_LOG).records
    b = _script("torch_bench_scl")
    assert [(r["N"], r["L"]) for r in step7 if "kernel_fps" in r] == [
        (n, L) for n, L, _ in b.GRID]
    assert [r.get("preset", "SCL_1024_L8") for r in step7
            if "full_mc_fps" in r] == [f[0] for f in b.FULL_MC]
    for (N, L, B), path in queue_a.R1_LOGS.items():
        recs = _common.read_log(path).records
        parity = _common.find(recs, parity="hw_r1_4_vs_numpy_twin")
        assert parity["bits_equal"] and parity["pm_equal"] and parity["ties_equal"]
        assert [r["variant"] for r in recs if r.get("B") == B and r["N"] == N
                and r["L"] == L and "best_fps" in r] == ["r1_0", "r1_4"]
    ab = [r for r in _common.read_log(queue_a.WAVE_LOGS["ab-fused"]).records
          if r["engine"] == "wave-AB"]
    w = _script("torch_bench_wave")
    assert [(r["batch"], r["wave_iters"]) for r in ab] == w.AB_GRID
    retune = _common.read_log(queue_a.WAVE_LOGS["retune"]).records
    assert [(r["batch"], r["wave_iters"]) for r in retune
            if r.get("rep") == 0] == w.RETUNE_GRID
    assert retune[-1]["engine"] == "wave-retune-best"
    ces = _common.read_log(queue_a.WAVECHECK_LOG).records
    c = _script("torch_ab_wavecheck")
    assert [r["variant"] for r in ces if "best_retired_fps" in r] == [
        f"ce{x}" for x in c.CES]
    assert {(r["preset"], r["B"], r["K"]) for r in ces} == {
        (c.PRESET, c.DEFAULTS[0], c.DEFAULTS[4])}


def test_verdict_and_z_equal_the_scripts_formula():
    """The TPU's own step4 arms give its verdict lines to their printed
    digits; z is the pooled two-proportion z."""
    for base, fast, N in (("BP_128", "BP_128_FASTCHK", 128),
                          ("BP_1024", "BP_1024_FASTCHK", 1024)):
        a, b = (ab_chkfast.tpu_row(preset=n, snr_db=4.0) for n in (base, fast))
        ratio, three, word = ab_chkfast.verdict(a, b)
        t = ab_chkfast.tpu_row(N=N)
        assert (round(ratio, 4), round(three, 4), word) == (
            t["bler_ratio_fast/def"], t["3sigma"], t["verdict"])
    base = {"bler": 0.01, "errblock": 50}
    assert ab_chkfast.verdict(base, {"bler": 0.0126, "errblock": 63})[2] == "OK"
    assert ab_chkfast.verdict(base, {"bler": 0.0161, "errblock": 80})[2] == \
        "DIVERGES"  # |0.61| >= 3 sqrt(2 / 50) = 0.6
    e1, n1, e2, n2 = 30, 1000, 50, 2000
    p = (e1 + e2) / (n1 + n2)
    want = (e1 / n1 - e2 / n2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    assert _common.z_against(e1, n1, {"errblock": e2, "frames": n2}) == \
        pytest.approx(want, rel=1e-12)


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_scl_drivers_on_the_cpu(tmp_path, monkeypatch):
    b = _script("torch_bench_scl")
    monkeypatch.setattr(b, "GRID", [(128, 2, 4), (128, 1, 4)])
    monkeypatch.setattr(b, "QUICK_GRID", [(128, 2, 4)])
    monkeypatch.setattr(b, "ITERS", 1)
    monkeypatch.setattr(b, "WARMUP", 0)
    monkeypatch.setattr(b, "FULL_MC", [("SCL_128_L2", 4, 2.0, 1, 0),
                                       ("CASCL_128_L8", 4, 2.0, 1, 0)])
    out = str(tmp_path)
    assert b.main(["--device", "cpu", "--out", out, "--commit", "t"]) == 0
    assert b.main(["--device", "cpu", "--quick", "--out", out]) == 0
    lines = _lines(tmp_path / "scl_grid.jsonl")
    assert [(x.get("N"), x.get("L"), x.get("preset")) for x in lines] == [
        (128, 2, None), (128, 1, None), (128, 2, None), (None, None, "CASCL_128_L8"),
        (128, 2, None), (128, 2, None)]
    assert all(x["kernel_fps"] > 0 for x in lines if "kernel_fps" in x)
    assert all(x["full_mc_fps"] > 0 for x in lines if "full_mc_fps" in x)
    assert all(x["card"] == "cpu (plain versions)" and x["launches"] == {}
               for x in lines)
    r = _script("torch_ab_r1")
    assert r.main(["32", "4", "8", "1", "2", "--r1s", "0,2", "--device", "cpu",
                   "--out", out]) == 0
    lines = _lines(tmp_path / "r1_ab.jsonl")
    assert [next(k for k in ("compile_plus_first_s", "parity", "best_fps")
                 if k in x) for x in lines] == ["compile_plus_first_s"] * 2 + [
        "parity"] * 2 + ["best_fps"] * 2
    assert all(x["bits_equal"] and x["pm_equal"] and x["ties_equal"]
               for x in lines[2:4])
    assert [(x["variant"], x["scank"], len(x["reps"]), x["r1s"])
            for x in lines[4:]] == [("r1_0", 1, 2, [0, 2]), ("r1_2", 1, 2, [0, 2])]


def test_ab_r1_times_nothing_when_a_variant_differs(tmp_path, monkeypatch, capsys):
    """A parity line that does not hold stops the run before any timing,
    exit 1."""
    from polardecoding_tpu_torch.models import scl

    r = _script("torch_ab_r1")
    auto = scl.scl_decode_auto

    def off_by_one(*a, **k):
        u, pm, ties = auto(*a, **k)
        return u, pm + 1, ties

    monkeypatch.setattr(scl, "scl_decode_auto", off_by_one)
    assert r.main(["16", "2", "4", "1", "1", "--r1s", "0", "--device", "cpu",
                   "--out", str(tmp_path)]) == 1
    lines = _lines(tmp_path / "r1_ab.jsonl")
    assert [x.get("pm_equal") for x in lines] == [None, False]
    assert "nothing timed" in capsys.readouterr().err


def test_wave_drivers_on_the_cpu(tmp_path, monkeypatch):
    w = _script("torch_bench_wave")
    for name, value in (("STEPS", 1), ("WARMUP", 0), ("PLAIN", ("BP_128", 8, 1, 0)),
                        ("WAVE_PRESET", "BP_128"), ("RETUNE_PRESET", "BP_128_FASTCHK"),
                        ("GRID", [(8, 4)]), ("AB_GRID", [(8, 4)]),
                        ("RETUNE_GRID", [(8, 8), (8, 4)])):
        monkeypatch.setattr(w, name, value)
    out = str(tmp_path)
    for argv in ([], ["--ab-fused", "--reps", "1"], ["--retune", "--reps", "1"]):
        assert w.main(["--device", "cpu", "--out", out, *argv]) == 0
    lines = _lines(tmp_path / "wave_sweep.jsonl")
    assert [(x["mode"], x["engine"]) for x in lines] == [
        ("default", "plain100"), ("default", "wave"),
        ("ab-fused", "wave"), ("ab-fused", "wave"), ("ab-fused", "wave-AB")] + [
        ("retune", "wave-retune")] * 2 + [("retune", "wave-retune-best")]
    assert lines[1]["x_plain"] == lines[1]["fps"] / lines[0]["fps"]
    assert [x["fused"] for x in lines[2:4]] == [False, True]
    assert lines[4]["fused_x"] == lines[4]["best_fused"] / lines[4]["best_unfused"]
    assert lines[-1]["fps"] == max(x["fps"] for x in lines[5:7])
    c = _script("torch_ab_wavecheck")
    assert c.main(["8", "1", "2", "2.0", "4", "--preset", "BP_128_FASTCHK",
                   "--device", "cpu", "--out", out]) == 0
    lines = _lines(tmp_path / "wavecheck.jsonl")
    assert [x["variant"] for x in lines] == [f"ce{x}" for x in c.CES] * 2
    assert all(len(x["reps"]) == 2 and 0 <= x["window_bler"] <= 1
               for x in lines[4:])


def test_verify_drive_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Checks that pass (exit 0, VERIFY PASS) and one outside its tolerance
    (exit 1, VERIFY FAIL naming it), decoded at 64 frames; then every check
    at its frames with run_point stood in for by the JAX package's counts:
    the script's lines, and the TPU's and the JAX package's counts compared
    where the setting is theirs."""
    v = _script("torch_verify_drive")
    monkeypatch.setattr(v, "CHECKS", [("SC_128", 3.0, 64, 0.02098, 0.2)])
    monkeypatch.setattr(v, "FULL_CHECKS", [("SC_1024", 2.0, 64, 0.09009, 0.2)])
    assert v.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "devices: cpu (plain versions)"
    assert text[1].startswith("SC_128           @3.0dB: bler=0.0") and text[
        1].endswith("(+-0.2) frames=64 [" + text[1].split("[")[1])
    assert text[-2:] == ["probes ok", "VERIFY PASS"]
    lines = _lines(tmp_path / "verify_drive.jsonl")
    assert [x.get("check") for x in lines] == ["SC_128", "SC_1024", None, None]
    assert lines[0]["tpu"] is None and lines[0]["jax_cpu"] is None
    assert lines[2]["bp_all_frozen_zero"] and lines[2]["sc_zero_llr_zero"]
    assert lines[3]["verify"] == "PASS" and lines[3]["checks"] == 2
    monkeypatch.setattr(v, "CHECKS", [("SC_128", 3.0, 32768, 0.5, 0.01)])
    assert v.main(["--device", "cpu", "--fast", "--max-frames", "64",
                   "--out", str(tmp_path)]) == 1
    text = capsys.readouterr().out.splitlines()
    assert text[-1] == "VERIFY FAIL: ['SC_128']" and text[1].endswith("FAIL")
    last = _lines(tmp_path / "verify_drive.jsonl")[-1]
    assert (last["verify"], last["max_frames"], last["fast"]) == ("FAIL", 64, True)

    from polardecoding_tpu_torch.parallel import harness

    v = _script("torch_verify_drive")
    blocks = {c[0]: round(c[3] * c[2]) for c in v.FULL_CHECKS}

    def counts(p, snr, batch, device, error_blocks, max_frames):
        errbit, errblock, frames, ties = v.JAX_CPU.get(
            p.name, (0, blocks.get(p.name), max_frames, 0))
        assert (batch, error_blocks, frames) == (min(4096, max_frames), 10**9,
                                                 max_frames)
        return harness.PointResult(p.name, snr, errbit, errblock, frames,
                                   p.sweep.seed, pm_ties=ties)

    monkeypatch.setattr(harness, "run_point", counts)
    out = tmp_path / "all"
    assert v.main(["--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out.splitlines()
    assert [t.split()[0] for t in text[1:9]] == [c[0] for c in v.CHECKS
                                                 + v.FULL_CHECKS]
    assert text[1].startswith("BP_128           @2.0dB: bler=0.11700 "
                              "want~0.11270 (+-0.012) frames=32768 [")
    lines = _lines(out / "verify_drive.jsonl")[:8]
    assert [(x["same_as_jax_cpu"], x["same_as_tpu"]) for x in lines] == [
        (True, False), (True, True), (True, True), (True, True)] + [(None, None)] * 4
    assert lines[0]["tpu"]["errblock"] == 3809 and lines[2]["pm_ties"] == 1


def test_ab_chkfast_on_the_cpu(tmp_path, monkeypatch):
    """--bler through the studies' command line at one error block on BP_128
    (the arms, the verdict, STUDIES.md's section); --perf's calls and ratios
    with the benchmark entries stood in for."""
    monkeypatch.setattr(ab_chkfast, "BASES", ("BP_128",))
    out = str(tmp_path)
    assert S.main(["--study", "ab_chkfast", "--bler", "--bler-snr", "2.0",
                   "--error-blocks", "1", "--batch", "8", "--device", "cpu",
                   "--out", out, "--commit", "t"]) == 0
    lines = _lines(tmp_path / ab_chkfast.FILE)
    assert [x.get("preset", x.get("N")) for x in lines] == [
        "BP_128", "BP_128_FASTCHK", 128]
    for x in lines[:2]:
        assert x["errblock"] >= 1 and x["batch"] == 8 and x["snr_db"] == 2.0
        assert x["tpu"] is None and x["z"] is None
    assert lines[2]["verdict"] == "OK" and lines[2]["tpu"] is None
    calls = []

    def bench(kind):
        def run(name, batch, snr, **kw):
            calls.append((kind, name, batch, snr, kw.get("iters", kw.get("steps")),
                          kw["warmup"]))
            return {"BP_1024": 100.0, "BP_1024_FASTCHK": 125.0}[name] * (
                2 if kind == "wave" else 1)
        return run

    from polardecoding_tpu_torch import bench as tb

    monkeypatch.setattr(tb, "bench_step", bench("fixed"))
    monkeypatch.setattr(tb, "bench_waves", bench("wave"))
    assert S.main(["--study", "ab_chkfast", "--device", "cpu", "--out", out]) == 0
    perf = _lines(tmp_path / ab_chkfast.FILE)[-1]
    assert (perf["fixed_x"], perf["wave_x"]) == (1.25, 1.25)
    assert perf["AB"] == {"BP_1024": 100.0, "BP_1024_FASTCHK": 125.0,
                          "wave_BP_1024": 200.0, "wave_BP_1024_FASTCHK": 250.0}
    assert calls == [("fixed", n, 8192, 2.0, 5, 2 if r == 0 else 1)
                     for r in range(3) for n in ("BP_1024", "BP_1024_FASTCHK")] + [
        ("wave", n, 8192, 2.0, 16, 4 if r == 0 else 2)
        for r in range(3) for n in ("BP_1024", "BP_1024_FASTCHK")]
    assert len(perf["runs"]) == 12
    text = (tmp_path / "STUDIES.md").read_text()
    assert "## ab_chkfast: the fast CHK flavor against the default" in text
    assert "fixed_x 1.2500, wave_x 1.2500" in text
    assert "| BP_128_FASTCHK | 2.0 | 8 | " in text


@pytest.mark.parametrize("script", ["torch_verify_drive", "torch_bench_scl",
                                    "torch_ab_r1", "torch_bench_wave",
                                    "torch_ab_wavecheck"])
def test_drivers_refuse_without_a_card_or_in_the_archive(script, tmp_path, capsys):
    """Without --device cpu and without a card a driver returns 2 and writes
    nothing; an --out in the TPU archive is refused the same way."""
    mod = _script(script)
    if not torch.cuda.is_available():
        assert mod.main(["--out", str(tmp_path)]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    assert mod.main(["--device", "cpu", "--out", _common.ARCHIVE]) == 2
    assert "TPU archive" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_queue_a_report_on_hand_made_records(tmp_path, capsys):
    """QUEUE_A.md from hand-made lines: the last line of each configuration,
    the card, no TPU rate; a failed verify check, a failed run and a parity
    line that differs named."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "commit": "abc"}

    def write(name, lines):
        with open(tmp_path / queue_a.FILES[name], "w") as f:
            for x in lines:
                f.write(json.dumps(dict(x, **card)) + "\n")

    check = dict(check="BP_128", snr_db=2.0, frames=32768, errblock=3834,
                 errbit=62468, pm_ties=0, bler=3834 / 32768, want=0.1127, tol=0.012,
                 ok=True, fps=1.0, seconds=0.5, batch=4096,
                 launches={"bp_decode": 8, "frame_channel": 8},
                 jax_cpu=[62468, 3834, 32768, 0], same_as_jax_cpu=True,
                 tpu=queue_a.verify_tpu()["BP_128"], same_as_tpu=False)
    write("verify_drive", [
        dict(check, bler=0.5, ok=False), check,
        dict(check="SC_1024", snr_db=2.0, frames=64, errblock=60, errbit=9,
             pm_ties=0, bler=0.9375, want=0.09009, tol=0.01, ok=False, fps=1.0,
             seconds=0.1, batch=64, launches={}, jax_cpu=None,
             same_as_jax_cpu=None, tpu=None, same_as_tpu=None),
        dict(bp_all_frozen_zero=True, sc_zero_llr_zero=True, probes="ok",
             launches={"bp_decode": 1, "scl_decode": 1}),
        dict(verify="FAIL", failures=["SC_1024"], fast=False, checks=2,
             max_frames=64)])
    best = dict(N=1024, L=8, B=8192, scank=1, reps=[1.0], ms_per_call=2.0,
                iters=24, r1s=[0, 4], launches={"scl_decode": 25})
    parity = dict(parity="kernel_r1_4_vs_plain", variant="r1_4", N=1024, L=8,
                  B=8192, frames=64, bits_equal=True, pm_equal=False,
                  ties_equal=True, r1s=[0, 4], launches={"scl_decode_r1": 1})
    write("ab_r1", [parity, dict(best, variant="r1_0", best_fps=100.0),
                    dict(best, variant="r1_4", best_fps=135.0,
                         launches={"scl_decode_r1": 25})])
    assert S.main(["--report-only", "--out", str(tmp_path)]) == 0
    assert "QUEUE_A.md: 3 checks failed" in capsys.readouterr().out
    text = (tmp_path / queue_a.REPORT).read_text()
    assert "Card (nvidia-smi name, power.limit): NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert ("| BP_128 | 2.0 | 32768 | 3834 | 0.11700 | 0.1127 | 0.012 | OK | 0.500 | "
            "bp_decode 8, frame_channel 8 | 3834 | yes | 3809 | no |") in text
    assert "| BP_128 | 2.0 | 32768 | 3834 | 0.50000" not in text
    assert ("| 1024 | 8 | 8192 | 0,4 | r1_4 | 135.0 | 2.0000 | 1.3500 | no | "
            "scl_decode_r1 25 | results/hw_queue_r4/step17.log |") in text
    assert "- FAILED: verify_drive SC_1024: BLER 0.93750 outside 0.09009 +- 0.01" in text
    assert "- FAILED: verify_drive: VERIFY FAIL ['SC_1024']" in text
    assert ("- FAILED: ab_r1 r1_4 at N=1024, L=8, B=8192: kernel differs from "
            "its plain version") in text
    assert "Every record's launches summed: bp_decode 17, frame_channel 16, " \
           "scl_decode 26, scl_decode_r1 26." in text
    assert "fps]" not in text and "4145" not in text


@pytest.mark.cuda
def test_mc_tf_words_and_steps_on_card_equal_cpu():
    """On a card: the MC engine's threefry words (the plain random_bits,
    integer operations only) equal the CPU's, and so do three steps'
    counters of make_wave_step_mc(noise="threefry") at BP_1024_FASTCHK, K=32,
    cadence 2 (bler_wavemc's mc-tf arm): the card decodes the frames that
    the CPU, and so the JAX package's engine off the TPU, decodes (the words
    are jax.random.bits', tests/test_torch_ops.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import frame_keys, prng_key, random_bits
    from polardecoding_tpu_torch.parallel.harness import make_wave_step_mc

    keys = frame_keys(prng_key(1024), torch.arange(512))
    assert torch.equal(random_bits(keys.cuda(), 4096).cpu(), random_bits(keys, 4096))
    p, sigma, got = preset("BP_1024_FASTCHK"), 10.0 ** (-2.0 / 20.0), {}
    for dev in ("cuda", "cpu"):
        init, step, _ = make_wave_step_mc(p, 256, 32, dev, noise="threefry",
                                          cadence=2)
        key = prng_key(p.sweep.seed, dev)
        carry, got[dev] = init(key, 0, sigma), []
        for _ in range(3):
            carry, out = step(key, sigma, carry)
            got[dev].append([int(o) for o in out])
    assert got["cuda"] == got["cpu"] and got["cpu"][-1][2] > 0


def test_check_cadence_changes_the_early_stop_decisions():
    """What differs between the MC wave engine (a G-matrix check every
    `cadence` = 2 iterations) and the fused engine at check_every 0 (a check
    at each K=8 wave's end), whose BLERs differ at 3.5 dB (bler_wavemc,
    results/h100/mctf3000/): BP that latches a frame at its first passing
    check decides some frames otherwise when it checks every iteration than
    when it checks every 8, on the same LLRs.  BP_128's code at 1.5 dB, 128
    frames of the all-zero codeword: one frame is decided right when checked
    every iteration and wrong when checked every 8 iterations, none the
    other way."""
    import numpy as np

    from polardecoding_tpu_torch.models.bp import bp_decode
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    sigma = 10.0 ** (-1.5 / 20.0)
    y = 1.0 + sigma * np.random.default_rng(0).normal(size=(128, 128))
    llr = torch.as_tensor((2.0 * y / sigma**2).astype(np.float32))
    fr = torch.as_tensor(frozen_mask(128, 64))
    wrong = [(bp_decode(llr, fr, 100, early_stop_every=e) != 0).any(1)
             for e in (1, 8)]
    assert (int(wrong[0].sum()), int(wrong[1].sum())) == (25, 26)
    assert int((wrong[1] & ~wrong[0]).sum()) == 1
    assert int((wrong[0] & ~wrong[1]).sum()) == 0
