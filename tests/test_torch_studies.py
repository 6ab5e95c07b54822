"""The port's hardware studies (polardecoding_tpu_torch.studies) against the
JAX repository's scripts and records, without running JAX: each study's
defaults equal its script's constants (read from scripts/*.py with ast);
the reader of the TPU logs on every archived log the studies hold
themselves against; the records' resume (an arm's checkpoint, a finished
arm not run again); the refusal of any output path in the TPU archive;
--report-only on hand-made records; the command line without a card.
"""
import ast
import json
import os

import pytest

from polardecoding_tpu_torch import studies as S
from polardecoding_tpu_torch.studies import (
    _common,
    bf16_study,
    bler_r1,
    bler_wavemc,
    es_sanity_hw,
    scl_parity_hw,
    tie_impact_study,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(name):
    with open(os.path.join(REPO, "scripts", name + ".py")) as f:
        return ast.parse(f.read())


def _flags(tree):
    """{--flag: its default} of every add_argument call."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flag = node.args[0].value
            out[flag] = (ast.literal_eval(kw["default"]) if "default" in kw
                         else None)
    return out


def _env(tree):
    """{VAR: default} of every os.environ.get(VAR, default)."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "get"
                and ast.unparse(node.func.value) == "os.environ"
                and len(node.args) == 2):
            out[node.args[0].value] = node.args[1].value
    return out


def _assigned(tree, name):
    """The value first assigned to `name`: a literal, int() of one allowed."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return eval(compile(ast.Expression(node.value), "<script>", "eval"),
                        {"__builtins__": {}, "int": int})
    raise KeyError(name)


def _calls(tree, func):
    """The keyword literals of every call of `func` (a name or attribute)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and func in (
                getattr(node.func, "id", None), getattr(node.func, "attr", None)):
            out.append({k.arg: ast.literal_eval(k.value) for k in node.keywords
                        if isinstance(k.value, ast.Constant)})
    return out


def _for_targets(tree):
    """The literal iterables of every `for` loop."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            try:
                out.append(ast.literal_eval(node.iter))
            except ValueError:
                pass
    return out


def test_bler_r1_defaults_equal_the_script():
    t = _tree("bler_r1")
    assert bler_r1.CASES == _assigned(t, "CASES")
    assert _flags(t) == {"--error-blocks": bler_r1.ERROR_BLOCKS, "--r1": bler_r1.R1}
    assert {"batch": bler_r1.BATCH} in [{k: v for k, v in c.items() if k == "batch"}
                                        for c in _calls(t, "run_point")]
    assert bler_r1.parse_cases("A:1.5:10,B:2:20") == [("A", 1.5, 10), ("B", 2.0, 20)]
    args = S.parser().parse_args([])
    assert bler_r1.main_args(args) == dict(cases=bler_r1.CASES, error_blocks=1000,
                                           r1=4)


def test_bler_wavemc_defaults_equal_the_script():
    t = _tree("bler_wavemc")
    env = _env(t)
    assert env == {"PD_SNRS": "2.0,3.5", "PD_PRESET": "BP_1024_FASTCHK",
                   "PD_ENGINES": "fused,mc,mc-tf", "PD_BATCH": "16384",
                   "PD_MC_K": "8", "PD_MC_CADENCE": "1", "PD_FUSED_K": "8"}
    assert bler_wavemc.main_args(S.parser().parse_args([])) == dict(
        snrs=[float(s) for s in env["PD_SNRS"].split(",")],
        preset_name=env["PD_PRESET"], engines=env["PD_ENGINES"].split(","),
        batch=int(env["PD_BATCH"]), mc_k=int(env["PD_MC_K"]),
        mc_cadence=int(env["PD_MC_CADENCE"]), fused_k=int(env["PD_FUSED_K"]),
        error_blocks=_flags(t)["--error-blocks"],
        max_frames=_flags(t)["--max-frames"])


def test_wavemc_engine_names_as_the_script():
    from polardecoding_tpu_torch.configs import preset

    p = preset("BP_1024_FASTCHK")
    assert bler_wavemc.engine_args("fused", p, 32, 2, 8) == (p, 8, {"engine": "fused"})
    assert bler_wavemc.engine_args("mc", p, 32, 2, 8) == (
        p, 32, {"engine": "mc", "noise": "kernel", "cadence": 2})
    assert bler_wavemc.engine_args("mc-tf", p, 32, 2, 8)[2]["noise"] == "threefry"
    assert bler_wavemc.engine_args("mc-c4", p, 32, 2, 8)[2]["cadence"] == 4
    q, k, kw = bler_wavemc.engine_args("mc-i40", p, 32, 2, 8)
    assert (q.name, q.decoder.bp_iters, k, kw["engine"]) == (
        "BP_1024_FASTCHK_I40", 40, 32, "mc")
    with pytest.raises(ValueError):
        bler_wavemc.engine_args("hw", p, 32, 2, 8)


def test_parity_and_es_defaults_equal_the_scripts():
    t = _tree("scl_parity_hw")
    assert _flags(t) == {"--frames": scl_parity_hw.FRAMES, "--flavors": None,
                         "--flavors-only": None}
    loops = _for_targets(t)
    assert scl_parity_hw.CODES in loops and scl_parity_hw.LISTS in loops
    assert {"r1": scl_parity_hw.FLAVOR_R1, "list_size": 8,
            "wloop": scl_parity_hw.FLAVOR_WLOOP} in _calls(t, "scl_decode_fast")
    src = ast.unparse(t)
    assert f"min(args.frames, {scl_parity_hw.FLAVOR_FRAMES})" in src
    t = _tree("es_sanity_hw")
    assert _flags(t) == {"--frames": es_sanity_hw.FRAMES, "--snr": es_sanity_hw.SNR}
    assert es_sanity_hw.PRESETS in _for_targets(t)
    assert {"iters": es_sanity_hw.ITERS,
            "early_stop_every": es_sanity_hw.EARLY_STOP_EVERY} in _calls(t, "bp_decode")


def test_tie_and_bf16_defaults_equal_the_scripts():
    t = _tree("tie_impact_study")
    assert _flags(t) == {"--frames": tie_impact_study.FRAMES,
                         "--snr": tie_impact_study.SNR,
                         "--batch": tie_impact_study.BATCH}
    assert f'preset({tie_impact_study.PRESET!r})'.replace("'", '"') in ast.unparse(
        t).replace("'", '"')
    t = _tree("bf16_study")
    assert _flags(t) == {"--blocks": bf16_study.BLOCKS, "--quick": None}
    assert bf16_study.POINTS == [tuple(p) for p in _assigned(t, "points")]
    assert f"100 if args.quick" in ast.unparse(t) and bf16_study.QUICK_BLOCKS == 100
    args = S.parser().parse_args(["--quick"])
    assert bf16_study.main_args(args) == dict(blocks=1000, quick=True)


def test_reader_on_every_archived_log():
    """Each TPU log the studies read: its WARNING: and === lines dropped,
    its sections kept, its JSON records in order, its other lines apart."""
    logs = {bler_r1.TPU_LOG: (9, []), bler_wavemc.STEP7: (4, []),
            bler_wavemc.STEP8: (3, []), bler_wavemc.STEP10: (8, []),
            scl_parity_hw.TPU_LOG: (6, ["PARITY PASS"]),
            scl_parity_hw.TPU_FLAVORS_LOG: (2, ["PARITY PASS", "rc=0"]),
            es_sanity_hw.TPU_LOG: (2, ["ES-SANITY PASS"]),
            "hw_queue_r3/tie_study_128_L32.log": (17, []),
            "hw_queue_r3/tie_study_1024_L32.log": (8, [])}
    for path, (n, text) in logs.items():
        log = _common.read_log(path)
        assert len(log.records) == n and log.text == text, path
        assert all(not t.startswith(("WARNING:", "===")) for t in log.text)
    step10 = _common.read_log(bler_wavemc.STEP10).records
    assert [r["section"] for r in step10] == (
        ["1: noise discriminator (fixed-100 decoder, tf32 mc channel)"] * 2
        + ["2: wave perf A/B at K32s4c2 (tf32)"] * 2
        + ["3: wave tail BLER 3.5 dB (tf32)"] * 2
        + ["4: wave 2.0 dB BLER (tf32)"] * 2)
    assert _common.read_log(bler_r1.TPU_LOG).records[0]["section"] is None


def test_tpu_rows_each_arm_is_held_against():
    """mc against step10's counter threefry (sections 3 and 4), not the
    hardware PRNG rows of step7/8; fused and mc-tf against step7/8."""
    row = bler_wavemc.tpu_row
    assert (row("BP_1024_FASTCHK", "mc", 3.5)["errblock"],
            row("BP_1024_FASTCHK", "mc", 3.5)["frames"]) == (1223, 6805940)
    assert (row("BP_1024_FASTCHK", "mc", 2.0)["errblock"],
            row("BP_1024_FASTCHK", "mc", 2.0)["frames"]) == (20838, 756793)
    assert row("BP_1024_FASTCHK", "fused", 2.0)["errblock"] == 7275
    assert row("BP_1024_FASTCHK", "fused", 3.5)["errblock"] == 1055
    assert row("BP_1024_FASTCHK", "mc-tf", 2.0)["errblock"] == 20635
    assert row("BP_1024_FASTCHK", "mc-tf", 3.5) is None
    assert row("BP_128", "fused", 2.0) is None
    assert bler_wavemc.history_row("BP_1024_FASTCHK", 2.0)["errblock"] == 20900
    assert bler_wavemc.history_row("BP_1024_FASTCHK", 3.5)["errblock"] == 1176
    t = tie_impact_study.tpu_final("CASCL_1024_L32", 1.5)
    assert (t["frames"], t["tie_frames"], t["blk_default"], t["blk_strict"],
            t["block_outcome_differs"]) == (4096, 56, 93, 93, 0)
    t = tie_impact_study.tpu_final("CASCL_128_L32", 2.0)
    pin = _common.STUDY_PINS["tie_impact_128"]
    assert all(t[k] == pin[k] for k in pin if k in t)
    assert len([k for k in pin if k in t]) == len(pin) - 1  # all but bit diffs
    assert tie_impact_study.tpu_final("CASCL_128_L8", 2.0) is None


def test_precision_records_equal_reproduction_md():
    with open(os.path.join(REPO, bf16_study.REPRODUCTION)) as f:
        text = f.read().splitlines()
    for (name, snr, arm), (bler, line) in bf16_study.TPU.items():
        row = text[line - 1]
        assert row.startswith(f"| {name} @{snr} dB"), row
        cells = [c.strip() for c in row.strip("|").split("|")]
        col = {"c64": 1, "f32_tpu": 2, "f32": 1, "bfloat16": 2}[arm]
        assert float(cells[col]) == bler
        part = 1 if arm in ("c64", "f32_tpu") else 2
        ratio, ci = bf16_study.TPU_RATIOS[(name, snr, part)]
        assert cells[3] == f"{ratio} ± {ci}" or cells[3] == f"{ratio:.2f} ± {ci}"
    t = bf16_study.tpu_arm("BP_1024", 3.5, "bfloat16")
    assert t["errblock"] == 1000 and t["frames"] == round(1000 / 2.157e-4)


def test_pins_hold_the_cpu_record():
    """The tie pin is tie_impact_study.py's final line on the CPU, and its
    running lines show no decoded-bit difference in any batch."""
    recs = _common.read_log("hw_queue_r3/tie_study_128_L32.log").records
    pin = _common.STUDY_PINS["tie_impact_128"]
    final = recs[-1]
    assert {k: final[k] for k in pin if k in final} == {
        k: v for k, v in pin.items() if k in final}
    assert sum(r["decoded_bits_differ"] for r in recs[:-1]) == pin[
        "decoded_bits_differ_total"] == 0
    for name in ("bler_r1_exact", "bler_r1_fastr1", "bf16_f32", "bf16_bfloat16"):
        errbit, errblock, ties = _common.STUDY_PINS[name]["counts"]
        assert errbit >= errblock > 0 and ties >= 0


def _rec(tmp_path, study="bler_r1"):
    return _common.Recorder(study, S.STUDIES[study].FILE, str(tmp_path),
                            device="cpu", commit="test", log=None)


def test_recorder_resumes_an_arm_and_skips_a_finished_one(tmp_path):
    """An arm cut short after its first run of CHUNK_STEPS steps resumes
    from its checkpoint and counts what one uninterrupted run counts; a
    finished arm is found by its key and not run again."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_point

    p, snr, batch = preset("SC_128"), 3.0, 8
    want = run_point(p, snr, batch=batch, device="cpu", error_blocks=25,
                     max_frames=8192)
    assert want.frames > _common.CHUNK_STEPS * batch  # two runs or more

    class Cut(Exception):
        pass

    rec = _rec(tmp_path)
    saves = []
    save = rec.save

    def cut_after_first(arm, state):
        save(arm, state)
        saves.append(state)
        if len(saves) == 1:
            raise Cut

    rec.save = cut_after_first
    with pytest.raises(Cut):
        _common.run_point_resumable(rec, "arm", p, snr, batch, 25, 8192)
    state = _rec(tmp_path).checkpoint("arm")
    assert state["point"]["frames"] == _common.CHUNK_STEPS * batch
    assert os.path.exists(tmp_path / _common.CHECKPOINT_FILE)
    logged = []
    rec = _common.Recorder("bler_r1", "x.jsonl", str(tmp_path), device="cpu",
                           commit="test", log=logged.append)
    res, launches = _common.run_point_resumable(rec, "arm", p, snr, batch, 25, 8192)
    assert (res.errbit, res.errblock, res.frames) == (want.errbit, want.errblock,
                                                      want.frames)
    assert launches == {} and logged[0].startswith("arm: resumed at 512 frames")
    line = rec.finish("arm", {"frames": res.frames})
    assert not os.path.exists(tmp_path / _common.CHECKPOINT_FILE)
    assert rec.done("arm") == line and line["card"] == "cpu (plain versions)"
    assert line["commit"] == "test" and rec.done("other") is None


def test_finished_study_is_not_run_again(tmp_path, monkeypatch):
    lines = S.run_study("es_sanity_hw", str(tmp_path), device="cpu", log=None,
                        commit="test", frames=4)
    assert [x["preset"] for x in lines] == ["BP_128", "BP_1024"]
    assert all(x["bits_equal"] and x["launches"] == {} for x in lines)
    assert lines[0]["tpu"]["file"] == "results/hw_queue_r3/step7.log"

    def boom(*a, **k):
        raise AssertionError("a finished arm ran again")

    monkeypatch.setattr(scl_parity_hw, "channel_llrs", boom)
    monkeypatch.setattr(es_sanity_hw, "channel_llrs", boom)
    again = S.run_study("es_sanity_hw", str(tmp_path), device="cpu", log=None,
                        commit="other", frames=4)
    assert again == lines


def test_refuses_the_archive(tmp_path, capsys):
    before = {f: os.stat(os.path.join(_common.ARCHIVE, f)).st_mtime_ns
              for f in os.listdir(_common.ARCHIVE)}
    for out in (_common.ARCHIVE, os.path.join(_common.ARCHIVE, "hw_queue_r3"),
                os.path.join(_common.ARCHIVE, "h100", "..")):
        with pytest.raises(ValueError, match="TPU archive"):
            _common.Recorder("bler_r1", bler_r1.FILE, out, device="cpu")
        with pytest.raises(ValueError, match="TPU archive"):
            S.write_reports(out)
        assert S.main(["--out", out, "--device", "cpu", "--study",
                       "es_sanity_hw"]) == 2
    assert "TPU archive" in capsys.readouterr().err
    assert {f: os.stat(os.path.join(_common.ARCHIVE, f)).st_mtime_ns
            for f in os.listdir(_common.ARCHIVE)} == before


def test_command_line_refusals(tmp_path, capsys):
    """A per-study flag with --study all is refused; with no card the
    default device exits non-zero and names --device cpu."""
    import torch

    assert S.main(["--out", str(tmp_path), "--device", "cpu", "--frames", "8"]) == 2
    assert "takes one study" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert S.main(["--out", str(tmp_path), "--study", "es_sanity_hw"]) == 2
        assert "--device cpu" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def _write_lines(path, lines):
    with open(path, "w") as f:
        for x in lines:
            f.write(json.dumps(x) + "\n")


def test_report_only_on_hand_made_records(tmp_path, capsys):
    """STUDIES.md and PRECISION.md from hand-made lines: each line beside
    its TPU record, the verdicts and z, and a failed check named."""
    card = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "commit": "abc"}
    tpu = _common.read_log(bler_r1.TPU_LOG).records
    exact = dict(preset="SCL_128_L8", snr_db=3.0, frames=106496, errblock=1053,
                 bler=1053 / 106496, elapsed_s=1.25, errbit=9000, pm_ties=3,
                 batch=8192, launches={"scl_decode": 13, "frame_channel": 13},
                 tpu=_common.tpu_ref(bler_r1.TPU_LOG, tpu[0]), z=0.0,
                 same_as_tpu=True, arm="a", **card)
    fast = dict(exact, preset="SCL_128_L8_FASTR1", errblock=1300,
                bler=1300 / 106496, tpu=_common.tpu_ref(bler_r1.TPU_LOG, tpu[1]),
                z=_common.two_proportion_z(1300, 106496, 1052, 106496),
                same_as_tpu=False, launches={"scl_decode_r1": 13}, arm="b")
    ratio, three, word = bler_r1.verdict(exact, fast)
    assert word == "DIVERGES" and ratio == pytest.approx(1300 / 1053)
    verdict = dict(config="SCL_128_L8", r1=4, **{"bler_ratio_r1/exact": ratio},
                   **{"3sigma": three}, verdict=word,
                   tpu=_common.tpu_ref(bler_r1.TPU_LOG, tpu[2]), arm="c", **card)
    _write_lines(tmp_path / bler_r1.FILE, [exact, fast, verdict])
    part2 = dict(part=2, preset="BP_128", snr_db=4.0, errblock=1000,
                 frames=526000, bler=1000 / 526000, ci_rel=1 / 1000 ** 0.5,
                 errbit=9000, pm_ties=0, elapsed_s=3.0, fps=1.0, dtype="f32",
                 batch=8192, engine="auto", launches={"bp_decode": 65},
                 tpu=bf16_study.tpu_arm("BP_128", 4.0, "f32"), z=0.1, arm="d", **card)
    _write_lines(tmp_path / bf16_study.FILE, [part2])
    assert S.main(["--report-only", "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out
    assert "STUDIES.md: 2 checks failed" in printed
    assert "PRECISION.md: all checks held" in printed
    text = (tmp_path / "STUDIES.md").read_text()
    assert "Card (nvidia-smi name, power.limit): NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert ("| SCL_128_L8 | 3.0 | 106496 | 1053 | 9.8877e-03 | 1.250 | "
            "frame_channel 13, scl_decode 13 | 106496 | 1053 | 9.8877e-03 | "
            "+0.00 | yes |") in text
    assert f"| SCL_128_L8 | 4 | {ratio:.4f} | {three:.4f} | DIVERGES | 0.9991 | " \
           "0.1308 | OK |" in text
    assert "- FAILED: bler_r1 SCL_128_L8_FASTR1 @ 3.0: z +" in text
    assert "- FAILED: bler_r1 SCL_128_L8: DIVERGES" in text
    text = (tmp_path / "PRECISION.md").read_text()
    assert "| BP_128 @4.0 dB | f32 | 526000 | 1000 | 1.9011e-03 | 3.000 | " \
           "bp_decode 65 | 0.001899 | +0.10 |" in text


def test_quick_pins_through_the_run_entry():
    """bler_r1's quick run of chip_smoke.py (its studies_quick phase) on the
    CPU: the plain versions give both bler_r1 pins (the card must give them
    through the kernels) and launch nothing."""
    import sys

    import torch

    sys.path.insert(0, REPO)
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = chip_smoke.studies_quick_results("cpu", ["bler_r1"])["bler_r1"]
    finally:
        torch.set_num_threads(threads)
    assert got["launches"] == {} and got["failed"] == []
    for x in got["lines"][:2]:
        pin = next(p for p in _common.STUDY_PINS.values()
                   if p.get("preset") == x["preset"] and "counts" in p)
        assert (x["errbit"], x["errblock"], x["pm_ties"], x["frames"]) == (
            *pin["counts"], pin["batch"])
