"""What the drivers of the JAX repository's hardware queues share, ported as
scripts/torch_verify_drive.py (scripts/verify_drive.py),
torch_bench_scl.py (bench_scl.py), torch_ab_r1.py (ab_r1.py),
torch_bench_wave.py (bench_wave.py) and torch_ab_wavecheck.py
(ab_wavecheck.py): their command line's common flags, their records, the
TPU logs each is held against or cites, and QUEUE_A.md, the host-only
report of their records (written by `python -m polardecoding_tpu_torch.
studies --report-only`).

Each driver appends JSON lines to <out>/<its file> (results/h100/ by
default, never inside the TPU archive), each with the script's own keys
plus `card` (nvidia-smi's name and power limit, or the CPU), `commit` and
`launches` (the kernels the measured calls launched).  The drivers run on
the card by default and exit 2 without one unless --device cpu is given,
which runs the plain versions.  verify_drive's and ab_r1's lines are held
(BASELINE.md's tolerances; every timed rate-1 variant bit-equal to its
plain version first); the others are the card's times, beside which the
report cites the TPU log of the same configuration by path and states none
of the TPU's times.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from typing import Callable, Optional

from polardecoding_tpu_torch.studies._common import (
    DEFAULT_OUT,
    Recorder,
    add_counts,
    check_out,
    launches_text,
    read_lines,
    read_log,
    two_proportion_z,
)

REPORT = "QUEUE_A.md"
# driver -> its records' file in --out
FILES = {"verify_drive": "verify_drive.jsonl", "bench_scl": "scl_grid.jsonl",
         "ab_r1": "r1_ab.jsonl", "bench_wave": "wave_sweep.jsonl",
         "ab_wavecheck": "wavecheck.jsonl"}
# the TPU's runs of each script (results/...): verify_drive --fast three
# times, bench_scl's grid, ab_r1 at four (N, L, B), bench_wave --ab-fused
# and --retune, ab_wavecheck at its defaults
VERIFY_LOGS = ("hw_queue_r2/step5.log", "hw_queue_r3/step6.log",
               "hw_queue_r4/step8.log")
SCL_LOG = "hw_queue_r2/step7.log"
R1_LOGS = {(1024, 8, 8192): "hw_queue_r4/step17.log",
           (128, 8, 16384): "hw_queue_r4/step20.log",
           (1024, 16, 8192): "hw_queue_r4/step22.log",
           (1024, 32, 4096): "hw_queue_r4/step23.log"}
WAVE_LOGS = {"ab-fused": "hw_queue_r2/step3.log", "retune": "hw_queue_r3/step5.log"}
WAVECHECK_LOG = "hw_queue_r4/step2.log"

# verify_drive.py's check line
_VERIFY_LINE = re.compile(
    r"(?P<check>\S+)\s+@(?P<snr>[\d.]+)dB: bler=(?P<bler>[\d.]+) "
    r"want~(?P<want>[\d.]+) \(\+-(?P<tol>[\d.]+)\) frames=(?P<frames>\d+) "
    r"\[\d+ fps\] (?P<word>OK|FAIL)$")


def verify_rows(rel_path: str) -> dict:
    """The check lines of a TPU verify_drive log: {check: {snr_db, bler,
    frames, errblock, ok}}.  errblock is bler * frames rounded, exact at the
    log's five decimals for these frame counts; the log's rates are left
    out."""
    rows = {}
    for line in read_log(rel_path).text:
        m = _VERIFY_LINE.match(line)
        if m:
            frames, bler = int(m["frames"]), float(m["bler"])
            rows[m["check"]] = {"snr_db": float(m["snr"]), "bler": bler,
                                "frames": frames, "errblock": round(bler * frames),
                                "ok": m["word"] == "OK"}
    return rows


def verify_tpu() -> dict:
    """{check: the TPU's row, with the logs that hold it}, from the three
    --fast runs where they agree (they do, to the last digit)."""
    runs = [verify_rows(p) for p in VERIFY_LOGS]
    return {name: dict(row, file=", ".join(f"results/{p}" for p in VERIFY_LOGS))
            for name, row in runs[0].items()
            if all(r.get(name) == row for r in runs[1:])}


def parser(prog: str, doc: Optional[str]) -> argparse.ArgumentParser:
    """A driver's command line with the flags every driver has."""
    ap = argparse.ArgumentParser(
        prog=prog, description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="records (never inside the TPU archive)")
    ap.add_argument("--commit", default=None,
                    help="the code's name in the records (default: git HEAD)")
    return ap


def start(name: str, args, log: Optional[Callable[[str], None]] = print
          ) -> Optional[Recorder]:
    """The driver's Recorder (on the card it builds the kernels first), or
    None after a message on stderr where --out lies in the TPU archive or
    the device is CUDA and there is no card."""
    import torch

    try:
        check_out(args.out)
    except ValueError as e:
        print(f"{name}: {e}", file=sys.stderr)
        return None
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"{name}: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return None
    return Recorder(name, FILES[name], args.out, device=args.device,
                    commit=args.commit, log=log)


def time_ms(fn: Callable, iters: int, warmup: int, device) -> float:
    """Mean milliseconds a call of fn over `iters` calls after `warmup`:
    CUDA events around the calls on the card, the host clock elsewhere."""
    import torch

    if torch.device(device).type == "cuda":
        from polardecoding_tpu_torch.utils.card import cuda_ms

        return cuda_ms(fn, iters, warmup)[0]
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# ---------------------------------------------------------------------------
# QUEUE_A.md


def latest(lines: list, key: Callable[[dict], tuple]) -> list:
    """The last line of each key among the lines that have one (key returns
    None for the others), in the order of those last lines."""
    last = {}
    for x in lines:
        k = key(x)
        if k is not None:
            last.pop(k, None)
            last[k] = x
    return list(last.values())


def _cards(recs: dict) -> str:
    cards = sorted({x["card"] for lines in recs.values() for x in lines
                    if "card" in x})
    return "; ".join(cards) or "unknown"


def _verify(lines: list) -> tuple:
    rows = latest(lines, lambda x: x.get("check"))
    out = ["## verify_drive: BLER against BASELINE.md (scripts/verify_drive.py)",
           "",
           "The TPU's three --fast runs (" + ", ".join(
               f"results/{p}" for p in VERIFY_LOGS) + ") agree to the last "
           "digit; the N=1024 checks have no TPU run and are held by "
           "BASELINE.md's tolerance alone.  JAX CPU: the JAX package's "
           "run_point on the CPU at the same settings.", "",
           "| check | Eb/N0 | frames | errblock | BLER | want | tol | held | s | "
           "launches | JAX CPU errblock | = JAX CPU | TPU errblock | = TPU |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for x in rows:
        pin, t = x.get("jax_cpu"), x.get("tpu") or {}
        out.append(
            f"| {x['check']} | {x['snr_db']} | {x['frames']} | {x['errblock']} | "
            f"{x['bler']:.5f} | {x['want']} | {x['tol']} | "
            f"{'OK' if x['ok'] else 'FAIL'} | {x['seconds']:.3f} | "
            f"{launches_text(x['launches'])} | {pin[1] if pin else ''} | "
            f"{_yes(x.get('same_as_jax_cpu'))} | {t.get('errblock', '')} | "
            f"{_yes(x.get('same_as_tpu'))} |")
    probes = latest(lines, lambda x: "probes" if "probes" in x else None)
    final = latest(lines, lambda x: "verify" if "verify" in x else None)
    failed = [f"verify_drive {x['check']}: BLER {x['bler']:.5f} outside "
              f"{x['want']} +- {x['tol']}" for x in rows if not x["ok"]]
    for p in probes:
        out += ["", f"Invariants: all-frozen BP gives zeros: "
                f"{_yes(p['bp_all_frozen_zero'])}; zero-LLR SC gives zeros: "
                f"{_yes(p['sc_zero_llr_zero'])} (launches "
                f"{launches_text(p['launches'])})."]
        if not (p["bp_all_frozen_zero"] and p["sc_zero_llr_zero"]):
            failed.append("verify_drive: an invariant does not hold")
    for f in final:
        out += ["", f"Last run: VERIFY {f['verify']} ({f['checks']} checks"
                f"{', --fast' if f['fast'] else ''})."]
        if f["verify"] != "PASS":
            failed.append(f"verify_drive: VERIFY {f['verify']} {f['failures']}")
    return out + [""], failed


def _yes(v) -> str:
    return "" if v is None else ("yes" if v else "no")


def _bench_scl(lines: list) -> list:
    grid = latest(lines, lambda x: (x["N"], x["L"], x["batch"])
                  if "kernel_fps" in x else None)
    full = latest(lines, lambda x: (x.get("preset", x.get("N")), x["batch"])
                  if "full_mc_fps" in x else None)
    out = ["## bench_scl: the SCL kernel across N and L (scripts/bench_scl.py)",
           "", f"The kernel alone (exact mode, CUDA events around the calls) on "
           f"the channel LLRs of SCL_<N>_L8 at 1.5 dB on its mask; then the "
           f"full MC pipeline (bench_step).  The TPU's run of the script: "
           f"results/{SCL_LOG} (at smaller batches).", "",
           "| N | L | batch | ms a call | frames/s | launches |",
           "|---|---|---|---|---|---|"]
    for x in grid:
        out.append(f"| {x['N']} | {x['L']} | {x['batch']} | "
                   f"{x['ms_per_call']:.4f} | {x['kernel_fps']:.1f} | "
                   f"{launches_text(x['launches'])} |")
    out += ["", "| full MC | batch | frames/s | launches |", "|---|---|---|---|"]
    for x in full:
        name = x.get("preset") or f"SCL_{x['N']}_L{x['L']}"
        out.append(f"| {name} | {x['batch']} | {x['full_mc_fps']:.1f} | "
                   f"{launches_text(x['launches'])} |")
    return out + [""]


def _ab_r1(lines: list) -> tuple:
    def key(x):
        return (x["N"], x["L"], x["B"], tuple(x["r1s"]), x["variant"])

    best = latest(lines, lambda x: key(x) if "best_fps" in x else None)
    parity = latest(lines, lambda x: key(x) if "parity" in x else None)
    out = ["## ab_r1: the rate-1 flavor against exact SCL (scripts/ab_r1.py)",
           "", "Kernel alone on rng(0).normal x 2 LLRs, frozen_mask(N, N/2), "
           "wloop 2, one launch a call (scank 1); best of the interleaved "
           "reps.  Each variant's parity line (64 frames of the kernel against "
           "the plain version: bits, path metrics, ties) held before it was "
           "timed.  x exact: the variant's rate over r1_0's of the same run "
           "(the same --r1s) on this card.", "",
           "| N | L | B | r1s | variant | frames/s | ms a call | x exact | "
           "parity | launches | TPU run |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    exact = {key(x)[:4]: x["best_fps"] for x in best if x["variant"] == "r1_0"}
    held = {key(x): x["bits_equal"] and x["pm_equal"] and x["ties_equal"]
            for x in parity}
    for x in best:
        run = key(x)[:4]
        ratio = x["best_fps"] / exact[run] if run in exact else None
        log = R1_LOGS.get(run[:3])
        out.append(f"| {x['N']} | {x['L']} | {x['B']} | "
                   f"{','.join(map(str, x['r1s']))} | {x['variant']} | "
                   f"{x['best_fps']:.1f} | {x['ms_per_call']:.4f} | "
                   + (f"{ratio:.4f}" if ratio else "") + " | "
                   f"{_yes(held.get(key(x)))} | "
                   f"{launches_text(x['launches'])} | "
                   + (f"results/{log}" if log else "") + " |")
    failed = [f"ab_r1 {k[4]} at N={k[0]}, L={k[1]}, B={k[2]}: kernel differs "
              "from its plain version" for k, ok in held.items() if not ok]
    return out + [""], failed


def _bench_wave(lines: list) -> list:
    def key(x):
        return (x.get("mode"), x["engine"], x.get("batch"), x.get("wave_iters"),
                x.get("fused"), x.get("rep"))

    rows = latest(lines, lambda x: key(x) if "engine" in x else None)
    # the reps of each point: (best rate, launches summed)
    reps = {}
    for x in rows:
        if "rep" in x:
            k = (x["mode"], x["batch"], x["wave_iters"], x.get("fused"))
            fps, launches = reps.get(k, (0.0, {}))
            reps[k] = (max(fps, x["fps"]), add_counts(launches, x["launches"]))
    out = ["## bench_wave: the wave engines across batch and K "
           "(scripts/bench_wave.py)", "",
           "Retired frames/s over 24 chunks of 8 steps after 4 (bench_waves) "
           "at 2.0 dB; with reps, the best of them and the launches of all.  "
           f"The TPU's runs: --ab-fused results/{WAVE_LOGS['ab-fused']}, "
           f"--retune results/{WAVE_LOGS['retune']}.", "",
           "| mode | engine | batch | K | frames/s | x plain | fused_x | "
           "launches |", "|---|---|---|---|---|---|---|---|"]

    def row(mode, engine, batch, k, fps, x_plain="", fused_x="", launches=None):
        out.append(f"| {mode} | {engine} | {batch} | {k} | {fps:.1f} | {x_plain} | "
                   f"{fused_x} | "
                   + ("" if launches is None else launches_text(launches)) + " |")

    for x in rows:
        mode, b, k = x.get("mode"), x.get("batch"), x.get("wave_iters")
        if "rep" in x:
            continue
        if x["engine"] == "wave-AB":
            for fused in (False, True):
                fps, launches = reps.get((mode, b, k, fused), (0.0, {}))
                row(mode, f"wave, fused={fused}", b, k, fps, launches=launches)
            row(mode, "wave-AB", b, k, x["best_fused"],
                fused_x=f"{x['fused_x']:.4f}")
        elif x["engine"] == "wave-retune-best":
            for (m, rb, rk, _), (fps, launches) in reps.items():
                if m == mode:
                    row(mode, f"wave-retune {x['preset']}", rb, rk, fps,
                        launches=launches)
            row(mode, "wave-retune-best", b, k, x["fps"])
        else:
            row(mode, x["engine"], b, "" if k is None else k, x["fps"],
                f"{x['x_plain']:.4f}" if "x_plain" in x else "",
                launches=x["launches"])
    return out + [""]


def _ab_wavecheck(lines: list) -> list:
    rows = latest(lines, lambda x: (x["preset"], x["B"], x["K"], x["snr_db"],
                                    x["variant"])
                  if "best_retired_fps" in x else None)
    out = ["## ab_wavecheck: the in-wave check cadence (scripts/ab_wavecheck.py)",
           "", "make_wave_step(check_every=c), each variant from a fresh carry "
           "each rep, 4 steps then a window of `steps` steps; best of the "
           "interleaved reps.  Window: the last rep's (every rep's holds the "
           "same frames), its frames, error blocks and BLER, and z against "
           "ce0's window (the variants retire different frames).  "
           f"The TPU's run: results/{WAVECHECK_LOG}.", "",
           "| preset | B | K | Eb/N0 | variant | retired frames/s | x ce0 | "
           "window frames | window errblock | window BLER | z vs ce0 | "
           "launches |", "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    base = {(x["preset"], x["B"], x["K"], x["snr_db"]): x for x in rows
            if x["variant"] == "ce0"}
    for x in rows:
        b = base.get((x["preset"], x["B"], x["K"], x["snr_db"]))
        frames, errs = x.get("window_frames"), x.get("window_errblock")
        z = (two_proportion_z(errs, frames, b["window_errblock"],
                              b["window_frames"])
             if b and frames and b.get("window_frames") else None)
        out.append(f"| {x['preset']} | {x['B']} | {x['K']} | {x['snr_db']} | "
                   f"{x['variant']} | {x['best_retired_fps']:.1f} | "
                   + (f"{x['best_retired_fps'] / b['best_retired_fps']:.4f}"
                      if b else "") + " | "
                   + (f"{frames} | {errs} | " if frames else " | | ")
                   + f"{x['window_bler']:.5f} | "
                   + ("" if z is None else f"{z:+.2f}") + " | "
                   f"{launches_text(x['launches'])} |")
    return out + [""]


def report(out: str = DEFAULT_OUT) -> Optional[tuple]:
    """QUEUE_A.md's lines from the drivers' records in out and the checks
    that failed, or None where out holds no such record.  Each table shows
    the last line of each configuration."""
    recs = {name: read_lines(out, f) for name, f in FILES.items()}
    if not any(recs.values()):
        return None
    body = ["# ROADMAP queue A's drivers (H100)", "",
            f"Card (nvidia-smi name, power.limit): {_cards(recs)}.  Code: "
            + (", ".join(sorted({x['commit'] for v in recs.values() for x in v
                                 if 'commit' in x})) or "unknown")
            + ".  scripts/torch_*.py; every time is the card's own.  The TPU "
            "logs are cited by path; no TPU time or rate is stated here.", ""]
    failed = []
    if recs["verify_drive"]:
        lines, bad = _verify(recs["verify_drive"])
        body += lines
        failed += bad
    if recs["bench_scl"]:
        body += _bench_scl(recs["bench_scl"])
    if recs["ab_r1"]:
        lines, bad = _ab_r1(recs["ab_r1"])
        body += lines
        failed += bad
    if recs["bench_wave"]:
        body += _bench_wave(recs["bench_wave"])
    if recs["ab_wavecheck"]:
        body += _ab_wavecheck(recs["ab_wavecheck"])
    total = {}
    for lines in recs.values():
        for x in lines:
            total = add_counts(total, x.get("launches", {}))
    body += ["## Launches", "", "Every record's launches summed: "
             f"{launches_text(total)}.", "",
             "## Checks", ""] + ([f"- FAILED: {f}" for f in failed] or [
                 "All held: every verify check within its tolerance, both "
                 "invariants, VERIFY PASS, every r1 parity line bit-equal."]) + [""]
    return body, failed
