"""The reference-curve reproduction on the card: the port of the JAX
repository's scripts/reproduce_curves.py, reproduce_extra.py,
reproduce_r4.py and scl_lsweep.py, with every point held against the TPU
archive of the same runs (results/<file>.json, read only).

  python -m polardecoding_tpu_torch.reproduce --set all           # the card
  python -m polardecoding_tpu_torch.reproduce --set lsweep --N 128
  python -m polardecoding_tpu_torch.reproduce --report-only       # host only

Two halves.  The run half (`run_presets`) runs each preset of the chosen
plans through run_sweep at batch 4096 on the card, one checkpoint per preset
under --out (default results/h100/), so a rerun resumes every finished
point; after each preset it logs and records (RUNS.json) its wall seconds
and the launches of the kernels on its path (`path_kernels`).  It refuses
any output path inside the archive: run_sweep resumes from a checkpoint of
either package, so pointed at results/<preset>.json it would take the TPU
records as finished points.  The report half (`write_reports`, host only)
writes REPRODUCTION.md, REPRODUCTION_EXTRA.md, SCL_LSWEEP.md,
BP_1024_GA_vs_dega.json and curves_{128,1024}.png from the records, each
point beside the archive's record of the same preset and SNR: its BLER and
error blocks, the two-proportion z, and whether (errbit, errblock, frames)
are the archive's exactly.

Batch 4096 is what makes the frame sets those of the archive: every frame is
a pure function of (seed, frame index), the archive's runs are seed 1024 at
batch 4096, so a point that stops at the same step counts the same frames.
It is not an option of the command line; `run_presets` takes `batch` only
so that the tests can run a small one on the CPU (`--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the TPU archive: read, never written
ARCHIVE = os.path.join(ROOT, "results")
DEFAULT_OUT = os.path.join(ARCHIVE, "h100")
BATCH = 4096
RUNS_FILE = "RUNS.json"
Z_LIMIT = 4.0
LSWEEP_LISTS = (2, 4, 8, 16, 32)

# reproduce_curves.py:25-36: (preset, snr grid, error-block target, max
# frames per point); --quick scales the target by 0.25, at least 25
MAIN = [
    ("SC_128", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 100, 2_000_000),
    ("BP_128", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 200, 2_000_000),
    ("BP_128_SPA", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 200, 2_000_000),
    ("SCL_128_L8", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000),
    ("CASCL_128_L8", [1.0, 1.5, 2.0, 2.5, 3.0], 200, 2_000_000),
    ("SC_1024", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0], 100, 8_000_000),
    ("BP_1024", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 8_000_000),
    ("SCL_1024_L8", [1.0, 1.5, 2.0, 2.5, 3.0], 50, 2_000_000),
    ("CASCL_1024_L8", [1.0, 1.5, 2.0, 2.5], 200, 4_000_000),
]

# reproduce_extra.py:19-29: (preset, snrs, blocks, cap, reference note)
EXTRA = [
    ("CASCL_128_L32", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000,
     "CASCL_128_L32.txt seed 2525: 0.147/0.0662/0.0185/4.03e-3/9.83e-4/1.89e-4"),
    ("CASCL_128_fag_L8", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 2_000_000,
     "CAL8_0.dat seed 1319: 0.243/0.1221/0.0394/0.0102/2.17e-3/3.79e-4"),
    ("CASCL_1024_sys_L8", [1.0, 1.5, 2.0, 2.5], 150, 4_000_000,
     "CASCL_1024_sys.c sweeps 2.5 only; mult-CRC CASCL_L8.dat @2.5 = 9.65e-5"),
    ("CASCL_1024_L32", [1.0, 1.5, 2.0, 2.2], 100, 2_000_000,
     "CASCL_L32.dat seed 1825: 0.2435/0.0270/7.07e-4/1.11e-4"),
]

# reproduce_r4.py:29-35
R4 = [
    ("CASCL_128_fag_L32", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 4_000_000,
     "CAL32_0.dat seed 1749: 0.1448/0.07184/0.01684/3.991e-3/8.20e-4/1.990e-4"),
    ("BP_1024_GA", [1.0, 1.5, 2.0, 2.5, 3.0, 3.5], 200, 8_000_000,
     "BASELINE.json config #2 (GA construction + early stop); no ref table"),
]

# scl_lsweep.py:24-27, each at L in LSWEEP_LISTS
LSWEEP = {
    128: dict(snrs=[1.0, 1.5, 2.0, 2.5, 3.0, 3.5], blocks=200, cap=1_500_000),
    1024: dict(snrs=[1.0, 1.5, 2.0, 2.5, 3.0], blocks=50, cap=1_000_000),
}

SETS = ("main", "extra", "r4", "lsweep")

# (errbit, errblock, frames) at each preset's first point, 1.0 dB, as the
# JAX package's run_sweep on the CPU gives them with the plan's arguments
# (batch 4096, seed 1024): one step of 4096 frames, BP_1024_GA's the wave
# engine's retired frames.  BP_128_SPA is held statistically only: SPA's
# exp and log1p are each framework's own.
JAX_CPU_PINS = {
    "SC_128": (34537, 1743, 4096),
    "BP_128": (34100, 1770, 4096),
    "SCL_128_L8": (16813, 996, 4096),
    "CASCL_128_L8": (26759, 1040, 4096),
    "SC_1024": (525036, 2909, 4096),
    "BP_1024": (315098, 2055, 4096),
    "SCL_1024_L8": (120611, 940, 4096),
    "CASCL_1024_L8": (296123, 1667, 4096),
    "CASCL_128_L32": (17985, 664, 4096),
    "CASCL_128_fag_L8": (26759, 1040, 4096),
    "CASCL_1024_sys_L8": (282955, 1605, 4096),
    "CASCL_1024_L32": (180785, 1017, 4096),
    "CASCL_128_fag_L32": (17985, 664, 4096),
    "BP_1024_GA": (974578, 7418, 14245),
    "SCL_128_L2": (23040, 1254, 4096),
    "SCL_128_L4": (18826, 1082, 4096),
    "SCL_128_L16": (16224, 975, 4096),
    "SCL_128_L32": (16126, 966, 4096),
    "SCL_1024_L2": (306151, 1897, 4096),
    "SCL_1024_L4": (182040, 1260, 4096),
    "SCL_1024_L16": (86696, 758, 4096),
    "SCL_1024_L32": (65851, 655, 4096),
}


class Run(NamedTuple):
    """One preset of a plan: its set, the run_sweep arguments and the file
    of its records (in --out, and the archive's of the same name)."""

    set: str
    preset: str
    snrs: list
    blocks: int
    cap: int
    file: str
    note: str = ""


def plan(sets=SETS, quick: bool = False, ncode: str = "all") -> list[Run]:
    """The runs of `sets` in the JAX scripts' order; `quick` as
    reproduce_curves.py's --quick (main only), `ncode` as scl_lsweep.py's
    --N (lsweep only)."""
    runs = []
    for s in SETS:
        if s not in sets:
            continue
        if s == "main":
            scale = 0.25 if quick else 1.0
            runs += [Run(s, name, snrs, max(25, int(blocks * scale)), cap,
                         f"{name}.json")
                     for name, snrs, blocks, cap in MAIN]
        elif s in ("extra", "r4"):
            runs += [Run(s, name, snrs, blocks, cap, f"{name}.json", note)
                     for name, snrs, blocks, cap, note in
                     (EXTRA if s == "extra" else R4)]
        else:
            for n, p in LSWEEP.items():
                if ncode not in ("all", str(n)):
                    continue
                runs += [Run(s, f"SCL_{n}_L{L}", p["snrs"], p["blocks"],
                             p["cap"], f"SCL_{n}_L{L}_lsweep.json")
                         for L in LSWEEP_LISTS]
    return runs


def pinned_runs() -> list[Run]:
    """Each pinned preset's first point with its plan's arguments (the
    first plan that holds the preset)."""
    out = {}
    for r in plan():
        if r.preset in JAX_CPU_PINS and r.preset not in out:
            out[r.preset] = r._replace(snrs=r.snrs[:1])
    return list(out.values())


def path_kernels(p) -> tuple:
    """The kernels a preset's sweep launches on the card: its decoder's and
    the frame channel.  BP early stop runs the fused wave engine."""
    if p.decoder.kind == "bp":
        return ("bp_wave_fused" if p.decoder.bp_early_stop else "bp_decode",
                "frame_channel")
    return ("scl_decode", "frame_channel")


def launch_counts() -> dict:
    """The launch counters of the kernels a reproduction or a study
    (polardecoding_tpu_torch.studies) can run."""
    from polardecoding_tpu_torch.ops import (bp_kernel, bp_wave_kernel,
                                             bp_wave_mc_kernel, channel_kernel,
                                             frame_channel_kernel, scl_kernel)

    return {"bp_decode": bp_kernel.LAUNCHES,
            "bp_wave_fused": bp_wave_kernel.LAUNCHES["bp_wave_fused"],
            "bp_wave": bp_wave_kernel.LAUNCHES["bp_wave"],
            "bp_wave_mc": bp_wave_mc_kernel.LAUNCHES,
            "mc_channel": channel_kernel.LAUNCHES,
            "scl_decode": scl_kernel.LAUNCHES,
            "scl_decode_r1": scl_kernel.LAUNCHES_R1,
            "frame_channel": frame_channel_kernel.LAUNCHES}


def check_out(out: str):
    """Refuse an output directory in the archive: only DEFAULT_OUT's tree,
    or a directory outside the archive, may take new files."""
    real = os.path.realpath(out)
    arch = os.path.realpath(ARCHIVE)
    own = os.path.realpath(DEFAULT_OUT)
    inside = os.path.commonpath([real, arch]) == arch
    if inside and os.path.commonpath([real, own]) != own:
        raise ValueError(
            f"{out} lies in the TPU archive {ARCHIVE}: its records are read, "
            f"never written (run_sweep would resume from them); use "
            f"{own} or a directory outside the archive")


def commit_id() -> str:
    """HEAD of the checkout, with "+changes" when the tree differs from it;
    "unknown" where there is no git repository."""
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=ROOT,
                               capture_output=True, text=True, check=True,
                               timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return head + ("+changes" if dirty else "")


def _load(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: str):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def run_presets(runs: list[Run], out: str = DEFAULT_OUT, device="cuda",
                batch: int = BATCH, log: Optional[Callable[[str], None]] = print,
                commit: Optional[str] = None) -> dict:
    """Run each of `runs` through run_sweep into out/<file> (resuming what
    is there), then log its points and add to its entry in out/RUNS.json
    the wall seconds, new frames and kernel launches of this run, beside
    the card and the code it ran on (an entry a rerun without new frames
    leaves as it was).  On the card each kernel of the preset's path must have
    been launched whenever it ran new frames, and a frame-step preset's
    decoder and frame channel once a step.  Returns {file: its RUNS.json
    entry with "records", the sweep's records}."""
    import torch

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_sweep

    check_out(out)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("reproduce: no CUDA device (--device cpu runs the "
                           "plain versions)")
    os.makedirs(out, exist_ok=True)
    if cuda:
        from polardecoding_tpu_torch.utils.card import card_line

        card = card_line()
    else:
        card = f"{device.type} (plain versions)"
    commit = commit or commit_id()
    runs_path = os.path.join(out, RUNS_FILE)
    done = {}
    for r in runs:
        p = preset(r.preset)
        path = os.path.join(out, r.file)
        before = sum(rec["frames"] for rec in _load(path) or [])
        counts0 = launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(p, batch=batch, device=device, snr_points=r.snrs,
                        error_blocks=r.blocks, max_frames=r.cap,
                        checkpoint_path=path, log=log)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts1 = launch_counts()
        launches = {k: counts1[k] - counts0[k] for k in counts1
                    if counts1[k] != counts0[k]}
        recs = [x.to_json(p.code.num_info) for x in res]
        frames = sum(x.frames for x in res) - before
        steps = frames // batch if frames % batch == 0 else None
        if log:
            log(f"== {r.preset} [{r.set}] done in {seconds:.3f} s, {frames} "
                f"new frames, launches {json.dumps(launches, sort_keys=True)}"
                + (f" [{r.note}]" if r.note else ""))
            for x in res:
                log(f"   {x.snr_db:.1f} dB: {x.bler:.4e} ({x.errblock}/"
                    f"{x.frames}) {x.elapsed_s:.3f} s")
        if cuda and frames:
            kernels = path_kernels(p)
            missing = [k for k in kernels if not launches.get(k)]
            if missing or set(launches) - set(kernels):
                raise RuntimeError(f"reproduce {r.preset}: launches {launches}, "
                                   f"expected {kernels}")
            if kernels[0] != "bp_wave_fused" and not (
                    launches[kernels[0]] == launches["frame_channel"] == steps):
                raise RuntimeError(f"reproduce {r.preset}: launches {launches} "
                                   f"for {steps} steps")
        summary = _load(runs_path) or {}
        entry = summary.get(r.file)
        if frames or entry is None:
            prev = entry or {"seconds": 0.0, "frames": 0, "launches": {}}
            entry = {"preset": r.preset, "set": r.set, "card": card,
                     "commit": commit, "batch": batch,
                     "seconds": prev["seconds"] + seconds,
                     "frames": prev["frames"] + frames,
                     "launches": {k: prev["launches"].get(k, 0)
                                  + launches.get(k, 0)
                                  for k in sorted({*prev["launches"], *launches})}}
            summary[r.file] = entry
            _dump(summary, runs_path)
        done[r.file] = dict(entry, records=recs)
    return done


# ---------------------------------------------------------------- report


def two_proportion_z(e1: int, n1: int, e2: int, n2: int) -> float:
    """z = (p1 - p2) / sqrt(p(1 - p)(1/n1 + 1/n2)) with the pooled p."""
    p1, p2 = e1 / n1, e2 / n2
    p = (e1 + e2) / (n1 + n2)
    var = p * (1 - p) * (1 / n1 + 1 / n2)
    if var == 0:
        return 0.0 if p1 == p2 else math.copysign(math.inf, p1 - p2)
    return (p1 - p2) / math.sqrt(var)


def compare(rec: dict, arch: Optional[dict]) -> dict:
    """A port record against the archive's record of the same point."""
    if arch is None:
        return {"archive_bler": None, "archive_errblock": None, "z": None,
                "same": None}
    return {"archive_bler": arch["errblock"] / arch["frames"],
            "archive_errblock": arch["errblock"],
            "z": two_proportion_z(rec["errblock"], rec["frames"],
                                  arch["errblock"], arch["frames"]),
            "same": all(rec[k] == arch[k]
                        for k in ("errbit", "errblock", "frames"))}


def _points(runs: list[Run], out: str) -> list[dict]:
    """Each record of `runs` found in out, with its run and its comparison
    with the archive."""
    rows = []
    for r in runs:
        arch = {rec["snr_db"]: rec for rec in _load(os.path.join(ARCHIVE, r.file))
                or []}
        for rec in _load(os.path.join(out, r.file)) or []:
            rows.append(dict(rec, run=r, **compare(rec, arch.get(rec["snr_db"]))))
    return rows


def _cells(row: dict) -> list[str]:
    """this work, errblocks, frames, seconds, the archive's BLER and error
    blocks, z, same counts."""
    if row["z"] is None:
        arch = ["", "", "", ""]
    else:
        arch = [f"{row['archive_bler']:.4g}", str(row["archive_errblock"]),
                f"{row['z']:+.2f}", "yes" if row["same"] else "no"]
    return [f"{row['bler']:.4g}", str(row["errblock"]), str(row["frames"]),
            f"{row['elapsed_s']:.3f}"] + arch


ARCHIVE_HEAD = ("this work | errblocks | frames | s | TPU archive | archive "
                "errblocks | z | same counts")


def _summary(rows: list[dict]) -> str:
    held = [r for r in rows if r["z"] is not None]
    worst = max((abs(r["z"]) for r in held), default=0.0)
    over = [f"{r['preset']} @ {r['snr_db']}" for r in held
            if abs(r["z"]) > Z_LIMIT]
    return (f"{len(rows)} points, {len(held)} with an archived record: "
            f"max |z| {worst:.2f} ({'all' if not over else 'not all'} within "
            f"{Z_LIMIT:g}{': ' + ', '.join(over) if over else ''}); the "
            f"archive's (errbit, errblock, frames) exactly at "
            f"{sum(bool(r['same']) for r in held)} of {len(held)}.")


def _header(title: str, runs: list[Run], out: str) -> list[str]:
    summary = _load(os.path.join(out, RUNS_FILE)) or {}
    entries = [summary[r.file] for r in runs if r.file in summary]
    cards = sorted({e["card"] for e in entries})
    commits = sorted({e["commit"] for e in entries})
    batches = sorted({e["batch"] for e in entries})
    return [f"# {title}", "",
            f"Card (nvidia-smi name, power.limit): {'; '.join(cards) or 'unknown'}. "
            f"Code: {', '.join(commits) or 'unknown'}. Batch "
            f"{', '.join(map(str, batches)) or 'unknown'}, seed 1024, "
            "polardecoding_tpu_torch.reproduce.", "",
            "Each point beside the TPU archive's record of the same preset and "
            "SNR (results/<file>.json): its BLER and error blocks, the "
            "two-proportion z with the pooled BLER, and whether (errbit, "
            "errblock, frames) are the archive's exactly (frames are pure "
            "functions of (seed, frame index), so equal decisions on every "
            "frame give equal counts). s: the point's wall seconds on the "
            "card.", ""]


def _timing(runs: list[Run], out: str) -> list[str]:
    summary = _load(os.path.join(out, RUNS_FILE)) or {}
    lines = ["## Wall time per preset", "",
             "| preset | card | frames | s | launches |", "|---|---|---|---|---|"]
    for r in runs:
        e = summary.get(r.file)
        if e:
            launches = ", ".join(f"{k} {v}" for k, v in sorted(e["launches"].items()))
            lines.append(f"| {r.preset} | {e['card']} | {e['frames']} | "
                         f"{e['seconds']:.3f} | {launches} |")
    return lines + [""]


def _write(path: str, lines: list[str]):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def report_main(runs: list[Run], out: str) -> Optional[str]:
    """REPRODUCTION.md (reproduce_curves.py's table, with the archive's
    columns) and curves_{128,1024}.png where matplotlib is found."""
    from polardecoding_tpu_torch.plotting import REFERENCE_BLER

    rows = _points(runs, out)
    if not rows:
        return None
    lines = _header("BLER reproduction vs reference archives (H100)", runs, out)
    lines += [_summary(rows), "",
              "reference: the reference's published tables (BASELINE.md); "
              "ratio = this work / reference.", "",
              f"| preset | Eb/N0 (dB) | reference | ratio | {ARCHIVE_HEAD} |",
              "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for row in rows:
        ref = REFERENCE_BLER.get(row["preset"])
        want = ratio = ""
        if ref and row["snr_db"] in ref["snr"]:
            w = ref["bler"][ref["snr"].index(row["snr_db"])]
            want = f"{w:.4g}"
            ratio = f"{row['bler'] / w:.2f}" if w else ""
        lines.append(f"| {row['preset']} | {row['snr_db']:.1f} | {want} | "
                     f"{ratio} | " + " | ".join(_cells(row)) + " |")
    lines += [""] + _timing(runs, out)
    _write(os.path.join(out, "REPRODUCTION.md"), lines)
    plot_curves([{k: v for k, v in row.items() if k != "run"} for row in rows],
                out)
    return _summary(rows)


def plot_curves(recs: list[dict], out: str):
    """curves_{128,1024}.png (reproduce_curves.py's plots) through the
    port's plotting.plot_results; skipped, with a line on stderr, where
    matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("reproduce: matplotlib not found, curves not drawn (run "
              "--report-only where it is)", file=sys.stderr)
        return
    from polardecoding_tpu_torch.plotting import plot_results

    for ncode in (128, 1024):
        sub = [r for r in recs
               if str(ncode) in r["preset"].replace("L8", "").replace("L32", "")]
        if sub:
            plot_results(sub, os.path.join(out, f"curves_{ncode}.png"),
                         title=f"N={ncode} BLER vs reference archives (H100)")


def report_extra(runs: list[Run], out: str) -> Optional[str]:
    """REPRODUCTION_EXTRA.md: one table per preset of reproduce_extra.py's
    and reproduce_r4.py's plans, under its reference note."""
    rows = _points(runs, out)
    if not rows:
        return None
    lines = _header("Supplementary archive configurations (H100)", runs, out)
    lines += [_summary(rows), ""]
    for r in runs:
        mine = [row for row in rows if row["run"] is r]
        if not mine:
            continue
        lines += [f"## {r.preset} ({r.set}; {r.note})", "",
                  f"| Eb/N0 (dB) | {ARCHIVE_HEAD} |",
                  "|---|---|---|---|---|---|---|---|---|"]
        lines += [f"| {row['snr_db']:.1f} | " + " | ".join(_cells(row)) + " |"
                  for row in mine]
        lines.append("")
    lines += _timing(runs, out)
    _write(os.path.join(out, "REPRODUCTION_EXTRA.md"), lines)
    return _summary(rows)


def report_lsweep(runs: list[Run], out: str) -> Optional[str]:
    """SCL_LSWEEP.md: scl_lsweep.py's table per N with its L-monotonicity
    line, then each point against the archive."""
    from polardecoding_tpu_torch.plotting import REFERENCE_SCL_BY_L

    rows = _points(runs, out)
    if not rows:
        return None
    lines = _header("SCL list-size study vs reference (plot_SCL.py / "
                    "SCL_1024.py) (H100)", runs, out)
    lines += [_summary(rows), ""]
    for ncode, p in LSWEEP.items():
        table = {}
        for row in rows:
            if row["run"].preset.startswith(f"SCL_{ncode}_"):
                L = int(row["run"].preset.rsplit("_L", 1)[1])
                table.setdefault(L, {})[row["snr_db"]] = row
        if not table:
            continue
        ref = REFERENCE_SCL_BY_L[ncode]
        snrs = p["snrs"]
        lines += [f"## N = {ncode}", "",
                  "| L | " + " | ".join(f"{s} dB" for s in snrs) + " |",
                  "|---|" + "---|" * len(snrs)]
        for L in LSWEEP_LISTS:
            if L not in table:
                continue
            cells = []
            for s in snrs:
                row = table[L].get(s)
                cell = "" if row is None else f"{row['bler']:.3e}"
                if row is not None and s in ref["snr"]:
                    cell += f" (ref {ref[L][ref['snr'].index(s)]:.3g})"
                cells.append(cell)
            lines.append(f"| {L} | " + " | ".join(cells) + " |")
        lines.append("")
        l2 = table.get(2, {}).get(snrs[0])
        l32 = table.get(32, {}).get(snrs[0])
        if l2 and l32:
            ok = l32["bler"] <= l2["bler"]
            lines += [f"L-monotonicity at {snrs[0]} dB: L32 {l32['bler']:.3e} "
                      f"{'<=' if ok else '>'} L2 {l2['bler']:.3e} "
                      f"({'OK' if ok else 'VIOLATION'})", ""]
        lines += [f"| L | Eb/N0 (dB) | {ARCHIVE_HEAD} |",
                  "|---|---|---|---|---|---|---|---|---|---|"]
        for L in LSWEEP_LISTS:
            lines += [f"| {L} | {s:.1f} | " + " | ".join(_cells(row)) + " |"
                      for s, row in sorted(table.get(L, {}).items())]
        lines.append("")
    lines += _timing(runs, out)
    _write(os.path.join(out, "SCL_LSWEEP.md"), lines)
    return _summary(rows)


def report_ga(out: str) -> Optional[list]:
    """BP_1024_GA_vs_dega.json (reproduce_r4.py:60-79): each MC point of
    BP_1024_GA beside bpdega's union bound on the same GA-constructed
    frozen mask."""
    import numpy as np

    from polardecoding_tpu_torch.analysis.construction import code_frozen_mask
    from polardecoding_tpu_torch.analysis.dega import bpdega
    from polardecoding_tpu_torch.configs import preset

    recs = _load(os.path.join(out, "BP_1024_GA.json"))
    if not recs:
        return None
    code = preset("BP_1024_GA").code
    fr = code_frozen_mask(code)
    mc = {rec["snr_db"]: rec for rec in recs}
    rows = []
    for snr in sorted(mc):
        with np.errstate(invalid="ignore"):
            pred = bpdega(code.N, code.num_info, snr, iters=100, frozen=fr)
        rows.append({"snr_db": snr, "mc_bler": mc[snr]["bler"],
                     "dega_union_bound": pred.bler,
                     "mc_frames": mc[snr]["frames"],
                     "mc_errblock": mc[snr]["errblock"]})
    _dump(rows, os.path.join(out, "BP_1024_GA_vs_dega.json"))
    return rows


def write_reports(out: str = DEFAULT_OUT) -> dict:
    """Every report whose records are in `out` (host only): {report: its
    summary line, or the GA rows}."""
    check_out(out)
    done = {"REPRODUCTION.md": report_main(plan(["main"]), out),
            "REPRODUCTION_EXTRA.md": report_extra(plan(["extra", "r4"]), out),
            "SCL_LSWEEP.md": report_lsweep(plan(["lsweep"]), out),
            "BP_1024_GA_vs_dega.json": report_ga(out)}
    return {k: v for k, v in done.items() if v is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m polardecoding_tpu_torch.reproduce",
        description="The reference-curve reproduction on the card, each point "
                    "held against the TPU archive (results/).")
    ap.add_argument("--set", default="all", choices=SETS + ("all",),
                    help="the plans to run: reproduce_curves.py (main), "
                         "reproduce_extra.py, reproduce_r4.py, scl_lsweep.py")
    ap.add_argument("--N", default="all", choices=("128", "1024", "all"),
                    help="scl_lsweep.py's --N (lsweep only)")
    ap.add_argument("--quick", action="store_true",
                    help="reproduce_curves.py's --quick: targets x 0.25 (main)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="records and reports (never inside the archive)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--commit", default=None,
                    help="the code's name in the records (default: git HEAD)")
    ap.add_argument("--report-only", action="store_true",
                    help="write the reports from the records; no device work")
    args = ap.parse_args(argv)
    try:
        check_out(args.out)
    except ValueError as e:
        print(f"reproduce: {e}", file=sys.stderr)
        return 2
    if not args.report_only:
        import torch

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            print("reproduce: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        sets = SETS if args.set == "all" else (args.set,)
        run_presets(plan(sets, args.quick, args.N), args.out, device=args.device,
                    log=lambda m: print(m, flush=True), commit=args.commit)
    for name, summary in write_reports(args.out).items():
        print(f"wrote {os.path.join(args.out, name)}"
              + (f": {summary}" if isinstance(summary, str) else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
