"""The readings that the check's limits are set from, for one cell, in one
process: the program's gaps on each of --seeds (the lower reading: a sound
run reads 0), and the control's on each of --control-seeds (the upper
reading): the plain reference computed in bfloat16, the precision below
the configured float32, put in the program's place.

    python3 -m portbench.control --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

Each seed runs a window of --seconds at the cell's own load through the
program, and the configuration's check (portbench/entry.py) draws its
steps from it as a run does.  For a control seed the numbers compared are
the bfloat16 reference's on those steps against the float32 reference's,
each held to its limit in the check's LIMITS: a control seed has to come
out not correct.  One JSON line a seed, with its `correct`, then a
summary line.  Needs a CUDA card; with --device cpu it runs on the CPU
(test sizes)."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import entry
from portbench.spec import load_cell
from portbench.traffic import Traffic

CONTROL_DTYPE = torch.bfloat16


def readings(cell, seeds, control_seeds, seconds: float, device) -> list:
    """[{"seed", "kind": "program" or "control", "gaps": {name: value},
    "correct"}]: `correct` as check.correct decides it from the gaps and
    check.LIMITS, for the control as if its counters were the program's."""
    device = torch.device(device)
    reference = entry.reference(cell.config, device)
    check = entry.checker(cell.config)
    prog = entry.program(cell.config, Traffic(cell.traffic, 0).batch, device)
    prog.warm(Traffic(cell.traffic, 0))
    out = []
    for kind, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            traffic = Traffic(cell.traffic, seed)
            win = prog.window(traffic, seconds)
            t0 = time.perf_counter()
            if kind == "program":
                compared, picks, _ = check.compare(win, traffic, reference, seed)
            else:
                compared, picks = check.control(win, traffic, reference, seed,
                                                CONTROL_DTYPE)
            line = {"seed": seed, "kind": kind,
                    "gaps": {k: v for k, (v, _) in compared.items()},
                    "correct": check.correct(compared), "picks": picks,
                    "points": len(win.points), "check_s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def summarize(rows: list, limits: dict) -> dict:
    """Each gap's least and largest reading, and the verdicts, by kind."""
    summary = {}
    for kind in ("program", "control"):
        for name in limits:
            vals = [r["gaps"][name] for r in rows if r["kind"] == kind and name in r["gaps"]]
            if vals:
                summary[f"{kind}.{name}"] = {"min": min(vals), "max": max(vals),
                                             "n": len(vals)}
        verdicts = [r["correct"] for r in rows if r["kind"] == kind]
        if verdicts:
            summary[f"{kind}.correct"] = {"true": sum(verdicts),
                                          "false": len(verdicts) - sum(verdicts)}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = readings(cell, args.seeds, args.control_seeds, args.seconds, args.device)
    summary = summarize(rows, entry.checker(cell.config).LIMITS)
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "card": torch.cuda.get_device_name() if torch.cuda.is_available()
                      else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
