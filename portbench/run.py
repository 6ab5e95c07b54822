"""The benchmark of polardecoding_tpu_torch (the PyTorch and CUDA port) on
NVIDIA H100 cards: one run of one cell of BENCHMARK.json.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up imports the program, loads its
kernels from the build cache in the checkout and Python's bytecode from
.portbench_cache/pycache there (the first run of a checkout compiles both),
builds the cell's frame step once (an early-stop configuration's points
build their own wave steppers, as run_point does: portbench/entry.py) and
runs the mix's warm-up steps.  The window is a closed loop of BLER points, each one call of the
program's run_point with that step, until --seconds have passed; the point
in flight then runs to its end.  Afterwards the calls drawn from --seed are
compared with the configuration's plain reference (portbench/check.py,
portbench/wave_check.py).  With
--trace 1 the mix's traced points run under torch.profiler and the cell's
per-layer metrics are printed instead of its end-to-end ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, then card (the card's
name and power limit) and, last, compared (each number the check compared,
with its limit); the same numbers are the last lines of standard error.
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; if jax, jaxlib, flax or polardecoding_tpu (the JAX
package) is loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Python's bytecode cache at a fixed path in the checkout: without it a
# machine that sets PYTHONDONTWRITEBYTECODE, and has none for torch,
# compiles torch's sources again in every run's set-up
PYCACHE = os.path.join(ROOT, ".portbench_cache", "pycache")
FORBIDDEN = ("jax", "jaxlib", "flax", "polardecoding_tpu")


def forbidden_modules(names=None) -> list:
    """The top-level names, compared whole, of the loaded modules (or of
    `names`) that are JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name (torch) and power limit (nvidia-smi)."""
    import torch

    info = {"name": "cpu", "power_limit": "not measured"}
    if device.type == "cuda":
        info["name"] = torch.cuda.get_device_name(device)
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--id={device.index or 0}",
                 "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True)
            info["power_limit"] = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return info


def point_quantile(window, q: float) -> float:
    """The q-quantile (inclusive, linear between ranks) of the complete
    points' wall times, start to return."""
    ts = [p.t1 - p.t0 for p in window.points if p.result is not None]
    if len(ts) < 2:
        return ts[0]
    return statistics.quantiles(ts, n=100, method="inclusive")[round(q * 100) - 1]


# the end-to-end metrics, taken by the harness on the host's clock
END_TO_END = {
    "frames_per_s": lambda w, setup_s: (
        sum(p.result.frames for p in w.points if p.result is not None) / w.seconds),
    "point_s_p95": lambda w, setup_s: point_quantile(w, 0.95),
    "setup_s": lambda w, setup_s: setup_s,
}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_proc: float, grace: float = 30.0, marks=()) -> dict:
    """One run of `cell` (spec.Cell) on `device`: the result object, without
    the final checks of the process.  `marks`: (phase, end time) of the
    set-up's phases before the call, printed with the later ones."""
    import torch

    marks = list(marks)
    from portbench import entry, tracing
    from portbench.context import Context
    from portbench.spec import metric_reader
    from portbench.traffic import Traffic
    import polardecoding_tpu_torch.parallel.harness  # noqa: F401

    marks.append(("imports", time.perf_counter()))
    device = torch.device(device)
    traffic = Traffic(cell.traffic, seed)
    # the reference first: a configuration that it refuses never runs
    reference = entry.reference(cell.config, device)
    check = entry.checker(cell.config)
    prog = entry.program(cell.config, traffic.batch, device)
    marks.append(("step built", time.perf_counter()))
    prog.warm(traffic)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_proc
    phases, t = [], t_proc
    for name, t1 in marks:
        phases.append(f"{name} {t1 - t}")
        t = t1
    win = prog.window(traffic, seconds, trace=trace, grace=grace)
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    reduced = tracing.reduce(win.profile) if win.profile is not None else None
    win.profile = None
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    info = card(device)
    compared, picks, failed = check.compare(win, traffic, reference, seed)
    done = [p for p in win.points if p.result is not None]
    print(f"portbench {cell.name}: seed {seed}, {len(win.points)} points "
          f"({len(done)} complete), {len(win.steps)} steps in {win.seconds} s, "
          f"set-up {setup_s} s ({', '.join(phases)}), median point "
          f"{statistics.median([p.t1 - p.t0 for p in done]) if done else None} s, "
          f"host ms a step {1e3 * sum(s.t1 - s.t0 for s in win.steps) / max(len(win.steps), 1)}, "
          f"checked steps {picks}, {info['name']} at {info['power_limit']}",
          file=sys.stderr)
    if win.error:
        print(f"portbench {cell.name}: the window failed: {win.error}", file=sys.stderr)

    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": info["name"], "count": 1, "memory_peak_bytes": peak}
    out = {"correct": check.correct(compared) and not win.error,
           "attempted": len(win.points), "failed": failed}
    if trace:
        ctx = Context(cell.config, traffic, win, reduced, reference, info)
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if reduced is not None:
            dev["busy_s"] = reduced.busy_s
            dev["window_s"] = reduced.window_s
            out["breakdown"] = {"device_ops": reduced.device_ops(),
                                "idle_gaps": reduced.idle_gaps()}
    elif done:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": END_TO_END[m["name"]](win, setup_s),
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = dev
    out["card"] = info
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False

    import torch

    from portbench.spec import load_cell

    marks = [("torch", time.perf_counter())]
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda:0")  # the CUDA context, timed as its own phase
    marks.append(("CUDA context", time.perf_counter()))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T_PROC, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: the benchmark measures "
              "the port alone", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
