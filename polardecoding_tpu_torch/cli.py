"""Command-line interface of the port (the JAX package's cli and its
subcommands), with structured JSON results.

  python -m polardecoding_tpu_torch.cli run --preset BP_1024 --snr 1.0 3.0 0.5
  python -m polardecoding_tpu_torch.cli run --preset BP_128 --out bp128.json
  python -m polardecoding_tpu_torch.cli run --preset SCL_1024_L8 --seeds 1 2 3
  python -m polardecoding_tpu_torch.cli bpr --preset BPr_128 --snr 2.0
  python -m polardecoding_tpu_torch.cli analyze --tool bprga --N 128 --K 64 --snr 1.0 4.0 0.5
  python -m polardecoding_tpu_torch.cli plot --out curves.png bp128.json ...
  python -m polardecoding_tpu_torch.cli bench --preset BP_1024 --batch 4096
  python -m polardecoding_tpu_torch.cli scale --preset BP_1024
  torchrun --nproc-per-node <gpus> -m polardecoding_tpu_torch.cli scale --distributed
  python -m polardecoding_tpu_torch.cli presets

`run`, `bpr`, `bench` and `scale` compute on the card; `--device cpu` runs
the plain PyTorch versions instead of the CUDA kernels (slow; for checks
at small sizes).  Under torchrun with more than one process, `run`, `bpr`
and `bench` join the process group and split each step's global batch
(`--batch`) over the ranks; rank 0 alone prints, writes `--out` and the
checkpoint.  `scale` prints parallel/distributed.scaling_bench's records,
frames/s at 1, 2, 4, ... ranks (`--distributed` joins the group first).  `run --seeds` replicates the sweep over seeds and prints the
per-seed records and their pooled average.  `bpr` prints, per SNR point,
the BLER and the reference's stage-error table E / frames at each
checkpoint.  `bench` prints {"preset", "frames_per_sec"}: the frame step's
frames/s (bench.bench_step, 5 steps after 2 of warmup).  `analyze` prints
a DE-GA prediction (analysis/dega.py) per SNR point and `plot` writes a
BLER plot of `run` records over the reference curves (plotting.py); both
run on the host and take no `--device`.
"""
from __future__ import annotations

import argparse
import json
import sys


def _join(device):
    """Join the process group when torchrun's environment says there is
    more than one process (gloo for --device cpu, else the default
    backend); returns whether this process prints (rank 0)."""
    import torch

    from polardecoding_tpu_torch.parallel.distributed import init_distributed

    init_distributed(backend="gloo" if torch.device(device).type == "cpu"
                     else None)
    return _lead()


def _lead():
    """Whether this process prints: rank 0, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _snr_list(args):
    if args.snr is None:
        return None
    if len(args.snr) == 1:
        return [args.snr[0]]
    start, stop = args.snr[0], args.snr[1]
    step = args.snr[2] if len(args.snr) > 2 else 0.5
    out, s = [], start
    while s <= stop + 1e-9:
        out.append(round(s, 6))
        s += step
    return out


def cmd_run(args):
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_multiseed, run_sweep

    lead = _join(args.device)
    p = preset(args.preset)
    log = (lambda m: print(m, file=sys.stderr)) if args.verbose else None
    if args.seeds:
        per_seed, averaged = run_multiseed(
            p, args.seeds, snr_points=_snr_list(args), batch=args.batch,
            error_blocks=args.error_blocks, max_frames=args.max_frames,
            device=args.device, log=log,
        )
        recs = {
            "averaged": averaged,
            "per_seed": {
                str(s): [r.to_json(p.code.num_info) for r in rs]
                for s, rs in per_seed.items()
            },
        }
    else:
        results = run_sweep(
            p,
            batch=args.batch,
            device=args.device,
            snr_points=_snr_list(args),
            error_blocks=args.error_blocks,
            max_frames=args.max_frames,
            seed=args.seed,
            checkpoint_path=args.checkpoint,
            log=log,
        )
        recs = [r.to_json(p.code.num_info) for r in results]
    if not lead:
        return
    text = json.dumps(recs, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


def cmd_analyze(args):
    import numpy as np

    from polardecoding_tpu_torch.analysis import dega

    snrs = _snr_list(args) or [1.0 + 0.5 * i for i in range(7)]
    out = {}
    for snr in snrs:
        if args.tool == "bpdega":
            r = dega.bpdega(args.N, args.K, snr, args.iters or 100)
            out[snr] = {"bler": r.bler, "ber": r.ber}
            continue
        if args.tool == "bprga":
            rows = dega.bprga(args.N, args.K, snr, args.iters or 28)
        elif args.tool == "bprga_allbit":
            rows = dega.bprga_allbit(args.N, args.K, snr, args.iters or 30)
        elif args.tool == "bprga_w":
            # N=1024 uses the BPRGA_1024_W.c window iterMax/snr
            ni = int((args.iters or 40) / snr) if args.N >= 1024 else None
            rows = dega.bprga_w(args.N, args.K, snr, args.iters or 32,
                                num_iters=ni)
        else:
            rows = dega.bprga_m(args.N, args.K, snr, args.iters or 32)
        out[snr] = {str(it): list(np.round(E, 6)) for it, E in rows.items()}
    print(json.dumps(out, indent=1))


def cmd_plot(args):
    from polardecoding_tpu_torch.plotting import load_records, plot_results

    recs = load_records(args.results)
    path = plot_results(recs, args.out, title=args.title)
    print(f"wrote {path}")


def cmd_bpr(args):
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import run_bpr_point

    lead = _join(args.device)
    p = preset(args.preset)
    out = {}
    for snr in _snr_list(args) or p.sweep.snr_points():
        res, E = run_bpr_point(
            p, snr, batch=args.batch or 256, device=args.device,
            error_blocks=args.error_blocks, max_frames=args.max_frames,
            seed=args.seed,
        )
        out[snr] = {
            "bler": res.bler,
            "frames": res.frames,
            "errblock": res.errblock,
            # the reference's table: E / run per checkpoint iteration
            # (BPr_128.c:229-255)
            "stage_errors_per_frame": (E / max(res.frames, 1)).round(6).tolist(),
            "checkpoints": list(p.decoder.bpr_checkpoints),
        }
    if lead:
        print(json.dumps(out, indent=1))


def cmd_bench(args):
    from polardecoding_tpu_torch.bench import bench_step

    lead = _join(args.device)
    fps = bench_step(args.preset, args.batch, device=args.device)
    if lead:
        print(json.dumps({"preset": args.preset,
                          "frames_per_sec": round(fps, 1)}))


def cmd_scale(args):
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.distributed import scaling_bench

    if args.distributed:
        _join(args.device)
    recs = scaling_bench(preset(args.preset),
                         batch_per_device=args.batch_per_device,
                         snr_db=args.snr_db, device=args.device)
    if _lead():
        print(json.dumps(recs, indent=1))


def cmd_presets(args):
    from polardecoding_tpu_torch.configs import PRESETS

    for name, p in sorted(PRESETS.items()):
        c, d = p.code, p.decoder
        extra = f" L={d.list_size}" if d.kind in ("scl", "cascl") else ""
        crc = f" crc={c.crc_style[:4]}-{c.r}" if c.crc else ""
        print(
            f"{name:22s} N={c.N:5d} K={c.K:4d} {c.graph:3s} {d.kind}{extra}{crc}"
            f"  <- {p.source}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="polardecoding_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="Monte-Carlo BLER sweep")
    rp.add_argument("--preset", required=True)
    rp.add_argument("--batch", type=int, default=None)
    rp.add_argument("--snr", type=float, nargs="*", default=None,
                    metavar="START [STOP [STEP]]")
    rp.add_argument("--error-blocks", type=int, default=None)
    rp.add_argument("--max-frames", type=int, default=None)
    rp.add_argument("--seed", type=int, default=None)
    rp.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="multi-seed replication: run each seed, report "
                         "per-seed records and the pooled average")
    rp.add_argument("--checkpoint", default=None)
    rp.add_argument("--out", default=None)
    rp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    rp.add_argument("-v", "--verbose", action="store_true")
    rp.set_defaults(fn=cmd_run)

    ana = sub.add_parser("analyze", help="DE-GA analytical prediction")
    ana.add_argument("--tool", required=True,
                     choices=["bpdega", "bprga", "bprga_allbit", "bprga_w",
                              "bprga_m"])
    ana.add_argument("--N", type=int, default=128)
    ana.add_argument("--K", type=int, default=64)
    ana.add_argument("--iters", type=int, default=None)
    ana.add_argument("--snr", type=float, nargs="*", default=None)
    ana.set_defaults(fn=cmd_analyze)

    br = sub.add_parser("bpr", help="BPr per-stage convergence instrumentation")
    br.add_argument("--preset", default="BPr_128")
    br.add_argument("--batch", type=int, default=None)
    br.add_argument("--snr", type=float, nargs="*", default=None)
    br.add_argument("--error-blocks", type=int, default=None)
    br.add_argument("--max-frames", type=int, default=None)
    br.add_argument("--seed", type=int, default=None)
    br.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    br.set_defaults(fn=cmd_bpr)

    pl = sub.add_parser("plot", help="plot result JSONs vs reference curves")
    pl.add_argument("results", nargs="+")
    pl.add_argument("--out", default="bler.png")
    pl.add_argument("--title", default=None)
    pl.set_defaults(fn=cmd_plot)

    bp = sub.add_parser("bench", help="throughput benchmark")
    bp.add_argument("--preset", default="BP_1024")
    bp.add_argument("--batch", type=int, default=4096)
    bp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    bp.set_defaults(fn=cmd_bench)

    sc = sub.add_parser("scale", help="scaling benchmark over ranks")
    sc.add_argument("--preset", default="BP_1024")
    sc.add_argument("--batch-per-device", type=int, default=1024)
    sc.add_argument("--snr-db", type=float, default=2.0)
    sc.add_argument("--distributed", action="store_true",
                    help="join the process group from torchrun's environment "
                         "first")
    sc.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    sc.set_defaults(fn=cmd_scale)

    ps = sub.add_parser("presets", help="list named presets")
    ps.set_defaults(fn=cmd_presets)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
