"""Two processes count one sweep through torch.distributed (gloo, on the
CPU): their global counters equal the port's one process and the JAX
package's single-process 8-device mesh at the same global batch, as
tests/test_distributed.py holds the JAX package's two processes to its one.

Each worker is this file run as a script (no JAX is imported there):

  python tests/test_torch_distributed.py <store> <world size> <rank> <out>

It joins a gloo group through a FileStore, runs every path of `port_runs`
on the default group's mesh and writes what it counted as JSON.  The
workers start first and run while this process computes the one-rank and
the JAX references; every wait has a timeout, so ranks that disagree fail
instead of hanging.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SIGMA = float(np.float32(10.0 ** (-2.0 / 20.0)))
WORKER_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 120
MULTISNR = [1.0, 2.0, 3.0, 4.0, 5.0]  # 5 SNRs, a batch of 48
SWEEP = dict(batch=32, snr_points=[2.5, 3.5])


def _point(res) -> dict:
    d = dataclasses.asdict(res)
    d.pop("elapsed_s")
    return d


def _ints(values) -> list:
    return [v.tolist() if hasattr(v, "tolist") else int(v) for v in values]


def _wave_rows(init, step, drain, key, sigma, steps, batch):
    """Per-step counters of `steps` steps, then each drain step's until
    none remains."""
    carry = init(key, 0, sigma)
    rows, tail = [], []
    for _ in range(steps):
        carry, out = step(key, sigma, carry)
        rows.append(_ints(out))
    remaining = batch
    while remaining > 0:
        carry, out = drain(sigma, carry)
        tail.append(_ints(out))
        remaining = tail[-1][3]
        assert len(tail) < 40, "drain did not end"
    return {"steps": rows, "drain": tail}


def _es_preset(cfg):
    """BP_128 with early stop: run_point takes the wave engine."""
    p = cfg.preset("BP_128")
    return dataclasses.replace(p, name="BP_128_ES", decoder=dataclasses.replace(
        p.decoder, bp_early_stop=True))


def port_runs(mesh, workdir) -> dict:
    """Every path on `mesh` (device and all), as JSON-ready counters."""
    import torch

    from polardecoding_tpu_torch import configs as cfg
    from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
    from polardecoding_tpu_torch.parallel import harness as h

    dev = mesh.device
    out = {}
    step = h.make_frame_step(cfg.preset("SC_128"), 32, dev, mesh=mesh)
    out["frame"] = [_ints(step(prng_key(7, dev), s, SIGMA)) for s in (0, 32)]
    p = cfg.preset("BP_128")
    for fused in (False, True):
        out[f"wave_fused={fused}"] = _wave_rows(
            *h.make_wave_step(p, 32, 8, dev, fused=fused, mesh=mesh),
            prng_key(p.sweep.seed, dev), SIGMA, 3, 32)
    for noise in ("threefry", "kernel"):
        step = h.make_frame_step(p, 32, dev, channel="mc", noise=noise,
                                 mesh=mesh)
        out[f"mc_{noise}"] = [_ints(step(prng_key(4, dev), s, SIGMA))
                              for s in (0, 64)]
    step = h.make_multisnr_step(cfg.preset("SC_128"), 48, len(MULTISNR), dev,
                                mesh=mesh)
    sigmas = torch.tensor([10.0 ** (-s / 20.0) for s in MULTISNR],
                          dtype=torch.float32, device=dev)
    out["multisnr"] = [_ints(step(prng_key(3, dev), s, sigmas)) for s in (0, 48)]
    pr = cfg.preset("BPr_128")
    eb, ebl, E = h.make_bpr_step(pr, 32, dev, mesh=mesh)(
        fold_in(prng_key(pr.sweep.seed, dev), 200), 32, SIGMA)
    out["bpr"] = {"errbit": int(eb), "errblock": int(ebl), "E": E.tolist()}
    out["run_point"] = _point(h.run_point(cfg.preset("SC_128"), 2.5, batch=32,
                                          error_blocks=6, mesh=mesh))
    out["run_point_es"] = _point(h.run_point(_es_preset(cfg), 2.0, batch=32,
                                             error_blocks=4, max_frames=64,
                                             mesh=mesh))
    ck = os.path.join(workdir, "ck.json")
    first = h.run_sweep(cfg.preset("SC_128"), error_blocks=2,
                        checkpoint_path=ck, mesh=mesh, **SWEEP)
    with open(ck) as f:
        written = json.load(f)
    again = h.run_sweep(cfg.preset("SC_128"), error_blocks=5,
                        checkpoint_path=ck, mesh=mesh, **SWEEP)
    out["sweep"] = {"first": [_point(r) for r in first],
                    "written": [{k: v for k, v in r.items() if k != "elapsed_s"}
                                for r in written],
                    "resumed": [_point(r) for r in again]}
    return out


def worker(store, world, rank, path):
    """One rank: join the group, count every path, write the JSON."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel import harness
    from polardecoding_tpu_torch.parallel.distributed import (init_distributed,
                                                              scaling_bench)
    from polardecoding_tpu_torch.parallel.mesh import data_mesh

    init_distributed(f"file://{store}", world, rank, backend="gloo",
                     timeout_s=GROUP_TIMEOUT_S)
    mesh = data_mesh(device="cpu")
    # count the checkpoint's writes: rank 0 alone writes
    writes = []
    dump = harness.json.dump
    harness.json.dump = lambda obj, f, **kw: (writes.append(f.name),
                                              dump(obj, f, **kw))[1]
    workdir = os.path.dirname(store)
    out = port_runs(mesh, workdir)
    harness.json.dump = dump
    out["checkpoint_writes"] = len(writes)
    out["scale"] = {
        "frame": scaling_bench(preset("SC_128"), device_counts=[1, 2],
                               batch_per_device=16, steps=1, warmup=1,
                               device="cpu"),
        "wave": scaling_bench(preset("BP_128"), device_counts=[1, 2],
                              batch_per_device=16, steps=2, warmup=1,
                              engine="wave", device="cpu")}
    out["mesh"] = [mesh.rank, mesh.size]
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith("polardecoding_tpu."))
    with open(path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def jax_runs(workdir) -> dict:
    """The JAX package's counters of port_runs' paths on its single-process
    mesh over the 8 virtual CPU devices (tests/conftest.py)."""
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu import configs as cfg
    from polardecoding_tpu.parallel import harness as h
    from polardecoding_tpu.parallel.mesh import data_mesh

    mesh = data_mesh()
    assert mesh.devices.size == 8
    sigma = jnp.float32(SIGMA)
    out = {}
    step = h.make_frame_step(cfg.preset("SC_128"), 32, mesh)
    out["frame"] = [_ints(step(jax.random.PRNGKey(7), jnp.int32(s), sigma))
                    for s in (0, 32)]
    p = cfg.preset("BP_128")
    for fused in (False, True):
        out[f"wave_fused={fused}"] = _wave_rows(
            *h.make_wave_step(p, 32, 8, mesh, fused=fused),
            jax.random.PRNGKey(p.sweep.seed), sigma, 3, 32)
    step = h.make_frame_step(p, 32, mesh, channel="mc")
    out["mc_threefry"] = [_ints(step(jax.random.PRNGKey(4), jnp.int32(s), sigma))
                          for s in (0, 64)]
    step = h.make_multisnr_step(cfg.preset("SC_128"), 48, len(MULTISNR), mesh)
    sigmas = jnp.asarray([10.0 ** (-s / 20.0) for s in MULTISNR], jnp.float32)
    out["multisnr"] = [_ints(step(jax.random.PRNGKey(3), jnp.int32(s), sigmas))
                       for s in (0, 48)]
    pr = cfg.preset("BPr_128")
    eb, ebl, E = h.make_bpr_step(pr, 32, mesh)(
        jax.random.fold_in(jax.random.PRNGKey(pr.sweep.seed), 200),
        jnp.int32(32), sigma)
    out["bpr"] = {"errbit": int(eb), "errblock": int(ebl),
                  "E": jax.device_get(E).tolist()}
    out["run_point"] = _point(h.run_point(cfg.preset("SC_128"), 2.5, batch=32,
                                          mesh=mesh, error_blocks=6))
    ck = os.path.join(workdir, "ck_jax.json")
    first = h.run_sweep(cfg.preset("SC_128"), mesh=mesh, error_blocks=2,
                        checkpoint_path=ck, **SWEEP)
    again = h.run_sweep(cfg.preset("SC_128"), mesh=mesh, error_blocks=5,
                        checkpoint_path=ck, **SWEEP)
    out["sweep"] = {"first": [_point(r) for r in first],
                    "resumed": [_point(r) for r in again]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' JSON, the port's one-rank run, the JAX run)."""
    from polardecoding_tpu_torch.parallel.mesh import one_rank

    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs, paths = [], []
    for rank in range(WORLD):
        paths.append(tmp / f"rank{rank}.json")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp / "store"),
             str(WORLD), str(rank), str(paths[-1])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        one = tmp / "one"
        one.mkdir()
        single = port_runs(one_rank("cpu"), str(one))
        jx = tmp / "jax"
        jx.mkdir()
        want = jax_runs(str(jx))
        ranks = []
        for proc, path in zip(procs, paths):
            out, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
            assert proc.returncode == 0, f"rank failed:\n{out}\n{err}"
            with open(path) as f:
                ranks.append(json.load(f))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ranks, single, want


def test_ranks_agree_and_import_no_jax(runs):
    """Both ranks return the same global counters (each step's collective
    makes them global), on a mesh of two, without JAX; rank 0 alone wrote
    the checkpoint, once a point and run."""
    ranks, _, _ = runs
    a, b = ranks
    assert a["mesh"] == [0, 2] and b["mesh"] == [1, 2]
    assert a["jax_loaded"] == [] and b["jax_loaded"] == []
    assert a["checkpoint_writes"] == 2 * len(SWEEP["snr_points"])
    assert b["checkpoint_writes"] == 0
    for key in a:
        if key not in ("mesh", "checkpoint_writes", "scale"):
            assert a[key] == b[key], key


@pytest.mark.parametrize("key", ["frame", "wave_fused=False", "wave_fused=True",
                                 "mc_threefry", "multisnr", "bpr", "run_point"])
def test_two_ranks_equal_one_rank_and_jax(runs, key):
    """SC_128's frame step (B=32, 2 steps), BP_128's unfused and fused wave
    steps (B=32, K=8, 3 steps and the drain to 0: the global refill order),
    the MC-channel frame step with jax.random.bits noise, the multi-SNR
    step (5 SNRs, B=48), BPr_128's stage-error table and run_point to an
    error-block stop: two ranks equal to one rank and to JAX's 8-device
    mesh."""
    ranks, single, want = runs
    assert ranks[0][key] == single[key] == want[key]


def test_mc_kernel_noise_two_ranks_equal_one_rank(runs):
    """The MC channel's counter noise: a rank draws its rows of the global
    batch (the first-row argument), so two ranks count the frames of one."""
    ranks, single, _ = runs
    assert ranks[0]["mc_kernel"] == single["mc_kernel"]
    assert ranks[0]["mc_kernel"] != ranks[0]["mc_threefry"]


def test_run_point_wave_engine_two_ranks_equal_one_rank(runs):
    """An early-stop preset's run_point (the fused wave engine, chunks of
    SYNC_EVERY, the lookahead and the drain) stops both ranks at one frame
    count, that of one rank."""
    ranks, single, _ = runs
    assert ranks[0]["run_point_es"] == single["run_point_es"]
    assert ranks[0]["run_point_es"]["frames"] > 64


def test_run_sweep_checkpoint_written_once_and_resumed(runs):
    """run_sweep's checkpoint: the two ranks' records equal one rank's and
    JAX's, the file holds the first run's records, and the second run
    resumes each point from it."""
    ranks, single, want = runs
    got = ranks[0]["sweep"]
    assert got == single["sweep"]
    assert {k: got[k] for k in ("first", "resumed")} == want["sweep"]
    assert got["written"] == [dict(r, bler=r["errblock"] / r["frames"],
                                   ber=r["errbit"] / (r["frames"] * 64))
                              for r in got["first"]]
    for a, b in zip(got["first"], got["resumed"]):
        assert b["frames"] > a["frames"] and b["errblock"] >= 5


@pytest.mark.parametrize("engine", ["frame", "wave"])
def test_scaling_bench_records(runs, engine):
    """scaling_bench at [1, 2] ranks: the records of
    tests/test_distributed.py, the same on both ranks, and the cards they
    ran on (none: the CPU)."""
    a, b = (r["scale"][engine] for r in runs[0])
    assert [r["devices"] for r in a] == [1, 2]
    for r, s in zip(a, b):
        assert r == s
        assert r["engine"] == engine and r["cards"] == 0
        assert r["frames_per_sec"] > 0
        assert 0 < r["efficiency"] <= 2.0
        if engine == "wave":
            assert r["retired_frames"] >= 0


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
