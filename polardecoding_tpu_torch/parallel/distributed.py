"""Multi-process runtime and the scaling benchmark (torch.distributed
counterpart of polardecoding_tpu.parallel.distributed).

  - `init_distributed()` joins the default process group from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    then parallel/mesh.data_mesh() is the mesh of every rank and the
    harness's runners split each step's global batch over it.
  - Payloads and noise are pure functions of (seed, global frame index), so
    W ranks decode the frames one process decodes at the same global batch
    and give its counters bit for bit.
  - `scaling_bench` measures frames/s at increasing rank counts.  The only
    traffic is a few int64 counters a step.  Its records also say how many
    cards the ranks ran on: ranks that share one card measure no scaling.

  torchrun --nproc-per-node <gpus> -m polardecoding_tpu_torch.cli scale --distributed
"""
from __future__ import annotations

import datetime
import os
import socket
import time
import zlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from polardecoding_tpu_torch.configs import Preset
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel.harness import make_frame_step, make_wave_step
from polardecoding_tpu_torch.parallel.mesh import DataMesh, data_mesh

# a collective that waits longer than this fails instead of hanging
TIMEOUT_S = 600.0


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S):
    """Join the default process group; a no-op at world size 1.  Arguments
    left None come from torchrun's environment (WORLD_SIZE, RANK; the
    address from MASTER_ADDR and MASTER_PORT through init_method "env://").
    The backend is nccl where a card is present and gloo on the CPU; with
    nccl the rank's current card is cuda:LOCAL_RANK % device_count()."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _card_id(device: torch.device) -> int:
    """An id of the card a rank computes on (its host and index), -1 on the
    CPU."""
    if device.type != "cuda":
        return -1
    index = torch.cuda.current_device() if device.index is None else device.index
    return (zlib.crc32(socket.gethostname().encode()) << 8) | index


def _max_over(world: DataMesh, *values: float) -> list[float]:
    """Each value's largest over the ranks of `world`, the same on every
    rank: one max-reduction, which is also the barrier that the ranks
    outside a subgroup wait at (they give 0)."""
    if world.group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.group)
    return t.tolist()


def scaling_bench(
    preset: Preset,
    device_counts: Optional[Sequence[int]] = None,
    batch_per_device: int = 1024,
    snr_db: float = 2.0,
    steps: int = 4,
    warmup: int = 2,
    engine: str = "frame",
    wave_iters: int = 8,
    device=None,
):
    """frames/s at each rank count -> a list of records, the same on every
    rank, with efficiency relative to the first count's rate per rank.

    Counts are powers of two up to the world size (default), each run on a
    subgroup of the first nd ranks (every rank makes it; the others wait)
    at the global batch batch_per_device * nd.  engine="frame" times
    make_frame_step; engine="wave" the fused wave engine (make_wave_step)
    in chunks of 4 steps with the retired frames summed on the device,
    whose rate is retired frames/s ("retired_frames" in its records).  The
    wall time is the slowest rank's.  "cards" counts the distinct cards of
    the subgroup's ranks (0 on the CPU): where it is below "devices", ranks
    share a card and the efficiency is no scaling figure.  device: the
    ranks' device (default: the card)."""
    if engine not in ("frame", "wave"):
        raise ValueError(f"unknown engine {engine!r}")
    world = data_mesh(device=device)
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world.size]
    sigma = 10.0 ** (-snr_db / 20.0)
    out = []
    base_rate = None
    for nd in device_counts:
        if nd > world.size:
            raise ValueError(f"{nd} ranks asked of a world of {world.size}")
        group = (None if world.group is None
                 else dist.new_group(ranks=list(range(nd))))
        dt, frames, cards = 0.0, 0, 0
        if world.rank < nd:
            mesh = (world if group is None
                    else DataMesh(world.rank, nd, group, world.device))
            key = prng_key(preset.sweep.seed, mesh.device)
            batch = batch_per_device * nd
            if engine == "wave":
                dt, frames = _time_waves(preset, batch, wave_iters, mesh, key,
                                         sigma, steps, warmup)
            else:
                dt, frames = _time_frames(preset, batch, mesh, key, sigma,
                                          steps, warmup)
            ids = mesh.gather(torch.tensor([_card_id(mesh.device)],
                                           device=mesh.device))
            cards = len({i for i in ids.reshape(-1).tolist() if i >= 0})
        dt, frames, cards = _max_over(world, dt, frames, cards)
        rate = frames / dt
        if base_rate is None:
            # per-rank baseline, so efficiency is right when the first
            # count is above 1
            base_rate = rate / nd
        rec = {
            "devices": nd,
            "frames_per_sec": rate,
            "efficiency": (rate / (base_rate * nd)) if base_rate else None,
            "engine": engine,
            "cards": int(cards),
        }
        if engine == "wave":
            rec["retired_frames"] = int(frames)
        out.append(rec)
    return out


def _time_frames(preset, batch, mesh, key, sigma, steps, warmup):
    """(wall s, frames) of `steps` frame steps after `warmup`."""
    step = make_frame_step(preset, batch, mesh.device, mesh=mesh)
    for i in range(warmup):
        int(step(key, i * batch, sigma)[0])
    t0 = time.perf_counter()
    outs = [step(key, (warmup + i) * batch, sigma) for i in range(steps)]
    int(sum(o[0] for o in outs))
    return time.perf_counter() - t0, steps * batch


def _time_waves(preset, batch, wave_iters, mesh, key, sigma, steps, warmup):
    """(wall s, retired frames) of `steps` chunks of the fused wave engine
    after `warmup` chunks; 4 steps a chunk, as the JAX package's scan."""
    init, step, _ = make_wave_step(preset, batch, wave_iters, mesh.device,
                                   mesh=mesh)
    spc = 4

    def chunk(carry):
        total = 0
        for _ in range(spc):
            carry, (_, _, fr) = step(key, sigma, carry)
            total = total + fr
        return carry, total

    carry = init(key, 0, sigma)
    last = None
    for _ in range(warmup):
        carry, last = chunk(carry)
    if last is not None:
        int(last)
    t0 = time.perf_counter()
    frs = []
    for _ in range(steps):
        carry, fr = chunk(carry)
        frs.append(fr)
    retired = int(sum(frs))
    return time.perf_counter() - t0, retired
