"""The data mesh of the port: which slice of a global batch this process
counts, and the two collectives a step needs (torch.distributed counterpart
of polardecoding_tpu.parallel.mesh).

All distribution here is data parallelism over i.i.d. Monte-Carlo frames.
A mesh of W ranks splits a step's global batch B into W contiguous slices
of b = B / W: rank r owns the global lanes r·b .. r·b + b - 1, so its frames
are frame_start + r·b + arange(b) and its wave slots are those global
slots.  A frame is a pure function of (seed, global frame index), so the
split cannot change the decoded set.  The only traffic is a handful of
int64 counters a step: a sum over ranks (`sum`), or an all-gather of one
small vector per rank (`gather`) where a rank also needs the prefix of the
ranks before it (the wave engine's refill order).

A mesh without a process group is one rank with no collective at all: a
step built on it runs exactly the single-process code.  A mesh on a group,
even a group of one rank, runs every collective through the group's
backend (nccl on the card; gloo on the CPU, or on the card where several
ranks share it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """rank and size within `group` (None: one process, no collective), and
    the device the rank computes on."""

    rank: int
    size: int
    group: Optional[object]
    device: torch.device

    def lanes(self, batch: int) -> tuple[int, int]:
        """(first global lane, count) of this rank's slice of a global
        batch; ValueError unless the mesh's size divides the batch."""
        if batch % self.size:
            raise ValueError(f"batch {batch} is not a multiple of the mesh's "
                             f"{self.size} ranks (round_up_batch)")
        b = batch // self.size
        return self.rank * b, b

    def sum(self, *counters: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The counters (int64 tensors of any shapes, on the rank's device)
        summed over the ranks; without a group, the counters as they are."""
        if self.group is None:
            return counters
        flat = torch.cat([c.reshape(-1).to(torch.int64) for c in counters])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for c in counters:
            out.append(flat[at:at + c.numel()].reshape(c.shape))
            at += c.numel()
        return tuple(out)

    def gather(self, vec: torch.Tensor) -> torch.Tensor:
        """Every rank's int64 vector [k], as [size, k] in rank order."""
        vec = vec.to(torch.int64).reshape(-1)
        if self.group is None:
            return vec[None]
        parts = [torch.empty_like(vec) for _ in range(self.size)]
        dist.all_gather(parts, vec, group=self.group)
        return torch.stack(parts)

    def barrier(self):
        """Wait on the host until every rank has reached this point: a sum
        of one counter, read back (works on every backend and device)."""
        if self.group is not None:
            int(self.sum(torch.zeros((), dtype=torch.int64,
                                     device=self.device))[0])


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: `device` as given when it names an
    index or the CPU; for a bare "cuda" (the default) under
    torch.distributed, cuda:LOCAL_RANK % device_count(), so that several
    ranks may share one card."""
    device = torch.device("cuda" if device is None else device)
    if (device.type == "cuda" and device.index is None
            and dist.is_available() and dist.is_initialized()):
        count = torch.cuda.device_count()
        if count:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local % count)
    return device


def one_rank(device=None) -> DataMesh:
    """The mesh of one process without a group: no collective."""
    return DataMesh(0, 1, None, torch.device("cuda" if device is None else device))


def data_mesh(group=None, device=None) -> DataMesh:
    """The mesh of `group` (default: the default process group) when
    torch.distributed is initialised, else the one-rank mesh on `device`:
    the counterpart of the JAX package's mesh over every device."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group needs torch.distributed "
                             "initialised (init_distributed)")
        return one_rank(device)
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    return DataMesh(rank, dist.get_world_size(group), group,
                    rank_device(device))


def round_up_batch(batch: int, mesh: DataMesh) -> int:
    """Round the per-step global batch up to a multiple of the mesh size."""
    n = mesh.size
    return ((batch + n - 1) // n) * n
