"""The one traffic generator: a closed loop of BLER points read from a
traffic file (portbench/traffic/<name>.json).

A point is one call of the program's run_point: an adaptive Monte-Carlo
run at the mix's SNR to `error_blocks` block errors, in steps of `batch`
frames; the next point starts when the last returns.  The points come
from a fixed pool of `pool.points`: pool point k runs under the seed
pool.base_seed + k.  A run visits the pool in an order that --seed draws,
one fresh permutation per pass: every run does the same set of points in
another order, so the seed does not change the work a window holds.
Frames are pure in (point seed, frame index), so the same point is the
same work on any commit.

Keys of the file:
  snr_db        the SNR, in dB;
  batch         frames a step;
  error_blocks  the point's stop rule;
  pool          {"base_seed", "points"};
  warmup_steps  steps run in set-up at the cell's shapes, not timed;
  check         {"final_steps", "other_steps"}: the steps the correctness
                check samples from the seed, among the points' last steps
                (which hold an error) and among all the others;
  trace         {"from_point", "points"}: the points a --trace 1 run
                profiles.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KEYS = {"snr_db", "batch", "error_blocks", "pool", "warmup_steps",
        "check", "trace"}


@dataclasses.dataclass(frozen=True)
class Point:
    index: int
    seed: int
    snr_db: float
    batch: int
    error_blocks: int


class Traffic:
    """The points of one run: `point(i)` for i = 0, 1, ..."""

    def __init__(self, params: dict, seed: int):
        unknown = set(params) - KEYS
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        self.snr_db = float(params["snr_db"])
        self.batch = int(params["batch"])
        self.error_blocks = int(params["error_blocks"])
        self.base = int(params["pool"]["base_seed"])
        self.size = int(params["pool"]["points"])
        self.warmup_steps = int(params.get("warmup_steps", 2))
        self.check = dict(params["check"])
        self.trace = dict(params["trace"])
        if min(self.batch, self.error_blocks, self.size) < 1:
            raise ValueError("batch, error_blocks and pool.points must be >= 1")
        self.seed = int(seed)
        self.rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x7AFF1C])
        self._order: list[int] = []

    def point(self, i: int) -> Point:
        while len(self._order) <= i:
            self._order.extend(int(k) for k in self.rng.permutation(self.size))
        return Point(i, self.base + self._order[i], self.snr_db, self.batch,
                     self.error_blocks)
