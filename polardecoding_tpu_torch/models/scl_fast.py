"""Static node decomposition of the SCL code tree on the frozen mask (torch
port of the host half of polardecoding_tpu/ops/pallas/scl_fast_kernel.py:
`_Node`, `decompose`, `schedule_stats`), and the per-leaf table through
which the plain SCL and the CUDA list-decode kernel find the approximate
rate-1 (R1) nodes.

The tree collapses maximal aligned all-frozen blocks (R0) and repetition
blocks (REP), and with r1min > 0 all-info blocks of width >= max(r1min, 2)
(R1); every other region becomes LOOP nodes of width <= wloop or a branch.
R0, REP and LOOP nodes decode exactly as bit-by-bit SCL does, so only the
R1 nodes change what is computed: each decides its whole block at once by
the bounded-fork rate-1 rule (models/scl._r1_node).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class _Node:
    kind: str  # "r0" | "rep" | "r1" | "loop" | "branch"
    stage: int
    off: int  # leaf offset
    has_frozen: bool = False  # loop only
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None


def decompose(frozen: Tuple[bool, ...], stage: int, off: int,
              wloop: int, r1min: int = 0) -> _Node:
    """The node of width 2^stage at leaf `off`, checked in this order: R0,
    REP, R1 (only with r1min > 0), LOOP (width <= wloop), else a branch of
    two halves."""
    w = 1 << stage
    blk = frozen[off : off + w]
    if all(blk):
        return _Node("r0", stage, off)
    if w >= 2 and all(blk[:-1]) and not blk[-1]:
        return _Node("rep", stage, off)
    if r1min and w >= max(r1min, 2) and not any(blk):
        return _Node("r1", stage, off)
    if w <= wloop:
        return _Node("loop", stage, off, has_frozen=any(blk))
    h = w // 2
    return _Node(
        "branch", stage, off,
        left=decompose(frozen, stage - 1, off, wloop, r1min),
        right=decompose(frozen, stage - 1, off + h, wloop, r1min),
    )


def schedule_stats(frozen: Tuple[bool, ...], wloop: int = 4) -> dict:
    """Node counts of the exact schedule (r1min = 0)."""
    n = len(frozen).bit_length() - 1
    counts = {"r0": 0, "rep": 0, "loop": 0, "branch": 0, "loop_frozen": 0}

    def walk(nd):
        counts[nd.kind] += 1
        if nd.kind == "loop" and nd.has_frozen:
            counts["loop_frozen"] += 1
        if nd.kind == "branch":
            walk(nd.left)
            walk(nd.right)

    walk(decompose(frozen, n, 0, wloop))
    return counts


def r1_stages(frozen, r1min: int, wloop: int) -> list[int]:
    """Per leaf: the stage s of the R1 node whose first leaf it is, else 0
    (an R1 node has width >= 2, so s >= 1).  Empty nodes for r1min = 0."""
    frozen = tuple(bool(b) for b in frozen)
    N = len(frozen)
    stages = [0] * N
    if not r1min:
        return stages

    def walk(nd):
        if nd.kind == "r1":
            stages[nd.off] = nd.stage
        elif nd.kind == "branch":
            walk(nd.left)
            walk(nd.right)

    walk(decompose(frozen, N.bit_length() - 1, 0, wloop, r1min))
    return stages
