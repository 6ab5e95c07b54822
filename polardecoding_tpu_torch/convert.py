"""Carry state from the JAX package into the port.

`code_tables_from_numpy` turns a code's construction arrays (numpy, as the
JAX package or the port's own analysis/ builds them) into the tensors the
port's frame step runs on; `point_result_from_json` reads one record of a
`run_sweep` checkpoint (written by either package) back into a PointResult.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CodeTables:
    """A code's constant tables on one device."""

    frozen: torch.Tensor  # [N] bool, True on frozen bit channels
    info_set: torch.Tensor  # [K'] int64, the info positions in reference order
    pn: torch.Tensor  # [63] int8, one period of the PN payload sequence
    g_rows: torch.Tensor  # [K', N] float32 0/1, the info rows of F^{tensor n}


def code_tables_from_numpy(frozen, info_set, pn, g_rows, device) -> CodeTables:
    frozen = np.asarray(frozen, dtype=bool)
    info_set = np.asarray(info_set)
    g_rows = np.asarray(g_rows)
    N = frozen.shape[0]
    if frozen.ndim != 1 or N & (N - 1):
        raise ValueError(f"frozen must be a [N] mask with N a power of two, "
                         f"got shape {frozen.shape}")
    if set(info_set.tolist()) != set(np.flatnonzero(~frozen).tolist()):
        raise ValueError("info_set must list exactly the non-frozen positions")
    if g_rows.shape != (info_set.shape[0], N):
        raise ValueError(f"g_rows must be [K', N] = {(info_set.shape[0], N)}, "
                         f"got {g_rows.shape}")
    return CodeTables(
        frozen=torch.as_tensor(frozen, device=device),
        info_set=torch.as_tensor(info_set.astype(np.int64), device=device),
        pn=torch.as_tensor(np.asarray(pn, dtype=np.int8), device=device),
        g_rows=torch.as_tensor(g_rows.astype(np.float32), device=device),
    )


def point_result_from_json(rec: dict):
    """One `to_json` record back into a PointResult (bler and ber are
    derived, so they are not read)."""
    from polardecoding_tpu_torch.parallel.harness import PointResult

    return PointResult(
        rec["preset"], rec["snr_db"], rec["errbit"], rec["errblock"],
        rec["frames"], rec["seed"], rec.get("elapsed_s", 0.0),
        pm_ties=rec.get("pm_ties", 0),
    )
