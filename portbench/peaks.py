"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a kernel's work
could take at them.

HBM: 3.35 TB/s.  Float32 outside the tensor cores: 67 TFLOP/s counts an
FMA as two operations (132 SMs x 128 lanes x 1.98 GHz x 2); the decoders'
operations are adds, compares, selects, mins, abs and xors, of which a lane
issues one per clock, so their peak is half: 33.5e12 per second.  INT32:
132 SMs x 64 lanes x 1.98 GHz.  The port's kernels are built with
-fmad=false, so no FMA is hidden in these counts."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
INT_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds(nbytes: float, ops: float, int_ops: float = 0.0) -> float:
    """The larger of the times to move nbytes through HBM and to issue ops
    operations, int_ops of them on the integer lanes."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S,
               int_ops / INT_OPS_PER_S)
