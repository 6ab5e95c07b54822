"""The reference's check-node and path-metric arithmetic (SC_128.c:283-315,
SCL_1024.c:481-502): min-sum with the normative 8-bin correction table
delta(x), a piecewise-constant ln(1 + e^-x), in the operand order of the
C programs, in any float dtype."""
from __future__ import annotations

import functools

import torch

LUT_THRESHOLDS = (0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5)
LUT_VALUES = (0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0.0)


@functools.lru_cache(maxsize=None)
def _constants(dtype, device):
    def c(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return (tuple(map(c, LUT_THRESHOLDS)), tuple(map(c, LUT_VALUES)),
            c(1.0), c(-1.0))


def _tree(x, lo, hi, T, V):
    """Bin k iff T[k-1] <= x < T[k]: a value at a threshold falls in the
    upper bin."""
    if hi - lo == 1:
        return V[lo]
    mid = (lo + hi) // 2
    return torch.where(x >= T[mid - 1], _tree(x, mid, hi, T, V),
                       _tree(x, lo, mid, T, V))


def delta(x):
    """The correction table's value at x >= 0."""
    T, V, _, _ = _constants(x.dtype, x.device)
    return torch.broadcast_to(_tree(x, 0, len(LUT_VALUES), T, V), x.shape)


def table_zero(a, b):
    """Where delta(|a+b|) - delta(|a-b|) is +0 without the table: both at
    or above the last threshold."""
    last = _constants(a.dtype, a.device)[0][-1]
    return torch.minimum(torch.abs(a + b), torch.abs(a - b)) >= last


def chk(a, b):
    """sign(a) sign(b) min(|a|, |b|) + (delta(|a+b|) - delta(|a-b|)), with
    sign(0) = +1 and the table difference formed first."""
    _, _, one, minus_one = _constants(a.dtype, a.device)
    d = delta(torch.abs(a + b)) - delta(torch.abs(a - b))
    s = torch.where((a >= 0) == (b >= 0), one, minus_one)
    return s * torch.minimum(torch.abs(a), torch.abs(b)) + d


def phi_both(llr):
    """The path-metric increments (PHI(l, u=0), PHI(l, u=1)):
    delta(|l|) + |l| where the bit disagrees with the sign of l."""
    absl = torch.abs(llr)
    base = delta(absl)
    zero = torch.zeros_like(absl)
    return (base + torch.where(llr < 0, absl, zero),
            base + torch.where(llr > 0, absl, zero))
