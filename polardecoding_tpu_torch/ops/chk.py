"""Box-plus (check-node) and path-metric LUT ops (torch port of
polardecoding_tpu.ops.chk, same operations in the same association order).

The reference's CHK is min-sum with an 8-bin additive correction
delta(|a+b|) - delta(|a-b|), a table approximation of the exact
ln cosh((a+b)/2) - ln cosh((a-b)/2) terms (ref: SC_128.c:283-315).  The same
8-bin table approximates ln(1 + e^-x) in the SCL path-metric update PHI
(ref: SCL_1024.c:481-502).  Thresholds and values are normative: off-by-a-bin
changes the published curves.  csrc/bp_decode.cu evaluates the same select
tree with the same f32 constants.
"""
from __future__ import annotations

import functools

import torch

# Normative correction table: value delta(x) for |x| in successive bins.
LUT_THRESHOLDS = (0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5)
LUT_VALUES = (0.65, 0.55, 0.45, 0.35, 0.25, 0.15, 0.05, 0.0)


@functools.lru_cache(maxsize=None)
def _constants(dtype, device):
    """The table and +-1 as 0-dim tensors of one dtype on one device, made
    once: comparing an f32 tensor with f32 constants is what the JAX package
    and the kernel do, and a fresh constant per call would cost a host copy
    per select on the card."""
    def c(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return (tuple(map(c, LUT_THRESHOLDS)), tuple(map(c, LUT_VALUES)),
            c(1.0), c(-1.0))


def _lut_tree(x, lo, hi, T, V):
    """Balanced select tree over bins [lo, hi): bin k iff
    T[k-1] <= x < T[k] (T[-1] = -inf, T[len] = +inf)."""
    if hi - lo == 1:
        return V[lo]
    mid = (lo + hi) // 2
    return torch.where(x >= T[mid - 1], _lut_tree(x, mid, hi, T, V),
                       _lut_tree(x, lo, mid, T, V))


def lut_correction(x):
    """delta(x) for x >= 0: piecewise-constant ln(1+e^-x) approximation,
    carrying the table's literal values, so a value exactly at a threshold
    falls in the upper bin and NaN falls in bin 0."""
    T, V, _, _ = _constants(x.dtype, x.device)
    return torch.broadcast_to(_lut_tree(x, 0, len(LUT_VALUES), T, V), x.shape)


def table_zero(a, b):
    """Where the CHK's table difference delta(|a+b|) - delta(|a-b|) is +0
    without the table: both |a+b| and |a-b| at or above the last threshold
    (NaN not).  The CUDA BP sweep skips the table there
    (csrc/bp_common.cuh, lut_fma_diff)."""
    last = _constants(a.dtype, a.device)[0][-1]
    return torch.minimum(torch.abs(a + b), torch.abs(a - b)) >= last


def _sign_min(a, b):
    _, _, one, minus_one = _constants(a.dtype, a.device)
    s = torch.where((a >= 0) == (b >= 0), one, minus_one)
    return s * torch.minimum(torch.abs(a), torch.abs(b))


def chk(a, b):
    """Table-corrected min-sum box-plus (ref CHK, SC_128.c:283-315):

        sign(a) sign(b) min(|a|, |b|) + (delta(|a+b|) - delta(|a-b|))

    with sign(0) treated as +1 and the delta difference formed first (the
    reference's association), so a float64 run is bit-identical to the C."""
    delta = lut_correction(torch.abs(a + b)) - lut_correction(torch.abs(a - b))
    return _sign_min(a, b) + delta


def chk_fast(a, b):
    """Algebraic rewrite of `chk`: sign(a) sign(b) min(|a|, |b|) equals
    (|a+b| - |a-b|) / 2 in the reals, so

        chk(a, b) == 0.5 (|a+b| - |a-b|) + delta(|a+b|) - delta(|a-b|).

    Not bit-identical to the reference (the halved difference rounds
    differently): the opt-in "minsum_lut_fast" flavor."""
    ap = torch.abs(a + b)
    aq = torch.abs(a - b)
    return 0.5 * (ap - aq) + (lut_correction(ap) - lut_correction(aq))


def chk_exact(a, b):
    """Exact sum-product box-plus 2 atanh(tanh(a/2) tanh(b/2)) (the "SPA"
    variant), in the stable min-sum + log1p form."""
    return (
        _sign_min(a, b)
        + torch.log1p(torch.exp(-torch.abs(a + b)))
        - torch.log1p(torch.exp(-torch.abs(a - b)))
    )


def phi_penalty(llr, u):
    """LLR-based path-metric increment PHI (ref: SCL_1024.c:481-502):

        PHI = delta(|l|) + |l| * [chosen bit disagrees with sign(l)]

    where disagreement means (u == 0 and l < 0) or (u == 1 and l > 0).
    `u` may be an int or a 0/1 tensor broadcastable against `llr`.
    """
    absl = torch.abs(llr)
    u = torch.as_tensor(u, device=llr.device)
    disagree = torch.where(u == 0, llr < 0, llr > 0)
    return lut_correction(absl) + torch.where(disagree, absl,
                                              torch.zeros_like(absl))


def phi_penalties_both(llr):
    """(PHI(l, u=0), PHI(l, u=1)) in one pass (ref: SCL_1024.c:611-617)."""
    absl = torch.abs(llr)
    base = lut_correction(absl)
    zero = torch.zeros_like(absl)
    pen0 = base + torch.where(llr < 0, absl, zero)
    pen1 = base + torch.where(llr > 0, absl, zero)
    return pen0, pen1
