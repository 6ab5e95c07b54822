"""The GA flooding iteration of the reference's DE-GA tools, which the
`bp_dega` construction runs (copied from polardecoding_tpu.analysis.dega,
numpy only).  The BLER predictors of that module (bpdega, bprga and its
variants) are not part of the port yet."""
from __future__ import annotations

import numpy as np

from polardecoding_tpu_torch.analysis.ga import ga_chk


def _halves(x, i):
    N = x.shape[-1]
    d = 1 << i
    v = x.reshape(x.shape[:-1] + (N // (2 * d), 2, d))
    return v[..., 0, :], v[..., 1, :]


def _merge_stage(up, lo, i, N):
    out = np.stack((up, lo), axis=-2)
    return out.reshape(out.shape[:-3] + (N,))


def ga_iteration(L, R, n, N):
    """One GA flooding iteration over [n+1, N] mean arrays — the same
    Gauss-Seidel sweep order as BP (BPDEGA_128.c:344-379)."""
    for i in range(n):
        ru, rd = _halves(R[i], i)
        lu, ld = _halves(L[i + 1], i)
        new_u = ga_chk(ru, ld + rd)
        new_d = ga_chk(ru, lu) + rd
        R[i + 1] = _merge_stage(new_u, new_d, i, N)
    for i in range(n - 1, -1, -1):
        ru, rd = _halves(R[i], i)
        lu, ld = _halves(L[i + 1], i)
        new_u = ga_chk(lu, ld + rd)
        new_d = ga_chk(ru, lu) + ld
        L[i] = _merge_stage(new_u, new_d, i, N)
    return L, R
