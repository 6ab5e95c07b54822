"""Density-evolution / Gaussian-approximation analysis of BP decoding
(copied from polardecoding_tpu.analysis.dega, numpy only).

Deterministic BLER/BER predictors replicating the reference's DE-GA program
family (SURVEY §2.3) — no random sampling anywhere:

  - `bpdega`         — BPDEGA_128.c:322-380: propagate LLR *means* through the
                       BP sweeps with the GA check rule, 100 iterations, then
                       union-bound BLER over the info set.
  - `bprga`          — BPRGA_128.c:288-379: per-stage union-bound BLER E[0..n]
                       every 2 iterations (stage projection via GF(2)-combining
                       GA through the butterfly inverse).
  - `bprga_allbit`   — BPRGA_128_allbit.c:307-384: per-stage BER summed over
                       ALL N bits, no projection, SNR-adaptive window.
  - `bprga_w`        — BPRGA_128_W.c:351-448: per-stage info-bit LLR by
                       CHK-combining l+r over the stage-projection column
                       supports (the M matrices of makeLambda_128.mlx, computed
                       here by utils/gf2.py), skipping frozen factors.
  - `bprga_m`        — BPRGA_128_M.c:395-425: like _W but combining the
                       bit-value LLR  log(2/erfc(sqrt(l+r)/2) - 1)  and
                       converting back via p = (1 - tanh(L/2))/2.

All of it is host-side float64 numpy, matching the reference's doubles; these
are construction/prediction tools, not device kernels.  The graph here is the
Lee convention; the reference's _W/_M/_allbit programs run the Kao graph, which
is the same computation under bit-reversal relabeling (the E sums are
permutation-invariant).

Iteration windows (normative): BPDEGA 100; BPRGA 28 (report every 2);
_allbit floor(30 - 4 snr) (report iters 2..9); _W floor(32 - 6 snr) (report
iter > 1); _M same window, report 2..7; _1024 30 (report 5..9);
_1024_W floor(40 / snr).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.special import erfc

from polardecoding_tpu_torch.analysis.ga import ga_chk
from polardecoding_tpu_torch.ops.chk import LUT_THRESHOLDS, LUT_VALUES
from polardecoding_tpu_torch.utils.gf2 import stage_projection_supports
from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

FROZEN_R = 999.0  # BPDEGA/BPRGA/_allbit (BPRGA_128.c:303)
FROZEN_R_W = 99.0  # _W/_M variants (BPRGA_128_W.c:371)


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


def _init_messages(N, n, num_info, sigma, frozen_r, frozen=None):
    """frozen: optional explicit [N] bool mask overriding the default 5G
    construction (e.g. a GA-constructed code)."""
    if frozen is None:
        frozen = frozen_mask(N, num_info)
    L = np.zeros((n + 1, N))
    R = np.zeros((n + 1, N))
    L[n] = 2.0 / (sigma * sigma)
    R[0] = np.where(frozen, frozen_r, 0.0)
    return L, R, frozen


def union_bound(means):
    """0.5 sum erfc(sqrt(m)/2) (BPRGA_128.c:119-124)."""
    return 0.5 * float(np.sum(erfc(np.sqrt(np.maximum(means, 0.0)) / 2.0)))


@dataclasses.dataclass
class DegaResult:
    snr_db: float
    bler: float
    ber: float
    means: np.ndarray  # stage-0 LLR means [N]


def bpdega(N: int, K: int, snr_db: float, iters: int = 100,
           frozen=None) -> DegaResult:
    """Plain BP DE-GA prediction (BPDEGA_128.c): union-bound BLER from the
    stage-0 left-message means after `iters` GA sweeps.

    frozen: optional [N] bool mask overriding the default 5G construction —
    e.g. the GA-constructed BP_1024_GA code, whose MC measurement is
    cross-validated against this prediction (the reference's GA-vs-MC
    methodology, BPRGA_1024_W.c:1-16 / SURVEY §4.4)."""
    n = N.bit_length() - 1
    sigma = 10.0 ** (-snr_db / 20.0)
    if frozen is None:
        L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R)
        I = info_set(N, K)
    else:
        frozen = np.asarray(frozen, bool)
        L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R, frozen=frozen)
        I = np.flatnonzero(~frozen)
    for _ in range(iters):
        L, R = ga_iteration(L, R, n, N)
    bler = union_bound(L[0][I])
    return DegaResult(snr_db, bler, bler / max(len(I), 1), L[0].copy())


def _project_left(vals, stage, n, N):
    """GA stage projection (BPRGA_128.c:352-366): from stage-i combined means,
    walk the butterfly inverse leftward — upper-left = GA-combine(upper-right,
    lower-right), lower-left = lower-right."""
    b = vals
    for k in range(stage - 1, -1, -1):
        up, lo = _halves(b, k)
        b = _merge_stage(ga_chk(up, lo), lo, k, N)
    return b


def bprga(N: int, K: int, snr_db: float, iter_max: int = 28, report=None):
    """Per-stage union-bound BLER E[0..n] (BPRGA_128.c:288-379).

    `report` is a predicate on the 0-based iteration selecting when to emit an
    E row: default every 2 iterations (BPRGA_128.c:347); BPRGA_1024.c:385 uses
    `lambda it: 5 <= it <= 9`.  Returns {iteration (1-based): E[0..n]}."""
    if report is None:
        report = lambda it: it % 2 == 1
    n = N.bit_length() - 1
    sigma = 10.0 ** (-snr_db / 20.0)
    L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R)
    I = info_set(N, K)
    out = {}
    for it in range(iter_max):
        L, R = ga_iteration(L, R, n, N)
        if report(it):
            E = np.zeros(n + 1)
            for i in range(n + 1):
                u = _project_left(L[i] + R[i], i, n, N)
                E[i] = union_bound(u[I])
            out[it + 1] = E
    return out


def bprga_allbit(N: int, K: int, snr_db: float, iter_max: int = 30):
    """Per-stage all-bit BER sums, SNR-adaptive window floor(iter_max - 4 snr),
    reported for iterations 3..10 1-based (BPRGA_128_allbit.c:330-384)."""
    n = N.bit_length() - 1
    sigma = 10.0 ** (-snr_db / 20.0)
    L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R)
    out = {}
    for it in range(int(iter_max - 4 * snr_db)):
        L, R = ga_iteration(L, R, n, N)
        if 1 < it < 10:
            E = np.array([union_bound(L[i] + R[i]) for i in range(n + 1)])
            out[it + 1] = E
    return out


def frozen_stage_masks(N: int, num_info: int) -> np.ndarray:
    """isFrozen per (stage, node) in the Lee convention: a node is frozen
    (value identically 0) iff all stage-0 bits in its GF(2) support are frozen
    — the reference propagates this through connectBCB
    (BPRGA_128_W.c:262-273): upper-right frozen iff both parents frozen,
    lower-right frozen iff lower-left frozen."""
    n = N.bit_length() - 1
    masks = np.zeros((n + 1, N), dtype=bool)
    masks[0] = frozen_mask(N, num_info)
    for i in range(n):
        up, lo = _halves(masks[i], i)
        masks[i + 1] = _merge_stage(up & lo, lo, i, N)
    return masks


def _chk_lut(a, b):
    """The table-corrected min-sum CHK in float64 (same table as ops/chk.py)."""

    def lut(x):
        out = np.full_like(x, LUT_VALUES[0])
        for t, (hi, lo) in zip(
            LUT_THRESHOLDS, zip(LUT_VALUES[:-1], LUT_VALUES[1:])
        ):
            out = out - np.where(x >= t, hi - lo, 0.0)
        return out

    s = np.where((a >= 0) == (b >= 0), 1.0, -1.0)
    return s * np.minimum(np.abs(a), np.abs(b)) + lut(np.abs(a + b)) - lut(
        np.abs(a - b)
    )


def _bitrev_perm(N: int) -> np.ndarray:
    n = N.bit_length() - 1
    r = np.zeros(N, dtype=np.int64)
    for i in range(N):
        r[i] = int(format(i, f"0{n}b")[::-1], 2)
    return r


def bprga_w(N: int, K: int, snr_db: float, iter_max: int = 32,
            num_iters=None):
    """Stage-projected info-bit BER via CHK-combining of W = l + r over the
    M-matrix column supports, skipping frozen factors
    (BPRGA_128_W.c:351-448).  Default window floor(iter_max - 6 snr)
    (BPRGA_128_W.c:375-376); the N=1024 variant uses floor(iter_max / snr)
    (BPRGA_1024_W.c:414-415) — pass num_iters=int(40 / snr_db) for that
    preset.  E rows reported for every iteration index > 1 (1-based > 2).
    Returns {iter: E[0..n]}.

    The GA sweep runs our Lee graph; the combining chain is evaluated in the
    reference's KAO support order (Kao node (i, j) = Lee node (i, bitrev(j)))
    because the LUT CHK is not associative — matching the factor ORDER, not
    just the factor set, is what makes the result bit-comparable to the
    compiled reference fed our write_m_dat matrices."""
    n = N.bit_length() - 1
    sigma = 10.0 ** (-snr_db / 20.0)
    L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R_W)
    I = info_set(N, K)
    rev = _bitrev_perm(N)
    supports = stage_projection_supports(N, "kao")
    fmasks = frozen_stage_masks(N, K)
    out = {}
    if num_iters is None:
        num_iters = int(iter_max - 6 * snr_db)
    for it in range(num_iters):
        L, R = ga_iteration(L, R, n, N)
        if it > 1:
            E = np.zeros(n + 1)
            E[0] = union_bound(L[0][I])
            for i in range(1, n + 1):
                W = (L[i] + R[i])[rev]  # Kao-indexed stage means
                fz = fmasks[i][rev]
                ps = []
                for b in I:
                    sup = supports[i][rev[b]]
                    acc = W[sup[0]]
                    for k in sup[1:]:
                        if not fz[k]:
                            acc = _chk_lut(acc, W[k])
                    ps.append(0.5 * erfc(math.sqrt(max(acc, 0.0)) / 2.0))
                E[i] = float(np.sum(ps))
            out[it + 1] = E
    return out


def bprga_m(N: int, K: int, snr_db: float, iter_max: int = 32):
    """Like bprga_w but combining bit-VALUE LLRs W = log(2/erfc(sqrt(l+r)/2)-1)
    over ALL support factors (no frozen skip) and converting back via
    p = (1 - tanh(W/2))/2 (BPRGA_128_M.c:395-425).  Reported for iterations
    3..8.  Chain evaluated in Kao support order — see bprga_w."""
    n = N.bit_length() - 1
    sigma = 10.0 ** (-snr_db / 20.0)
    L, R, _ = _init_messages(N, n, K, sigma, FROZEN_R_W)
    I = info_set(N, K)
    rev = _bitrev_perm(N)
    supports = stage_projection_supports(N, "kao")
    out = {}
    for it in range(int(iter_max - 6 * snr_db)):
        L, R = ga_iteration(L, R, n, N)
        if 1 < it < 8:
            E = np.zeros(n + 1)
            E[0] = union_bound(L[0][I])
            for i in range(1, n + 1):
                m = (L[i] + R[i])[rev]
                W = np.log(2.0 / erfc(np.sqrt(np.maximum(m, 0.0)) / 2.0) - 1.0)
                ps = []
                for b in I:
                    sup = supports[i][rev[b]]
                    acc = W[sup[0]]
                    for k in sup[1:]:
                        acc = _chk_lut(acc, W[k])
                    ps.append(0.5 * (1.0 - math.tanh(acc / 2.0)))
                E[i] = float(np.sum(ps))
            out[it + 1] = E
    return out
