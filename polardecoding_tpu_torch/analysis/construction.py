"""DE-GA code construction: pick the frozen set from Gaussian-approximation
channel reliabilities instead of the 5G table.

The reference's DE-GA programs double as construction tools (SURVEY §2's L2
row: "The DE-GA programs ... are themselves construction/analysis tools"),
and BASELINE.json lists "BP_1024 with RGA/DEGA construction" as a target
configuration.  Two constructions:

  - `ga_sc_construction`: classic Trifonov/GA density evolution along the SC
    recursion — mean m(channel) = 2/sigma^2 at the root, children
    m_upper = phi_inv(1 - (1 - phi(m))^2)  (check combine of two i.i.d.)
    m_lower = 2 m, leaf means ranked ascending; uses the same piecewise
    phi/phi_inv as the reference (analysis/ga.py).
  - `bp_dega_construction`: rank bit channels by the reference's own BPDEGA
    left-message means after `iters` GA sweeps of the BP graph with no
    frozen-bit priors — the "construction by BP convergence" reading of the
    BPRGA tools.

Both return reliability orders compatible with utils/sequences.info_set
semantics (ascending reliability, like the 5G Q tables).
"""
from __future__ import annotations

import numpy as np

from polardecoding_tpu_torch.analysis.dega import ga_iteration
from polardecoding_tpu_torch.analysis.ga import phi, phi_inv


def ga_sc_means(N: int, design_snr_db: float) -> np.ndarray:
    """Per-bit-channel LLR means under GA density evolution of the SC
    recursion at the design Eb/N0."""
    sigma = 10.0 ** (-design_snr_db / 20.0)
    m = np.array([2.0 / (sigma * sigma)])
    n = N.bit_length() - 1
    for _ in range(n):
        pm = phi(m)
        upper = phi_inv(np.clip(2.0 * pm - pm * pm, 1e-320, 1.0))
        lower = 2.0 * m
        out = np.empty(2 * m.size)
        out[0::2] = upper  # u-side (worse) child first: index bit ordering
        out[1::2] = lower
        m = out
    return m


def ga_sc_construction(N: int, design_snr_db: float) -> np.ndarray:
    """Reliability order (ascending, like Q): argsort of the GA means with
    index as tie-break."""
    m = ga_sc_means(N, design_snr_db)
    return np.asarray(np.argsort(m, kind="stable"), dtype=np.int32)


def bp_dega_means(N: int, design_snr_db: float, iters: int = 40) -> np.ndarray:
    """Stage-0 posterior means after GA BP sweeps with every bit treated as
    an info bit (r = 0 everywhere): ranks channels by how well plain BP
    resolves them at the design SNR."""
    n = N.bit_length() - 1
    sigma = 10.0 ** (-design_snr_db / 20.0)
    L = np.zeros((n + 1, N))
    R = np.zeros((n + 1, N))
    L[n] = 2.0 / (sigma * sigma)
    for _ in range(iters):
        L, R = ga_iteration(L, R, n, N)
    return L[0].copy()


def bp_dega_construction(N: int, design_snr_db: float, iters: int = 40) -> np.ndarray:
    m = bp_dega_means(N, design_snr_db, iters)
    return np.asarray(np.argsort(m, kind="stable"), dtype=np.int32)


def reliability_order(N: int, construction: str = "5g",
                      design_snr_db: float = 2.0) -> np.ndarray:
    """Ascending reliability order for the given construction: the 5G table
    (the reference's Q), GA-SC density evolution, or BP DE-GA ranking."""
    if construction == "5g":
        from polardecoding_tpu_torch.utils.sequences import reliability_sequence

        return reliability_sequence(N)
    if construction == "ga_sc":
        return ga_sc_construction(N, design_snr_db)
    if construction == "bp_dega":
        return bp_dega_construction(N, design_snr_db)
    raise ValueError(f"unknown construction {construction!r}")


def code_info_set(code) -> np.ndarray:
    """Info set for a CodeConfig, honoring its construction knobs (same
    ordering semantics as utils/sequences.info_set: I[i] = order[N-KI+i])."""
    order = reliability_order(
        code.N, getattr(code, "construction", "5g"),
        getattr(code, "design_snr_db", 2.0),
    )
    return np.asarray(order[code.N - code.num_info:], dtype=np.int32)


def code_frozen_mask(code) -> np.ndarray:
    mask = np.ones(code.N, dtype=bool)
    mask[code_info_set(code)] = False
    return mask
