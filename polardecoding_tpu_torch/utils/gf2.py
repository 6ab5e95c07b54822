"""GF(2) linear-algebra helpers: dense generator matrices and stage
projections (copied from polardecoding_tpu.utils.gf2, numpy only).

Replaces two reference components:
  - the N x N generator matrix Fn = F^{tensor n} that every reference program
    reads from stdin (ref: SC_128.c:148-158) — here built directly, used for
    the encoder's info-row generator and golden mode's dense encode;
  - makeLambda_128.mlx, the MATLAB script that builds per-stage projection
    matrices M_k for the BPRGA_W/_M analysis tools (SURVEY §2.3) — here a few
    lines of numpy computed from the same butterfly structure.
"""
from __future__ import annotations

import numpy as np

F2 = np.array([[1, 0], [1, 1]], dtype=np.uint8)


def dense_generator(N: int) -> np.ndarray:
    """F^{tensor n} over GF(2), the polar transform in the Lee convention
    (G = F^{tensor n}, no bit reversal; ref comment SC_128.c:1-6)."""
    n = N.bit_length() - 1
    if 1 << n != N:
        raise ValueError(f"N={N} is not a power of two")
    G = np.array([[1]], dtype=np.uint8)
    for _ in range(n):
        G = np.kron(G, F2)
    return G


def encode_dense(u: np.ndarray, G: np.ndarray) -> np.ndarray:
    """x = u . G over GF(2) (the reference's row-XOR accumulation,
    SC_128.c:182-191), vectorized."""
    return (np.asarray(u, dtype=np.uint8) @ G) % 2


def stage_transfer_matrices(N: int, convention: str = "lee") -> list[np.ndarray]:
    """T[i]: GF(2) matrix mapping stage-i node values v_i to stage-0 values u
    (graph-position indexing), u = v_i . T[i]  (T[0] = I).

    Built from the butterfly structure of either wiring: one stage (separation
    d = 2^i for "lee", 2^(n-1-i) for "kao") maps left values (a_up, a_lo) to
    right values (a_up xor a_lo, a_lo); the 2x2 kernel is involutory over
    GF(2), so the left values equal the same butterfly applied to the right
    values.  T[i] is the product of stages i-1..0 inverted — i.e. the forward
    transforms again.

    This replaces makeLambda_128.mlx's Lambda_i / M_k cumulative products
    (the reference's M matrices are in the Kao convention).
    """
    n = N.bit_length() - 1
    mats = [np.eye(N, dtype=np.uint8)]
    T = np.eye(N, dtype=np.uint8)
    for i in range(n):
        S = _stage_matrix(N, i, convention)
        # v_{i+1} = v_i . S  and S is an involution, so v_i = v_{i+1} . S
        # u = v_i . T  =>  u = v_{i+1} . (S . T)
        T = (S @ T) % 2
        mats.append(T.astype(np.uint8))
    return mats


def _stage_matrix(N: int, i: int, convention: str = "lee") -> np.ndarray:
    """GF(2) matrix for one butterfly stage: right[j] = left[j] xor left[j+d]
    for upper j, right[j+d] = left[j+d]; d = 2^i ("lee", SC_128.c:317-342) or
    2^(n-1-i) ("kao", SC_128_fag.c:333-358)."""
    n = N.bit_length() - 1
    d = (1 << i) if convention == "lee" else (1 << (n - 1 - i))
    S = np.eye(N, dtype=np.uint8)
    for j in range(N):
        if (j // d) % 2 == 0:
            S[j + d, j] = 1  # lower-left feeds the upper-right xor
    return S


def write_m_dat(N: int, path: str, convention: str = "kao") -> None:
    """Write the stage-projection matrices in the reference's M<N>.dat stdin
    format (makeLambda_128.mlx output consumed by BPRGA_*_W/_M:
    BPRGA_128_W.c:85-108): first, for each stage k = 1..n, the support sizes
    Mw[k][i] for every column i; then, per stage, the support indices.  The
    reference programs run the Kao graph, so the default convention is kao."""
    sup = stage_projection_supports(N, convention)
    n = N.bit_length() - 1
    with open(path, "w") as f:
        for k in range(1, n + 1):
            f.write(" ".join(str(len(sup[k][i])) for i in range(N)) + "\n")
        for k in range(1, n + 1):
            for i in range(N):
                f.write(" ".join(str(int(v)) for v in sup[k][i]) + "\n")


def stage_projection_supports(N: int, convention: str = "lee") -> list[list[np.ndarray]]:
    """For each stage i and each stage-0 bit b, the set of stage-i node indices
    whose GF(2) sum equals u_b — the column supports of T[i].

    This is the data makeLambda_128.mlx wrote to M128.dat for BPRGA_128_W/_M
    (column supports + weights; SURVEY §2.3).  supports[i][b] is a 1-D int array.
    """
    mats = stage_transfer_matrices(N, convention)
    out = []
    for T in mats:
        # u = v_i . T  =>  u_b = xor over rows r with T[r, b] == 1 of v_i[r]
        out.append([np.nonzero(T[:, b])[0].astype(np.int32) for b in range(N)])
    return out
