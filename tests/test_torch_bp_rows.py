"""The premises of the BP kernels' live-row sweep (csrc/bp_common.cuh), held
against both packages on the CPU:

- an iteration's result does not depend on the incoming L[0] and R[1..n]
  (the port's and the JAX package's bp_iteration), nor does a whole MC wave
  of at least one iteration (bp_wave_mc_plain and JAX's bp_wave_mc_jnp), so
  only L[1..n-1] and R[1..n-1] need to live in shared memory between
  stages, with L[n], R[n], R[0] and L[0] in registers;
- the sweep's CHK table as an exact chain of FMAs (bp::lut_fma, its
  constants read from csrc/bp_common.cuh and mirrored in numpy) equals the
  table of both packages' lut_correction on every threshold and its
  neighbours, 0, inf, NaN and random values;
- a pure-Python mirror of the kernels' index rule: stages 0..min(5, n-1)
  keep each warp inside its own 64 positions, thread t's stage-0 and
  stage-(n-1) pairs are (2t, 2t+1) and (t, t+N/2), and the barrier rule
  (`step_sync`) leaves no read-after-write or write-after-read between two
  warps without a block barrier, over each kernel's load, two iterations,
  its G-matrix checks, refills and write-back, for every N from 8 to 1024
  at two pairs per thread;
- the saturation that the kernels' CHK skips and chip_smoke.py's bound
  counts: where ops/chk.table_zero holds, the table difference is +0 in
  both packages and the CHK needs no table, and chip_smoke.counted_chks
  counts the CHKs that a plain run needs.
"""
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu.models import bp as jbp
from polardecoding_tpu.ops.chk import lut_correction as jlut
from polardecoding_tpu.ops.chk import chk as jchk
from polardecoding_tpu.ops.chk import chk_exact as jchk_exact
from polardecoding_tpu.ops.chk import chk_fast as jchk_fast
from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.ops.chk import _sign_min, table_zero
from polardecoding_tpu_torch.ops.chk import lut_correction as tlut
from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

JAX_CHK = {"minsum_lut": jchk, "minsum_lut_fast": jchk_fast, "spa": jchk_exact}
WARP_STAGES = 6  # bp_common.cuh kWarpStages


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "polardecoding_tpu_torch", "csrc", "bp_common.cuh")


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _header_pairs():
    """bp_common.cuh kPairs: butterfly pairs per thread."""
    with open(HEADER) as f:
        return int(re.search(r"constexpr int kPairs = (\d+);", f.read())[1])


def _header_constants():
    """{name: float32} of the kT*, kV*, kE* and kH constants of
    bp_common.cuh."""
    with open(HEADER) as f:
        src = f.read()
    found = re.findall(r"\b(k[TVE]\d|kH) = ([-0-9a-fx.p+]+)f\b", src)
    return {k: np.float32(float.fromhex(v) if "x" in v else float(v))
            for k, v in found}


def _lut_fma(x, c):
    """numpy mirror of bp::lut_fma: NaN to 0, then from kV7 one
    fma(sat(fma(x, -kH, kT*kH)), kE, v) per threshold, kT6 first.  An fma
    whose product is exact (s is 0 or 1) is one rounding of the float64
    sum."""
    x = np.fmax(x, np.float32(0))
    v = np.full_like(x, c["kV7"])
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(6, -1, -1):
            r = (x.astype(np.float64) * -np.float64(c["kH"])
                 + np.float64(c[f"kT{k}"] * c["kH"])).astype(np.float32)
            s = np.where(r > 0, np.minimum(r, np.float32(1)), 0).astype(np.float32)
            v = (v.astype(np.float64) + s.astype(np.float64)
                 * np.float64(c[f"kE{k}"])).astype(np.float32)
    return v


def test_lut_fma_chain_equals_the_table():
    """bp::lut_fma's constants reproduce the table of both packages bit
    for bit at each threshold and 3 ulps around it, at 0, denormals, large
    values, inf, a quiet NaN (an add's NaN is quiet) and 10^5 random
    values."""
    c = _header_constants()
    assert len(c) == 7 + 8 + 7 + 1, sorted(c)
    xs = [0.0, 1e-45, 1e-38, 1e30, 3e38, np.inf, np.nan]
    for k in range(7):
        t = c[f"kT{k}"].view(np.int32)
        xs += [np.int32(t + j).view(np.float32) for j in range(-3, 4)]
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array(xs, np.float32),
                        np.abs(rng.normal(size=50000) * 3),
                        np.abs(rng.standard_cauchy(50000))]).astype(np.float32)
    got = _bits(_lut_fma(x, c))
    assert (got == _bits(tlut(torch.as_tensor(x)).numpy())).all()
    assert (got == _bits(jlut(jnp.asarray(x)))).all()


@pytest.mark.parametrize("N,flavor", [
    (N, f) for N in (8, 128) for f in ("minsum_lut", "minsum_lut_fast", "spa")]
    + [(1024, "minsum_lut")])
def test_iteration_ignores_dead_rows(N, flavor):
    """The next L[0..n-1] and R[1..n] of one iteration, from the port's and
    the JAX package's bp_iteration, are the same whether the incoming L[0]
    and R[1..n] are zeros or random; and the same in both packages for the
    min-sum flavors (SPA's exp and log1p round apart in the two)."""
    n = N.bit_length() - 1
    rng = np.random.default_rng(N)
    B = 4

    def rows():
        return [(rng.normal(size=(B, N)) * 4).astype(np.float32)
                for _ in range(n + 1)]

    live_L, dead = rows(), rows()
    r0 = np.where(frozen_mask(N, N // 2), 999.0, 0.0).astype(np.float32)
    zero = np.zeros((B, N), np.float32)
    outs = []
    for dead_rows in ([zero] * (n + 1), dead):
        Ls = [dead_rows[0]] + live_L[1:]
        Rs = [np.broadcast_to(r0, (B, N))] + dead_rows[1:]
        tL, tR = tbp.bp_iteration([torch.as_tensor(x.copy()) for x in Ls],
                                  [torch.as_tensor(x.copy()) for x in Rs],
                                  tbp.CHK_FNS[flavor])
        jL, jR = jax.jit(functools.partial(jbp.bp_iteration,
                                           chk_fn=JAX_CHK[flavor]))(
            [jnp.asarray(x) for x in Ls], [jnp.asarray(x) for x in Rs])
        t_out = [_bits(x.numpy()) for x in tL[:n] + tR[1:]]
        j_out = [_bits(x) for x in jL[:n] + jR[1:]]
        if flavor != "spa":
            for a, b in zip(t_out, j_out):
                assert (a == b).all()
        outs.append((t_out, j_out))
    for pkg in (0, 1):
        for a, b in zip(outs[0][pkg], outs[1][pkg]):
            assert (a == b).all()


@pytest.mark.parametrize("cadence", [1, 2])
def test_wave_mc_ignores_dead_planes(cadence):
    """Three MC waves of bp_wave_mc_plain and JAX's bp_wave_mc_jnp: with
    iters >= 1, state (every plane), meta and stats do not depend on the
    incoming L[0] and R[1..n] planes, and the two packages agree."""
    N, K, B, spares = 16, 8, 8, 2
    n = N.bit_length() - 1
    rng = np.random.default_rng(cadence)
    frozen = frozen_mask(N, K)
    t_ut, t_xt = tbp.mc_tables(info_set(N, K), K, N)
    j_ut = jnp.asarray(t_ut.numpy())
    kw = dict(iters=3, flavor="minsum_lut_fast", iter_max=6,
              delta=tbp.mc_delta(B, K), spares=spares, cadence=cadence)
    state = tbp.wave_init_state(torch.zeros(B, N), torch.as_tensor(frozen))
    meta = tbp.mc_meta_init(B, N, K)
    dead = [0] + list(range(n + 2, 2 * n + 2))  # L[0], R[1..n]
    retired = 0
    for wave in range(3):
        bits = rng.integers(0, 2 ** 32, (spares, B, N))
        noisy = state.clone()
        noisy[dead] = torch.as_tensor(
            (rng.normal(size=(len(dead), B, N)) * 4).astype(np.float32))
        results = []
        for s in (state, noisy):
            t = tbp.bp_wave_mc_plain(s, meta, t_ut, t_xt, 0.8,
                                     torch.as_tensor(bits), **kw)
            j = jbp.bp_wave_mc_jnp(jnp.asarray(s.numpy()),
                                   jnp.asarray(meta.numpy()), j_ut,
                                   jnp.float32(0.8),
                                   jnp.asarray(bits.astype(np.uint32)), **kw)
            for a, b in zip(t, j):
                assert (_bits(a.numpy()) == _bits(b)).all(), wave
            results.append(t)
        for a, b in zip(*results):
            assert (_bits(a.numpy()) == _bits(b.numpy())).all(), wave
        state, meta, stats = results[0]
        retired += int(stats[:, 2].sum())
    assert retired > 0


def _pair(v, i):
    d = 1 << i
    u = ((v >> i) << (i + 1)) | (v & (d - 1))
    return u, u + d


def _home(v, N):
    h = 32 if N >= 64 else N >> 1
    p = (v // h) * 2 * h + v % h
    return p, p + h


def _block_sync(a, b):
    """bp_common.cuh step_sync: a block barrier between phases at stages a
    and b where they differ and one of them is >= 6."""
    return a != b and (a >= WARP_STAGES or b >= WARP_STAGES)


# the kernels' phases after the load (the wave kernels': with the merge):
# "it" an iteration, "check" the G-matrix rule, "refill" the MC kernel's
# rewrite of the shared rows, "store" the write-back; the MC kernel checks
# after each iteration, the fused wave kernel latches at its checks or
# decides once after the last iteration, the unfused one only stores
KERNEL_PHASES = {
    "mc": ("it", "check", "refill", "it", "check", "store"),
    "wave_latched": ("it", "check", "it", "check", "store"),
    "wave_decide": ("it", "it", "check", "store"),
    "wave_unfused": ("it", "it", "store")}


def _schedule(n, P, kernel="mc"):
    """A kernel's phases (KERNEL_PHASES) as (stage, block barrier before
    it, accesses): an access is (row, position, thread, write).  Rows:
    ("L", i) and ("R", i) for i in 1..n-1, "x" the check's scratch; the end
    rows are registers and not listed."""
    N = 1 << n
    T = N // (2 * P)
    lanes = [(t, t + k * T) for t in range(T) for k in range(P)]
    shared = range(1, n)

    def acc(row, i, p, t, w):
        return [(row, p, t, w)] if i in shared or row == "x" else []

    def sweep_stage(side, i):
        out = []
        for t, v in lanes:
            u, l = _pair(v, i)
            for p in (u, l):
                out += acc(("R", i), i, p, t, False)
                out += acc(("L", i + 1), i + 1, p, t, False)
                if side == "R":
                    out += acc(("R", i + 1), i + 1, p, t, True)
                else:
                    out += acc(("L", i), i, p, t, True)
        return out

    def at_home(write):  # the load, a refill, the write-back
        return [(row, p, t, write) for t, v in lanes for p in _home(v, N)
                for row in [(side, i) for side in "LR" for i in shared]]

    phases = [(0, False, at_home(True))]
    for kind in KERNEL_PHASES[kernel]:
        if kind == "it":
            stages = ([("R", i) for i in range(n)]
                      + [("L", i) for i in range(n - 1, -1, -1)])
            prev = phases[-1][0]
            for k, (side, i) in enumerate(stages):
                # the sweep opens with a __syncwarp; the turn shares a stage
                block = _block_sync(prev, i) if k else False
                phases.append((i, block, sweep_stage(side, i)))
                prev = i
        elif kind == "check":
            # decisions at stage 0's pairs, xor stages 0..n-2, the last xor
            # and the compare at stage n-1's pairs
            phases.append((0, False, [("x", p, t, True) for t, v in lanes
                                      for p in _pair(v, 0)]))
            for i in range(n - 1):
                prev_i = i - 1 if i else 0
                phases.append((i, _block_sync(prev_i, i), [
                    a for t, v in lanes for a in (
                        ("x", _pair(v, i)[0], t, False),
                        ("x", _pair(v, i)[1], t, False),
                        ("x", _pair(v, i)[0], t, True))]))
            phases.append((n - 1, _block_sync(n - 2, n - 1), [
                ("x", p, t, False) for t, v in lanes for p in _pair(v, n - 1)]))
            phases.append((n - 1, T > 32, []))  # the block AND (or the warp's)
        else:  # a refill writes the rows at home, the store (after a
            # __syncwarp) reads them
            phases.append((0, False, at_home(kind == "refill")))
    return phases


@pytest.mark.parametrize("n", range(3, 11))
def test_index_rule_keeps_low_stages_in_a_warp(n):
    """For N = 2^n: at stages 0..min(5, n-1) each thread's pairs lie in its
    warp's own positions (64 a virtual warp), thread t's stage-0 pair is
    (2t, 2t+1) and its stage-(n-1) pair (t, t+N/2) (for each of its P lanes
    v, P = kPairs), and its home positions lie in the same windows."""
    P = _header_pairs()
    assert P == 2
    N = 1 << n
    T = N // (2 * P)
    for t in range(T):
        vs = [t + k * T for k in range(P)]
        window = set()
        for v in vs:
            base = 64 * (v >> 5) if N >= 64 else 0
            window |= set(range(base, base + min(64, N)))
            assert _pair(v, 0) == (2 * v, 2 * v + 1)
            assert _pair(v, n - 1) == (v, v + N // 2)
            assert set(_home(v, N)) <= window
        for i in range(min(WARP_STAGES, n)):
            for v in vs:
                assert set(_pair(v, i)) <= window, (N, t, i)
        # every thread of a warp shares the warp's windows
        w0 = (t // 32) * 32
        for v in [w0 + k * T for k in range(P)]:
            base = 64 * (v >> 5) if N >= 64 else 0
            assert set(range(base, base + min(64, N))) <= window
    # the home positions cover every position once
    homes = sorted(p for t in range(T) for k in range(P)
                   for p in _home(t + k * T, N))
    assert homes == list(range(N))


@pytest.mark.parametrize("kernel", list(KERNEL_PHASES))
@pytest.mark.parametrize("n", range(3, 11))
def test_barrier_rule_leaves_no_cross_warp_hazard(n, kernel):
    """Over a kernel's load (the wave kernels' merge), two iterations and
    its checks, refills and write-back (KERNEL_PHASES): every pair of
    accesses to one shared position by two different warps, one of them a
    write, has a block barrier between them; and the block barriers per
    iteration are 2(n-6) for n >= 7 (8 at N=1024, 2 at N=128) and none at
    N <= 64."""
    P = _header_pairs()
    N = 1 << n
    T = N // (2 * P)
    seen = {}  # position -> (warps that read, warps that wrote) since the
    # last block barrier
    for stage, block, accesses in _schedule(n, P, kernel):
        if block:
            seen.clear()
        for row, p, t, write in accesses:
            warp = t // 32
            read_by, written_by = seen.setdefault((row, p), (set(), set()))
            clash = (read_by | written_by) if write else written_by
            assert clash <= {warp}, (N, P, row, p, stage, write)
            (written_by if write else read_by).add(warp)
    sweep = [(i, _block_sync(a, i)) for a, i in
             zip(range(n - 1), range(1, n))]  # R-sweep 0..n-1
    sweep += [(i, _block_sync(i + 1, i)) for i in range(n - 2, -1, -1)]
    barriers = sum(b for _, b in sweep)
    assert barriers == (2 * (n - WARP_STAGES) if n > WARP_STAGES else 0)
    if N == 1024:
        assert barriers == 8
    if N <= 64:
        assert T <= 32 and barriers == 0


def _chk_operands(seed):
    """CHK operands a, b (float32): the table's thresholds and their
    neighbours as |a+b| and |a-b|, +-0, inf, NaN, and random values of
    a converging BP's range."""
    rng = np.random.default_rng(seed)
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 4.5, -4.5, 100.0, -100.0]
    for k in range(7):
        t = np.float32(0.196 if k == 0 else (0.433, 0.71, 1.05, 1.508, 2.252,
                                             4.5)[k - 1]).view(np.int32)
        edges += [np.int32(t + j).view(np.float32) for j in range(-2, 3)]
    e = np.array(edges, np.float32)
    a = np.concatenate([np.repeat(e, len(e)), rng.normal(size=20000) * 8,
                        rng.normal(size=20000) * 40]).astype(np.float32)
    b = np.concatenate([np.tile(e, len(e)), rng.normal(size=20000) * 8,
                        rng.normal(size=20000) * 3]).astype(np.float32)
    return torch.as_tensor(a), torch.as_tensor(b)


@pytest.mark.parametrize("flavor", ["minsum_lut", "minsum_lut_fast"])
def test_table_zero_needs_no_table(flavor):
    """Where ops/chk.table_zero holds, the table difference is +0 in both
    packages and the CHK equals its value without the table (min-sum:
    the signed min plus +0; fast: half of |a+b| - |a-b|), bit for bit; the
    kernel's min-sum test ||a| - |b|| >= 4.5 picks the same CHKs."""
    a, b = _chk_operands(0)
    z = table_zero(a, b)
    assert 0 < int(z.sum()) < z.numel()
    ap, aq = (a + b).abs(), (a - b).abs()
    deltas = [(tlut(ap) - tlut(aq)).numpy(),
              np.asarray(jlut(jnp.asarray(ap.numpy()))
                         - jlut(jnp.asarray(aq.numpy())))]
    for delta in deltas:
        assert (_bits(delta[z.numpy()]) == 0).all()
    if flavor == "minsum_lut":
        assert ((a.abs() - b.abs()).abs() >= 4.5).eq(z).all()
        alone = _sign_min(a, b) + 0.0
    else:
        alone = 0.5 * (ap - aq)
    got = tbp.CHK_FNS[flavor](a, b)
    assert (_bits(got[z].numpy()) == _bits(alone[z].numpy())).all()
    want = np.asarray(JAX_CHK[flavor](jnp.asarray(a.numpy()),
                                      jnp.asarray(b.numpy())))
    assert (_bits(want[z.numpy()]) == _bits(alone[z].numpy())).all()


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("run,flavor", [("decode", "minsum_lut"),
                                        ("decode", "minsum_lut_fast"),
                                        ("mc_wave", "minsum_lut_fast")])
def test_chip_smoke_counts_the_chks_a_run_needs(run, flavor):
    """chip_smoke.counted_chks over a plain decode or MC wave: (4n - 1) N/2
    CHKs a frame and iteration, the L-sweep's chk(R[n-1], L[n]) at stage
    n-1 left out (its operands are the R-sweep's, bit for bit), and of them
    as many with table_zero as a direct count over every call finds, less
    the repeat's; the result unchanged and CHK_FNS restored; bp_sweep_ops
    charges each CHK its operations and an add."""
    smoke = _chip_smoke()
    N, B, iters = 64, 8, 6
    n = N.bit_length() - 1
    rng = np.random.default_rng(3)
    if run == "decode":
        llr = torch.as_tensor((2.0 + 1.6 * rng.normal(size=(B, N)))
                              .astype(np.float32) * 2.5)
        frozen = torch.as_tensor(frozen_mask(N, N // 2))

        def plain():
            return (tbp.bp_decode(llr, frozen, iters=iters, flavor=flavor),)
    else:
        K = N // 2
        ut, xt = tbp.mc_tables(info_set(N, K), K, N)
        state = tbp.wave_init_state(torch.zeros(B, N),
                                    torch.as_tensor(frozen_mask(N, K)))
        meta = tbp.mc_meta_init(B, N, K)
        bits = torch.as_tensor(rng.integers(0, 2 ** 32, (2, B, N)))

        def plain():
            return tbp.bp_wave_mc_plain(state, meta, ut, xt, 0.8, bits,
                                        iters=iters, flavor=flavor,
                                        delta=tbp.mc_delta(B, K), cadence=2)
    fn = tbp.CHK_FNS[flavor]
    calls = []

    def every(a, b):
        calls.append((a, b))
        return fn(a, b)

    tbp.CHK_FNS[flavor] = every
    try:
        want = plain()
    finally:
        tbp.CHK_FNS[flavor] = fn
    assert len(calls) == 4 * n * iters
    zero = 0
    for it in range(iters):
        at = calls[4 * n * it:4 * n * (it + 1)]
        # R-sweep stage n-1's chk(ru, lu) is call 2n - 1, the L-sweep's 2n + 1
        for x, y in zip(at[2 * n - 1], at[2 * n + 1]):
            assert (_bits(x.numpy()) == _bits(y.numpy())).all()
        zero += sum(int(table_zero(a, b).sum()) for k, (a, b) in enumerate(at)
                    if k != 2 * n + 1)
    with smoke.counted_chks(flavor) as counts:
        got = plain()
    assert tbp.CHK_FNS[flavor] is fn
    for x, y in zip(got, want):
        assert (_bits(x.numpy()) == _bits(y.numpy())).all()
    assert counts["chks"] == B * iters * (4 * n - 1) * (N // 2)
    assert counts["zero"] == zero and 0 < zero < counts["chks"]
    full, alone = smoke.CHK_BP_OPS[flavor]
    assert smoke.bp_sweep_ops(counts) == ((counts["chks"] - zero) * full
                                          + zero * alone + counts["chks"])
