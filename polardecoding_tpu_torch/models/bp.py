"""Belief-propagation decoder: flooding sweeps over the butterfly graph
(torch port of polardecoding_tpu.models.bp).

Reference semantics (BP_128.c:334-389, BP_1024.c, BP_128_fag.c:349-403):
  - messages: left-going L[i, p] and right-going R[i, p] on an (n+1) x N lattice;
    L[n] = channel LLR (fixed), R[0] = 999 on frozen / 0 on info (fixed);
  - one iteration = R-sweep over stages 0..n-1 (Gauss-Seidel: stage i+1 reads the
    stage-i R just written) then L-sweep over stages n-1..0;
  - per-butterfly updates with the table-corrected min-sum CHK:
        R'[i+1, u] = CHK(R[i, u], L[i+1, d] + R[i, d])
        R'[i+1, d] = R[i, d] + CHK(R[i, u], L[i+1, u])
        L'[i, u]   = CHK(L[i+1, u], L[i+1, d] + R[i, d])
        L'[i, d]   = L[i+1, d] + CHK(R[i, u], L[i+1, u])
  - decision after iterMax iterations: u_hat = sign(L[0] + R[0]) on info bits.

`bp_decode` is the plain version: stage i's butterflies are a reshape of the
N axis into [N/2d, 2, d] (d = 2^i) and a batched elementwise CHK over the
halves, with the operations in the JAX engine's order, so it is bit-equal to
it.  `bp_decode_auto` sends a CUDA tensor to the hand-written kernel
(ops/bp_kernel.py) and runs the plain version on a CPU tensor.  The wave
half below (persistent state advanced K iterations at a time) follows the
same rule: `bp_wave`, `bp_wave_fused` and `bp_wave_mc` launch the kernels of
ops/bp_wave_kernel.py and ops/bp_wave_mc_kernel.py on a CUDA tensor and run
their plain versions (`*_plain`) on a CPU tensor or with engine="plain".
`bpr_decode` (BPr's stage-error instrumentation) runs its iterations
through `bp_wave`.

Optional early stopping (extension beyond the reference): with
`early_stop_every > 0`, every that many iterations the current hard decision
is re-encoded and compared with the posterior hard decision at the channel
stage, sign(L[n] + R[n]) (a G-matrix stopping rule).  Each frame's decision
is LATCHED at its own first check where the rule holds, so the output is a
pure function of (channel LLRs, early_stop_every).
"""
from __future__ import annotations

import numpy as np
import torch

from polardecoding_tpu_torch.ops._build import use_kernel
from polardecoding_tpu_torch.ops.chk import chk, chk_exact, chk_fast
from polardecoding_tpu_torch.ops.encode import polar_encode
from polardecoding_tpu_torch.ops.noise import counter_bits, mc_llr
from polardecoding_tpu_torch.utils.pn import PN_PERIOD, pn_sequence

FROZEN_R = 999.0  # the reference's frozen-bit "infinity" (BP_128.c:351)
CHK_FNS = {"minsum_lut": chk, "minsum_lut_fast": chk_fast, "spa": chk_exact}


def _halves(x, i):
    """Split the last axis (length N) into stage-i butterfly halves.

    Returns (upper, lower) of shape [..., N/2d, d]; `_merge` is the inverse.
    """
    N = x.shape[-1]
    d = 1 << i
    v = x.reshape(x.shape[:-1] + (N // (2 * d), 2, d))
    return v[..., 0, :], v[..., 1, :]


def _merge(up, lo, N):
    out = torch.stack((up, lo), dim=-2)
    return out.reshape(out.shape[:-3] + (N,))


def bp_iteration(Ls, Rs, chk_fn):
    """One flooding iteration over per-stage message lists.

    Ls, Rs: lists of n+1 tensors [..., N].  Ls[n] and Rs[0] are fixed by the
    caller.  Returns updated lists (Gauss-Seidel across stages, parallel within
    a stage, exactly like the reference's sweep order).
    """
    n = len(Ls) - 1
    N = Ls[0].shape[-1]
    Rs = list(Rs)
    Ls = list(Ls)
    for i in range(n):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(ru, ld + rd)
        new_d = rd + chk_fn(ru, lu)
        Rs[i + 1] = _merge(new_u, new_d, N)
    for i in range(n - 1, -1, -1):
        ru, rd = _halves(Rs[i], i)
        lu, ld = _halves(Ls[i + 1], i)
        new_u = chk_fn(lu, ld + rd)
        new_d = ld + chk_fn(ru, lu)
        Ls[i] = _merge(new_u, new_d, N)
    return Ls, Rs


def bp_decode(ch_llr: torch.Tensor, frozen: torch.Tensor, iters: int = 100,
              flavor: str = "minsum_lut", early_stop_every: int = 0):
    """Decode a batch of frames with the plain PyTorch engine.

    ch_llr: [B, N] channel LLRs (2y/sigma^2), float32 or float64;
    frozen: [N] bool on the same device.
    Returns u_hat [B, N] int8 (frozen positions forced 0).
    """
    chk_fn = CHK_FNS[flavor]
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    r0 = torch.where(frozen, FROZEN_R, 0.0).to(ch_llr.dtype).expand(B, N)
    zero = torch.zeros_like(ch_llr)
    Ls = [zero] * n + [ch_llr]
    Rs = [r0] + [zero] * n

    def decision():
        soft = Ls[0] + Rs[0]
        return torch.where(frozen, 0, (soft < 0).to(torch.int8)).to(torch.int8)

    if not early_stop_every:
        for _ in range(iters):
            Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        return decision()

    done = torch.zeros(B, dtype=torch.bool, device=ch_llr.device)
    u_lat = torch.zeros((B, N), dtype=torch.int8, device=ch_llr.device)
    for it in range(iters):
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        if (it + 1) % early_stop_every:
            continue
        u_hat = decision()
        # posterior channel-stage hard decision sign(L[n] + R[n]), not the
        # raw channel sign, which carries the channel's own bit errors
        ch_hard = (Ls[n] + Rs[n] < 0).to(torch.int8)
        newly = (polar_encode(u_hat) == ch_hard).all(dim=-1) & ~done
        u_lat = torch.where(newly[:, None], u_hat, u_lat)
        done = done | newly
        if bool(done.all()):
            break
    return torch.where(done[:, None], u_lat, decision())


def bp_decode_auto(ch_llr: torch.Tensor, frozen: torch.Tensor, iters: int = 100,
                   flavor: str = "minsum_lut", early_stop_every: int = 0,
                   engine: str = "auto"):
    """Decode with the hand-written CUDA kernel for a CUDA tensor and with the
    plain version for a CPU tensor; engine="plain" forces the plain version
    on any device (the JAX package's engine="jnp")."""
    if not use_kernel(ch_llr, engine, "bp_decode_auto"):
        return bp_decode(ch_llr, frozen, iters=iters, flavor=flavor,
                         early_stop_every=early_stop_every)
    from polardecoding_tpu_torch.ops.bp_kernel import bp_decode_cuda

    return bp_decode_cuda(ch_llr, frozen, iters=iters, flavor=flavor,
                          early_stop_every=early_stop_every)


# ---------------------------------------------------------------------------
# Wave decoding: persistent message state advanced K iterations at a time
# (the JAX package's continuous-batching engines, parallel/harness
# make_wave_step and make_wave_step_mc).  The state is stage-major
# [2(n+1), B, N]: planes 0..n are L (L[n] = the channel LLRs), planes
# n+1..2n+1 are R (R[0] = the frozen row, 999 or 0).  A frame's decision is
# taken at its own first passing G-matrix check, so it is a pure function of
# its LLRs and K.  Merges are selects, never 0*x, so that a kept -0.0
# survives.


def wave_init_state(ch_llr: torch.Tensor, frozen: torch.Tensor) -> torch.Tensor:
    """Fresh state [2(n+1), B, N] for channel LLRs [B, N]."""
    B, N = ch_llr.shape
    n = N.bit_length() - 1
    r0 = torch.where(frozen, FROZEN_R, 0.0).to(ch_llr.dtype).expand(B, N)
    zero = torch.zeros_like(ch_llr)
    return torch.stack([zero] * n + [ch_llr, r0] + [zero] * n, dim=0)


def _planes(state):
    n = state.shape[0] // 2 - 1
    return list(state[:n + 1]), list(state[n + 1:])


def _decide(Ls, Rs, frozen):
    """(u_hat [B, N] int8, ok [B] bool): decision sign(L0 + R0) on the info
    bits, and the G-matrix rule x(u_hat) == sign(L[n] + R[n])."""
    n = len(Ls) - 1
    u_hat = ((Ls[0] + Rs[0] < 0) & ~frozen).to(torch.int8)
    post = (Ls[n] + Rs[n] < 0).to(torch.int8)
    return u_hat, (polar_encode(u_hat) == post).all(dim=-1)


def wave_decide(state: torch.Tensor, frozen: torch.Tensor):
    """(u_hat [B, N] int8, done [B] bool) from packed state: the decision on
    the info bits and the G-matrix check."""
    return _decide(*_planes(state), frozen)


def wave_merge(state: torch.Tensor, ch_llr: torch.Tensor,
               retire: torch.Tensor) -> torch.Tensor:
    """Re-initialise the retired slots' planes from fresh LLRs: L[n] <- llr,
    every other plane but R[0] (the frozen row, the same for every frame)
    <- 0, where retire [B] is True."""
    n = state.shape[0] // 2 - 1
    out = torch.where(retire[None, :, None], 0.0, state)
    out[n] = torch.where(retire[:, None], ch_llr, state[n])
    out[n + 1] = state[n + 1]
    return out


def bp_wave_plain(state: torch.Tensor, iters: int = 8,
                  flavor: str = "minsum_lut") -> torch.Tensor:
    """Advance packed state by `iters` BP iterations (the plain version of
    the JAX package's bp_wave_jnp)."""
    chk_fn = CHK_FNS[flavor]
    Ls, Rs = _planes(state)
    for _ in range(iters):
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
    return torch.stack(Ls + Rs, dim=0)


def bp_wave_fused_plain(state, ch_llr, retire, iters: int = 8,
                        flavor: str = "minsum_lut", check_every: int = 0,
                        live=None):
    """Merge -> advance -> decide (the plain version of bp_wave_fused_jnp):
    (state', u_hat [B, N] int8, done [B] bool).  check_every > 0 checks the
    G-matrix rule every that many iterations and at the last, and latches a
    frame's (u_hat, done) at its first passing check.  live [B] bool, if
    given, holds the slots where it and retire are False, as the kernel
    does: they are not run, and come back with their state as it was, done
    False and u_hat 0."""
    if live is not None:
        run = live | retire
        s, u, d = bp_wave_fused_plain(state[:, run], ch_llr[run], retire[run],
                                      iters, flavor, check_every)
        state = state.clone()
        state[:, run] = s
        u_hat = torch.zeros(state.shape[1:], dtype=torch.int8,
                            device=state.device)
        u_hat[run] = u
        done = torch.zeros_like(retire)
        done[run] = d
        return state, u_hat, done
    chk_fn = CHK_FNS[flavor]
    n = state.shape[0] // 2 - 1
    state = wave_merge(state, ch_llr, retire)
    frozen = state[n + 1] > 0.0
    if not check_every:
        state = bp_wave_plain(state, iters, flavor)
        u_hat, done = wave_decide(state, frozen)
        return state, u_hat, done
    Ls, Rs = _planes(state)
    done = torch.zeros(state.shape[1], dtype=torch.bool, device=state.device)
    u_lat = torch.zeros(state.shape[1:], dtype=torch.int8, device=state.device)
    for it in range(iters):
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        if (it + 1) % check_every and it + 1 != iters:
            continue
        u, ok = _decide(Ls, Rs, frozen)
        newly = ok & ~done
        u_lat = torch.where(newly[:, None], u, u_lat)
        done = done | newly
    u_fin, _ = _decide(Ls, Rs, frozen)
    return (torch.stack(Ls + Rs, dim=0), torch.where(done[:, None], u_lat, u_fin),
            done)


def bp_wave(state, iters: int = 8, flavor: str = "minsum_lut",
            engine: str = "auto"):
    """Advance packed state by `iters` iterations: the CUDA kernel on a CUDA
    tensor (which updates `state` in place and returns it), the plain
    version on a CPU tensor or with engine="plain"."""
    if not use_kernel(state, engine, "bp_wave"):
        return bp_wave_plain(state, iters, flavor)
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_cuda

    return bp_wave_cuda(state, iters=iters, flavor=flavor)


def bp_wave_fused(state, ch_llr, retire, iters: int = 8,
                  flavor: str = "minsum_lut", check_every: int = 0,
                  engine: str = "auto", live=None):
    """The fused wave step (refill-merge + K iterations + G-matrix decide)
    -> (state', u_hat, done): the CUDA kernel on a CUDA tensor (state
    updated in place), the plain version on a CPU tensor or with
    engine="plain".  live [B] bool, if given, holds the slots where it and
    retire are False (bp_wave_fused_plain)."""
    if not use_kernel(state, engine, "bp_wave_fused"):
        return bp_wave_fused_plain(state, ch_llr, retire, iters, flavor,
                                   check_every, live)
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_fused_cuda

    return bp_wave_fused_cuda(state, ch_llr, retire, iters=iters,
                              flavor=flavor, check_every=check_every,
                              live=live)


# ---------------------------------------------------------------------------
# BPr instrumentation (ref: BPr_128.c:373-580): BP with a snapshot of every
# stage's hard decisions at each checkpoint iteration.  The message lists
# Ls, Rs of the JAX package's bpr_decode are the wave state's planes (L[n]
# the channel LLRs, R[0] the frozen row), so the iterations between
# checkpoints are bp_wave's, the kernel of ops/bp_wave_kernel.py on a CUDA
# float32 tensor.


def bpr_stage_errors(state: torch.Tensor, info_set: torch.Tensor,
                     true_info: torch.Tensor) -> torch.Tensor:
    """[n+1] int64, summed over the batch: for each stage i, the info-bit
    mismatches of the hard decisions sign(L[i] + R[i]) < 0 carried left
    through butterfly levels i-1 .. 0 (upper <- upper xor lower), against
    true_info [B, K'].  The n+1 decision planes are stacked, and level k is
    applied to every plane above it at once: n in-place xor steps."""
    n = state.shape[0] // 2 - 1
    B, N = state.shape[1:]
    b = (state[:n + 1] + state[n + 1:] < 0).to(torch.int8)
    for k in range(n - 1, -1, -1):
        d = 1 << k
        v = b[k + 1:].view(n - k, B, N // (2 * d), 2, d)
        v[..., 0, :] ^= v[..., 1, :]
    return (b[:, :, info_set] != true_info).sum(dim=(1, 2))


def bpr_decode(ch_llr: torch.Tensor, frozen: torch.Tensor, true_u: torch.Tensor,
               info_positions, iters: int = 90, flavor: str = "minsum_lut",
               checkpoints: tuple = (3, 6, 10, 20, 40, 80),
               engine: str = "auto"):
    """BP with a snapshot at each checkpoint iteration (the JAX package's
    bpr_decode): (u_hat [B, N] int8, E [len(checkpoints), n+1] int64, row j
    the stage errors (bpr_stage_errors) after sorted(checkpoints)[j]
    iterations).  As there, a repeated checkpoint snapshots the same state
    again, the iterations run on to a checkpoint past `iters`, and u_hat is
    decided after max(iters, the last checkpoint) iterations.

    On a CUDA float32 tensor with engine="auto" the iterations between
    checkpoints run through the wave kernel (bp_wave, one launch a segment
    of at least one iteration, on the decode's own state); elsewhere, or
    with engine="plain", through bp_wave_plain in ch_llr's dtype.  The
    kernel is float32-only: another dtype on a CUDA tensor with
    engine="auto" raises ValueError."""
    if (use_kernel(ch_llr, engine, "bpr_decode")
            and ch_llr.dtype != torch.float32):
        raise ValueError(f"the BP wave kernel is float32-only, got "
                         f"{ch_llr.dtype}: pass engine='plain'")
    info_set = torch.as_tensor(info_positions, device=ch_llr.device)
    true_info = true_u[:, info_set]
    n = ch_llr.shape[1].bit_length() - 1
    state = wave_init_state(ch_llr, frozen)

    def advance(state, count):
        if count == 0:
            return state
        return bp_wave(state, count, flavor, engine)

    errs, it = [], 0
    for c in sorted(checkpoints):
        state = advance(state, c - it)
        it = c
        errs.append(bpr_stage_errors(state, info_set, true_info))
    if it < iters:
        state = advance(state, iters - it)
    u_hat = ((state[0] + state[n + 1] < 0) & ~frozen).to(torch.int8)
    return u_hat, torch.stack(errs)


# ---------------------------------------------------------------------------
# In-kernel Monte-Carlo wave engine: refill generation (payload table, its
# codeword, counter-based Gaussian channel), K iterations with cadenced
# G-matrix retirement and in-place refills from `spares` generations per
# slot, and error counting, in one step.
#
# Engine contract (as the JAX package's): slot s decodes frames s, s+B,
# s+2B, ... (payloads a pure function of the frame index); a frame's noise
# is the spare generated for the wave it entered, deterministic in
# (seed, B, K, step) but not a function of the frame index alone.


def mc_u_table(info_positions, K: int, N: int, device=None) -> torch.Tensor:
    """[128, N] float32: row m is the true u of PN offset m (63 rows, then
    zero rows): payload bit i at info position I[i] is PN[(m + i) % 63]."""
    pn = pn_sequence()
    tab = np.zeros((128, N), np.float32)
    I = np.asarray(info_positions)
    for m in range(PN_PERIOD):
        tab[m, I] = pn[(m + np.arange(K)) % PN_PERIOD]
    return torch.as_tensor(tab, device=device)


def mc_tables(info_positions, K: int, N: int, device=None):
    """(u_table, x_table) [128, N] float32: the payload rows and their
    codewords x = u . F^{tensor n}."""
    utab = mc_u_table(info_positions, K, N, device)
    return utab, polar_encode(utab.to(torch.int8)).to(torch.float32)


def mc_delta(batch: int, K: int) -> int:
    """PN-offset advance between a slot's consecutive frames."""
    return (batch * (K % PN_PERIOD)) % PN_PERIOD


def mc_meta_init(batch: int, N: int, K: int, device=None) -> torch.Tensor:
    """Initial meta planes [4, B, N] float32 (m, true u, iterations done,
    pending): every slot pending, so that the first wave's head merge fills
    it; m stepped back by delta so that slot s's first frame has offset
    (s * (K % 63)) % 63."""
    m0 = (torch.arange(batch, device=device) * (K % PN_PERIOD)) % PN_PERIOD
    m_init = (m0 - mc_delta(batch, K)) % PN_PERIOD
    meta = torch.zeros((4, batch, N), dtype=torch.float32, device=device)
    meta[0] = m_init.to(torch.float32)[:, None]
    meta[3] = 1.0
    return meta


def mc_bits(seeds, spares: int, batch: int, N: int, device=None) -> torch.Tensor:
    """The generations' noise words [spares, B, N] (int64) of one wave in
    noise="kernel" mode: threefry2x32 under the run key (seeds[0],
    seeds[1]) at counter (seeds[3] * spares + g, slot * N + lane)."""
    k0, k1, _, step = (int(s) for s in seeds)
    return torch.stack([counter_bits(k0, k1, step * spares + g, batch, N, device)
                        for g in range(spares)])


def bp_wave_mc_plain(state, meta, u_table, x_table, sigma, bits,
                     iters: int = 8, flavor: str = "minsum_lut",
                     iter_max: int = 100, delta: int = 0, drain: bool = False,
                     spares: int = 2, cadence: int = 1):
    """The plain version of the MC wave (the JAX package's bp_wave_mc_jnp,
    unrolled as it is): bits [spares, B, N] are the generations' noise
    words.  Returns (state', meta', stats [B, 3] float32: per-slot errbit,
    errblock and frames retired this wave).  Checks run every `cadence`
    iterations and at the last; a done frame retires at once while its slot
    has a generation left, else at the last iteration into `pending`."""
    chk_fn = CHK_FNS[flavor]
    S2, B, N = state.shape
    n = S2 // 2 - 1
    zero = torch.zeros((B, N), dtype=torch.float32, device=state.device)
    m_in, u_in, it_in, pend_in = meta
    m_g, u_g, llr_g = [], [], []
    for g in range(spares):
        mg = m_in + float(((g + 1) * delta) % PN_PERIOD)
        mg = torch.where(mg >= 63.0, mg - 63.0, mg)
        rows = mg[:, 0].to(torch.int64)
        m_g.append(mg)
        u_g.append(u_table[rows])
        llr_g.append(mc_llr(bits[g], x_table[rows], sigma))

    rm = torch.zeros_like(pend_in, dtype=torch.bool) if drain else pend_in > 0.5
    frozen = state[n + 1] > 0.0
    Ls, Rs = _planes(torch.where(rm[None], 0.0, state))
    Ls[n] = torch.where(rm, llr_g[0], state[n])
    Rs[0] = state[n + 1]
    m_c = torch.where(rm, m_g[0], m_in)
    u_c = torch.where(rm, u_g[0], u_in)
    it_c = torch.where(rm, zero, it_in)
    rmf = rm.to(torch.float32)
    avail = zero if drain else spares - rmf  # generations left
    ptr = rmf  # the next generation to consume
    pend_c = pend_in if drain else zero

    eb, ebl, fr = zero, zero, zero
    since = 0
    for it in range(iters):
        Ls, Rs = bp_iteration(Ls, Rs, chk_fn)
        since += 1
        last = it == iters - 1
        if (it + 1) % cadence and not last:
            continue
        alive = 1.0 - pend_c
        it_c = it_c + float(since) * alive
        since = 0
        u8, ok = _decide(Ls, Rs, frozen)
        u = u8.to(torch.float32)
        okm = ok[:, None].expand(B, N).to(torch.float32)
        done = torch.maximum(okm, (it_c >= float(iter_max)).to(torch.float32)) * alive
        has = (avail > 0.5).to(torch.float32)
        retire_now = done * has
        retire = retire_now + done * (1.0 - has) if last else retire_now
        bad = torch.abs(u - u_c) * retire
        eb = eb + bad
        ebl = ebl + bad.amax(dim=1, keepdim=True)
        fr = fr + retire
        m_nx, u_nx, llr_nx = m_g[0], u_g[0], llr_g[0]
        for g in range(1, spares):
            pick = ptr == float(g)
            m_nx = torch.where(pick, m_g[g], m_nx)
            u_nx = torch.where(pick, u_g[g], u_nx)
            llr_nx = torch.where(pick, llr_g[g], llr_nx)
        rm2 = retire_now > 0.5
        Ls = [torch.where(rm2, 0.0, x) for x in Ls[:n]] + [
            torch.where(rm2, llr_nx, Ls[n])]
        Rs = [torch.where(frozen, FROZEN_R, 0.0)] + [
            torch.where(rm2, 0.0, x) for x in Rs[1:]]
        m_c = torch.where(rm2, m_nx, m_c)
        u_c = torch.where(rm2, u_nx, u_c)
        it_c = torch.where(rm2, zero, it_c)
        ptr = ptr + retire_now
        avail = avail - retire_now
        if last:
            pend_c = torch.maximum(pend_c, done * (1.0 - has))
    stats = torch.stack([eb.sum(dim=1), ebl.amax(dim=1), fr.amax(dim=1)], dim=1)
    return (torch.stack(Ls + Rs, dim=0),
            torch.stack([m_c, u_c, it_c, pend_c], dim=0), stats)


def bp_wave_mc(state, meta, u_table, x_table, sigma, seeds, bits=None,
               iters: int = 8, flavor: str = "minsum_lut", iter_max: int = 100,
               delta: int = 0, gen_bits: bool = True, drain: bool = False,
               spares: int = 2, cadence: int = 1, tile: int = 0,
               bit_gen: str = "tf32", engine: str = "auto"):
    """One MC wave -> (state', meta', stats [B, 3]).

    seeds: 4 words (k0, k1, k0 ^ k1, step).  gen_bits=True draws each
    generation's noise from the counter generator (mc_bits), the TPU
    kernel's semantics, on either device; gen_bits=False takes `bits`
    [spares, B, N] (32-bit words).  bit_gen="hw" is the TPU's own PRNG,
    which the JAX package rejects too; tile is a TPU layout knob, accepted
    and unused.  The CUDA kernel (ops/bp_wave_mc_kernel.py) runs on a CUDA
    tensor and updates state and meta in place; the plain version on a CPU
    tensor or with engine="plain"."""
    if bit_gen != "tf32":
        raise ValueError(f"bit_gen={bit_gen!r}: only the counter-based "
                         "threefry generator 'tf32' is supported")
    if not gen_bits and bits is None:
        raise ValueError("gen_bits=False needs bits [spares, B, N]")
    if not use_kernel(state, engine, "bp_wave_mc"):
        if gen_bits:
            bits = mc_bits(seeds, spares, state.shape[1], state.shape[2],
                           state.device)
        return bp_wave_mc_plain(state, meta, u_table, x_table, sigma, bits,
                                iters=iters, flavor=flavor, iter_max=iter_max,
                                delta=delta, drain=drain, spares=spares,
                                cadence=cadence)
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_cuda

    return bp_wave_mc_cuda(state, meta, u_table, x_table, sigma, seeds,
                           None if gen_bits else bits, iters=iters,
                           flavor=flavor, iter_max=iter_max, delta=delta,
                           drain=drain, spares=spares, cadence=cadence)
