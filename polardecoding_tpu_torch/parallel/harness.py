"""Monte-Carlo simulation harness: batched frame pipeline, the
continuous-batching BP wave engines and the adaptive-stop sweep (torch port
of polardecoding_tpu.parallel.harness: the BP, SC, SCL and CA-SCL frame
steps, the fused, unfused and in-kernel-MC wave steps, run_point_waves).

  reference (per frame, serial)            here (per super-batch, on the card)
  ---------------------------------        -------------------------------------
  payload from PN window                   PN gather, frame-index arithmetic
  encode x = u . Fn  (O(N^2) stdin matrix) GF(2) product or butterfly encode
  normal() noise loop                      counter-based per-frame keys
  decode                                   batched BP / SC / SCL / CA-SCL
                                           (CUDA kernels on the card)
  count info-bit errors                    vectorized compare + reduce
  stop when errBlock >= target             host-side stop on the counters

Payloads and noise are pure functions of (seed, frame index), with the JAX
package's generator (ops/channel.py), so a frame here is the same frame as
there and results are independent of batch size.  Error counts follow the
reference: block error = any mismatch over the info set; BLER =
errBlock / run.  pm_ties counts the frames where an SCL selection hit an
exact PM tie at the median (0 for BP and SC).

BP early-stop presets run on the wave engine (run_point_waves), as in the
JAX package.  The MC noise source is an explicit argument here,
noise="kernel" (default: the counter generator of the TPU kernels) or
"threefry" (jax.random.bits, what the JAX package draws off the TPU); it
does not change with the device, so a port run never depends on it.

Presets with scl_r1 > 0 (the _FASTR1 ones) decode with the approximate
rate-1 SCL flavor on every device; the JAX package decodes them so only
through its TPU kernel, and exact elsewhere.

Out of this slice: decoder kind "bpr" (ROADMAP A8) raises
NotImplementedError.  There is no multi-device path yet (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from polardecoding_tpu_torch.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu_torch.configs import Preset
from polardecoding_tpu_torch.convert import (
    CodeTables,
    code_tables_from_numpy,
    point_result_from_json,
)
from polardecoding_tpu_torch.models.bp import (
    bp_decode_auto,
    bp_wave,
    bp_wave_fused,
    bp_wave_mc,
    mc_delta,
    mc_meta_init,
    mc_tables,
    wave_decide,
    wave_init_state,
    wave_merge,
)
from polardecoding_tpu_torch.models.scl import (
    cascl_decode,
    default_wloop,
    sc_decode_auto,
    scl_decode_auto,
)
from polardecoding_tpu_torch.ops.channel import (
    awgn_llr,
    fold_in,
    frame_keys,
    prng_key,
    random_bits,
)
from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
from polardecoding_tpu_torch.ops.crc import (
    check_matrix,
    crc_encode_multiplicative,
    crc_encode_systematic,
)
from polardecoding_tpu_torch.ops.encode import (
    encode_info_mxu,
    info_sub_generator,
    polar_encode,
    scatter_info,
)
from polardecoding_tpu_torch.utils.pn import PN_PERIOD, pn_sequence

# wave steps run per counter read-back in run_point_waves, as the JAX
# package's scan chunk
SYNC_EVERY = 8


@dataclasses.dataclass
class PointResult:
    """One SNR point, with the JAX package's JSON record."""

    preset: str
    snr_db: float
    errbit: int
    errblock: int
    frames: int
    seed: int
    elapsed_s: float = 0.0
    # frames where an SCL selection hit an exact PM tie at the median; 0 for
    # the BP decoder
    pm_ties: int = 0

    @property
    def bler(self) -> float:
        return self.errblock / max(self.frames, 1)

    @property
    def errbits_per_frame(self) -> float:
        return self.errbit / max(self.frames, 1)

    def to_json(self, num_info: int) -> dict:
        return {
            "preset": self.preset,
            "snr_db": self.snr_db,
            "errbit": self.errbit,
            "errblock": self.errblock,
            "frames": self.frames,
            "bler": self.bler,
            "ber": self.errbit / max(self.frames * num_info, 1),
            "seed": self.seed,
            "elapsed_s": self.elapsed_s,
            "pm_ties": self.pm_ties,
        }


def payload_from_index(frame_index: torch.Tensor, pn: torch.Tensor, K: int):
    """PN-window payload per frame (ref: SC_128.c:179-181, 214-215):
    payload[b, i] = PN[(m_b + i) % 63], m_b = (frame_index * (K % 63)) % 63."""
    m = (frame_index * (K % PN_PERIOD)) % PN_PERIOD
    idx = (m[:, None] + torch.arange(K, device=pn.device)[None, :]) % PN_PERIOD
    return pn[idx]


def code_tables(code, device) -> CodeTables:
    """The code's tables from the port's own construction."""
    I = code_info_set(code)
    return code_tables_from_numpy(code_frozen_mask(code), I, pn_sequence(),
                                  info_sub_generator(I, code.N), device)


def _make_encoder(encoder: str, tables: CodeTables, N: int) -> Callable:
    """Codeword map w [B, K'] -> x [B, N] in {0, 1}: "mxu" is the GF(2)
    product x = (w . G_I) mod 2, "butterfly" the scatter + O(N log N) xor
    stages; both give the same codewords."""
    if encoder == "mxu":
        return lambda w: encode_info_mxu(w, tables.g_rows)
    if encoder == "butterfly":
        return lambda w: polar_encode(scatter_info(w, tables.info_set, N))
    raise ValueError(f"unknown encoder {encoder!r}")


def _make_decoder(preset: Preset, tables: CodeTables, engine: str) -> Callable:
    """Channel LLRs [B, N] -> (u_hat [B, N] int8, per-frame tie counter [B]
    or None), as the JAX step's decode."""
    code, dec = preset.code, preset.decoder
    frozen = tables.frozen
    if dec.kind == "bp":
        es = 4 if dec.bp_early_stop else 0
        return lambda llr: (bp_decode_auto(
            llr, frozen, iters=dec.bp_iters, flavor=dec.bp_flavor,
            early_stop_every=es, engine=engine), None)
    if dec.kind == "sc":
        return lambda llr: (sc_decode_auto(llr, frozen, engine=engine),
                            None)
    flavor = dict(r1=dec.scl_r1,
                  wloop=default_wloop(code.N.bit_length() - 1, dec.list_size))
    if dec.kind == "scl":
        return lambda llr: scl_decode_auto(
            llr, frozen, list_size=dec.list_size, return_ties=True,
            engine=engine, **flavor)
    if dec.kind == "cascl":
        crc_R = check_matrix(code.crc, code.num_info)
        return lambda llr: cascl_decode(
            llr, frozen, tables.info_set, crc_R, list_size=dec.list_size,
            return_ties=True, engine=engine, **flavor)
    raise NotImplementedError(
        f"decoder kind {dec.kind!r} has no frame step in the port "
        "(BPr is ROADMAP A8)")


def _crc_encode(code, payload):
    if code.crc is None:
        return payload
    if code.crc_style == "systematic":
        return crc_encode_systematic(payload, code.crc)
    return crc_encode_multiplicative(payload, code.crc)


def _mc_mode_tables(code, device):
    """(u_table, x_table) [128, N] float32 of the MC channel: row m is the
    full true u (payload and CRC bits at the info set) of PN offset m and
    row m of x_table its codeword; 63 rows, then zero rows."""
    N, K = code.N, code.K
    pn = pn_sequence()
    pays = np.stack([pn[(m + np.arange(K)) % PN_PERIOD] for m in range(PN_PERIOD)])
    w = _crc_encode(code, torch.as_tensor(pays))
    u = scatter_info(w, torch.as_tensor(code_info_set(code), dtype=torch.int64), N)
    pad = torch.zeros((128 - PN_PERIOD, N), dtype=torch.float32)
    utab = torch.cat([u.to(torch.float32), pad])
    xtab = torch.cat([polar_encode(u).to(torch.float32), pad])
    return utab.to(device), xtab.to(device)


def make_frame_step(preset: Preset, batch: int, device="cuda",
                    engine: str = "auto", encoder: str = "mxu",
                    channel: str = "threefry", noise: str = "kernel",
                    tables: Optional[CodeTables] = None) -> Callable:
    """Build the super-batch step: (key, frame_start, sigma) ->
    (errbit, errblock, pm_ties), 0-dim int64 tensors on `device` summed over
    the batch of frames frame_start .. frame_start + batch - 1.

    key: the point's key from ops/channel (int64 [2]); sigma: a float.
    engine: "auto" (the decoder's and the MC channel's CUDA kernels for a
    CUDA device, their plain versions on the CPU) or "plain".  encoder:
    "mxu" or "butterfly".  channel: "threefry" (per-frame keys, pure in
    (seed, frame index)) or "mc" (ops/channel_kernel.mc_channel: codeword
    table and counter noise, pure in (seed, frame_start, batch)), whose
    noise words are the TPU kernel's counter words (noise="kernel") or
    jax.random.bits under fold_in(key, frame_start) (noise="threefry", what
    the JAX package draws off the TPU); errors are counted over all N
    positions against the table's u (frozen positions agree).  tables: the
    code's tables (convert.code_tables_from_numpy), by default built from
    the preset."""
    code = preset.code
    if channel not in ("threefry", "mc"):
        raise ValueError(f"unknown channel {channel!r}")
    if noise not in ("kernel", "threefry"):
        raise ValueError(f"unknown noise {noise!r}")
    N, K = code.N, code.K
    device = torch.device(device)
    if tables is None:
        tables = code_tables(code, device)
    encode = _make_encoder(encoder, tables, N)
    decode = _make_decoder(preset, tables, engine)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    no_ties = torch.zeros((), dtype=torch.int64, device=device)
    if channel == "mc":
        utab, xtab = _mc_mode_tables(code, device)

    def mc_llr(key, frame_start, fidx, sigma):
        m = (fidx * (K % PN_PERIOD)) % PN_PERIOD
        k0, k1 = key.tolist()
        bits = None
        if noise == "threefry":
            bits = random_bits(fold_in(key.to(device), frame_start),
                               batch * N).reshape(batch, N)
        llr = mc_channel(m, xtab, sigma, (k0, k1, k0 ^ k1, frame_start), bits,
                         gen_bits=bits is None, engine=engine)
        return llr, utab[m].to(torch.int8)

    def step(key, frame_start, sigma):
        fidx = frame_start + lanes
        if channel == "mc":
            llr, u = mc_llr(key, frame_start, fidx, sigma)
            u_hat, ties = decode(llr)
            bad = u_hat != u
        else:
            w = _crc_encode(code, payload_from_index(fidx, tables.pn, K))
            llr = awgn_llr(encode(w), frame_keys(key.to(device), fidx), sigma)
            u_hat, ties = decode(llr)
            bad = u_hat[:, tables.info_set] != w
        pm_ties = no_ties if ties is None else (ties > 0).sum()
        return bad.sum(), bad.any(dim=-1).sum(), pm_ties

    return step


def make_wave_step(preset: Preset, batch: int, wave_iters: int = 8,
                   device="cuda", fused: bool = True, encoder: str = "mxu",
                   check_every: int = 0, engine: str = "auto",
                   tables: Optional[CodeTables] = None) -> tuple:
    """Continuous-batching BP stepper (the early-stop engine) -> (init,
    step, drain):

      init(key, frame_start, sigma) -> carry
      step(key, sigma, carry) -> (carry', (errbit, errblock, frames))
      drain(sigma, carry) -> (carry', (errbit, errblock, frames, remaining))

    with 0-dim int64 tensors on `device`.  Each step advances every slot's
    frame by `wave_iters` BP iterations, retires the frames whose G-matrix
    check passes or that reached iterMax, counts their info-bit errors and
    refills the freed slots in place with the next frame indices (rank
    order), so a frame's decision is a pure function of (seed, frame index,
    wave_iters).  drain retires without refilling, so that the slow frames
    in flight are counted too.

    fused=True runs merge + wave + decide in one kernel (bp_wave_fused): a
    step's retirees are refilled at the head of the next step's kernel, so
    the carry also holds the pending retire mask, and fresh LLRs are drawn
    for every slot each step (only the retired slots use them), as in the
    JAX package.  Per-step counters equal fused=False's.  check_every > 0
    (fused only) also checks inside the wave and latches a frame at its
    first passing check.  engine: "auto" or "plain", as make_frame_step's.
    The carry's state is updated in place on the card: do not reuse a carry
    after stepping it."""
    code, dec = preset.code, preset.decoder
    if dec.kind != "bp":
        raise ValueError("wave stepping is a BP engine")
    if check_every and not fused:
        raise ValueError("check_every needs the fused wave kernel")
    N, K = code.N, code.K
    iter_max = dec.bp_iters
    device = torch.device(device)
    if tables is None:
        tables = code_tables(code, device)
    encode = _make_encoder(encoder, tables, N)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    wave = dict(iters=wave_iters, flavor=dec.bp_flavor, engine=engine)

    def fresh_llr(key, fidx, sigma):
        x = encode(payload_from_index(fidx, tables.pn, K))
        return awgn_llr(x, frame_keys(key.to(device), fidx), sigma)

    def count(u_hat, fidx, retire):
        payload = payload_from_index(fidx.clamp_min(0), tables.pn, K)
        bad = (u_hat[:, tables.info_set] != payload) & retire[:, None]
        return bad.sum(), bad.any(dim=-1).sum(), retire.sum()

    def refill(fidx, next_fidx, retire):
        rank = torch.cumsum(retire.to(torch.int64), dim=0) - 1
        return (torch.where(retire, next_fidx + rank, fidx),
                next_fidx + retire.sum())

    def drain_count(u_hat, fidx, done, iters_done):
        retire = (done | (iters_done >= iter_max)) & (fidx >= 0)
        eb, ebl, fr = count(u_hat, fidx, retire)
        fidx = torch.where(retire, -1, fidx)
        return fidx, (eb, ebl, fr, (fidx >= 0).sum())

    zeros = torch.zeros(batch, dtype=torch.int64, device=device)
    if fused:
        def init_fused(key, frame_start, sigma):
            # every slot retired: the first step's kernel merge fills it
            state = wave_init_state(torch.zeros((batch, N), device=device),
                                    tables.frozen)
            return (state, zeros, zeros, zeros[0] + frame_start,
                    torch.ones(batch, dtype=torch.bool, device=device))

        def step_fused(key, sigma, carry):
            state, fidx, iters_done, next_fidx, retire = carry
            fidx, next_fidx = refill(fidx, next_fidx, retire)
            iters_done = torch.where(retire, 0, iters_done)
            state, u_hat, done = bp_wave_fused(
                state, fresh_llr(key, fidx, sigma), retire,
                check_every=check_every, **wave)
            iters_done = iters_done + wave_iters
            retire = done | (iters_done >= iter_max)
            return ((state, fidx, iters_done, next_fidx, retire),
                    count(u_hat, fidx, retire))

        def drain_fused(sigma, carry):
            # the pending retirees were counted by the last step: their
            # slots die instead of refilling
            state, fidx, iters_done, next_fidx, retire = carry
            fidx = torch.where(retire, -1, fidx)
            no_retire = torch.zeros_like(retire)
            state, u_hat, done = bp_wave_fused(
                state, torch.zeros((batch, N), device=device), no_retire,
                check_every=check_every, **wave)
            iters_done = iters_done + wave_iters
            fidx, out = drain_count(u_hat, fidx, done, iters_done)
            return (state, fidx, iters_done, next_fidx, no_retire), out

        return init_fused, step_fused, drain_fused

    def init(key, frame_start, sigma):
        fidx = frame_start + lanes
        state = wave_init_state(fresh_llr(key, fidx, sigma), tables.frozen)
        return state, fidx, zeros, zeros[0] + frame_start + batch

    def step(key, sigma, carry):
        state, fidx, iters_done, next_fidx = carry
        state = bp_wave(state, **wave)
        iters_done = iters_done + wave_iters
        u_hat, done = wave_decide(state, tables.frozen)
        retire = done | (iters_done >= iter_max)
        out = count(u_hat, fidx, retire)
        fidx, next_fidx = refill(fidx, next_fidx, retire)
        # R[0] is the same frozen row in every slot, so the merge is the
        # JAX package's where(retire, wave_init_state(llr), state)
        state = wave_merge(state, fresh_llr(key, fidx, sigma), retire)
        iters_done = torch.where(retire, 0, iters_done)
        return (state, fidx, iters_done, next_fidx), out

    def drain(sigma, carry):
        state, fidx, iters_done, next_fidx = carry
        state = bp_wave(state, **wave)
        iters_done = iters_done + wave_iters
        u_hat, done = wave_decide(state, tables.frozen)
        fidx, out = drain_count(u_hat, fidx, done, iters_done)
        return (state, fidx, iters_done, next_fidx), out

    return init, step, drain


def make_wave_step_mc(preset: Preset, batch: int, wave_iters: int = 8,
                      device="cuda", noise: str = "kernel", spares: int = 0,
                      cadence: int = 1, tile: int = 0,
                      engine: str = "auto") -> tuple:
    """In-kernel-MC continuous-batching BP stepper (models/bp.bp_wave_mc) ->
    (init, step, drain) with make_wave_step's signatures.

    One kernel per wave generates the refills (payload table, codeword,
    counter noise), runs wave_iters iterations with a G-matrix check every
    `cadence` iterations and an in-place refill from one of `spares`
    generations per slot and wave (default max(2, wave_iters // 8)), and
    counts the errors.  Slot s decodes frames s, s+B, ...; a frame's noise
    is the generation of the wave it entered, deterministic in (seed, B, K,
    step) but not a function of the frame index alone.  noise="kernel"
    draws the TPU kernel's counter words under the run key, "threefry"
    jax.random.bits under fold_in(run key, step), what the JAX package
    draws off the TPU; either on either device.  tile is a TPU knob,
    accepted and unused; engine: "auto" or "plain"."""
    code, dec = preset.code, preset.decoder
    if dec.kind != "bp":
        raise ValueError("wave stepping is a BP engine")
    if noise not in ("kernel", "threefry"):
        raise ValueError(f"unknown noise {noise!r}")
    N, K = code.N, code.K
    if spares == 0:
        spares = max(2, wave_iters // 8)
    device = torch.device(device)
    frozen = torch.as_tensor(code_frozen_mask(code), device=device)
    utab, xtab = mc_tables(code_info_set(code), K, N, device)
    kw = dict(iters=wave_iters, flavor=dec.bp_flavor, iter_max=dec.bp_iters,
              delta=mc_delta(batch, K), spares=spares, cadence=cadence,
              engine=engine)

    def wave(sigma, carry, drain):
        state, meta, stepc, (k0, k1) = carry
        bits = None
        if noise == "threefry":
            key = fold_in(torch.tensor([k0, k1], device=device), stepc)
            bits = random_bits(key, spares * batch * N).reshape(spares, batch, N)
        state, meta, stats = bp_wave_mc(
            state, meta, utab, xtab, sigma, (k0, k1, k0 ^ k1, stepc), bits,
            gen_bits=bits is None, drain=drain, **kw)
        eb, ebl, fr = stats.to(torch.int64).sum(dim=0)
        return (state, meta, stepc + 1, (k0, k1)), (eb, ebl, fr)

    def init(key, frame_start, sigma):
        # every slot pending: the first wave's head merge fills it; the run
        # key takes frame_start in, so a resumed point draws fresh noise
        ckey = tuple(fold_in(key, frame_start).tolist())
        state = wave_init_state(torch.zeros((batch, N), device=device), frozen)
        return state, mc_meta_init(batch, N, K, device), 0, ckey

    def step(key, sigma, carry):
        return wave(sigma, carry, False)

    def drain(sigma, carry):
        carry, out = wave(sigma, carry, True)
        dead = carry[1][3, :, 0].to(torch.int64).sum()
        return carry, out + (batch - dead,)

    return init, step, drain


def _read_later(counters: torch.Tensor) -> Callable[[], list]:
    """Start copying counters to the host; the returned function waits for
    them and gives them as a list.  On the card the copy is asynchronous, so
    the host can enqueue more work before it reads."""
    if counters.device.type != "cuda":
        return counters.tolist
    host = torch.empty(counters.shape, dtype=counters.dtype, pin_memory=True)
    host.copy_(counters, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()

    def get():
        ready.synchronize()
        return host.tolist()

    return get


def run_point_waves(
    preset: Preset,
    snr_db: float,
    batch: Optional[int] = None,
    wave_iters: int = 8,
    device="cuda",
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    start_state: Optional[PointResult] = None,
    log: Optional[Callable[[str], None]] = None,
    fused: bool = True,
    check_every: int = 0,
    engine: str = "fused",
    noise: str = "kernel",
    cadence: int = 1,
    spares: int = 0,
) -> PointResult:
    """Adaptive MC at one SNR point on the continuous-batching BP engine:
    engine="fused" (make_wave_step, with `fused` and `check_every`) or "mc"
    (make_wave_step_mc, with `noise`, `cadence` and `spares`).

    The steps run in chunks of SYNC_EVERY; a chunk's summed counters are
    read while the next chunk runs, so the stop check lags one chunk (the
    frames run meanwhile are counted).  Then the frames in flight are
    drained, so that slow frames are not censored.  A point counts the same
    frames as the JAX package's run_point_waves."""
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    if batch is None:
        batch = sweep.batch_per_device
    if engine == "mc":
        init, step, drain = make_wave_step_mc(preset, batch, wave_iters, device,
                                              noise=noise, cadence=cadence,
                                              spares=spares)
    elif engine == "fused":
        init, step, drain = make_wave_step(preset, batch, wave_iters, device,
                                           fused=fused, check_every=check_every)
    else:
        raise ValueError(f"unknown wave engine {engine!r}")
    sigma = float(10.0 ** (-snr_db / 20.0))
    key = fold_in(prng_key(seed, device), int(round(snr_db * 100)))
    res = start_state or PointResult(preset.name, snr_db, 0, 0, 0, seed)
    carry = init(key, res.frames, sigma)
    t0 = time.perf_counter()

    def take(counts):
        res.errbit += counts[0]
        res.errblock += counts[1]
        res.frames += counts[2]

    pending = None
    while res.errblock < target and res.frames < cap:
        total = 0
        for _ in range(SYNC_EVERY):
            carry, out = step(key, sigma, carry)
            total = total + torch.stack(out)
        if pending is not None:
            take(pending())
        pending = _read_later(total)
        if log:
            # counted frames lag one chunk behind the steps run
            log(f"{preset.name} @ {snr_db:.2f} dB (waves): "
                f"counted={res.frames} errblock={res.errblock} "
                f"bler={res.bler:.3e}")
    if pending is not None:
        take(pending())
    remaining = batch
    while remaining > 0:
        carry, out = drain(sigma, carry)
        counts = torch.stack(out).tolist()
        take(counts)
        remaining = counts[3]
    res.elapsed_s += time.perf_counter() - t0
    return res


def run_point(
    preset: Preset,
    snr_db: float,
    batch: Optional[int] = None,
    device="cuda",
    step_fn: Optional[Callable] = None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    start_state: Optional[PointResult] = None,
    log: Optional[Callable[[str], None]] = None,
) -> PointResult:
    """Adaptive-length MC for one SNR point: run super-batches until the
    error-block target or the frame cap (ref stop rule, e.g. BP_128.c:168).

    The counters are read after every step, so the frames counted are those
    of the JAX package's run_point with sync_every=1.  BP early-stop
    presets run on the wave engine (run_point_waves, each frame retiring at
    its own convergence wave) unless a step_fn is given."""
    if (step_fn is None and preset.decoder.kind == "bp"
            and preset.decoder.bp_early_stop):
        return run_point_waves(preset, snr_db, batch=batch, device=device,
                               error_blocks=error_blocks, max_frames=max_frames,
                               seed=seed, start_state=start_state, log=log)
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    if batch is None:
        batch = sweep.batch_per_device
    if step_fn is None:
        step_fn = make_frame_step(preset, batch, device)

    sigma = float(10.0 ** (-snr_db / 20.0))
    key = fold_in(prng_key(seed, device), int(round(snr_db * 100)))
    res = start_state or PointResult(preset.name, snr_db, 0, 0, 0, seed)
    t0 = time.perf_counter()
    while res.errblock < target and res.frames < cap:
        eb, ebl, ties = step_fn(key, res.frames, sigma)
        res.errbit += int(eb)
        res.errblock += int(ebl)
        res.pm_ties += int(ties)
        res.frames += batch
        if log:
            log(
                f"{preset.name} @ {snr_db:.2f} dB: frames={res.frames} "
                f"errblock={res.errblock} bler={res.bler:.3e}"
            )
    res.elapsed_s += time.perf_counter() - t0
    return res


def run_sweep(
    preset: Preset,
    batch: Optional[int] = None,
    device="cuda",
    snr_points=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    seed: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    log: Optional[Callable[[str], None]] = None,
) -> list[PointResult]:
    """Full SNR sweep with optional JSON checkpointing: each finished point
    is written, and a rerun resumes every point from its record (a
    checkpoint of either package)."""
    if batch is None:
        batch = preset.sweep.batch_per_device
    # early-stop BP presets take run_point's wave-engine path
    wave_es = preset.decoder.kind == "bp" and preset.decoder.bp_early_stop
    step_fn = None if wave_es else make_frame_step(preset, batch, device)
    points = preset.sweep.snr_points() if snr_points is None else list(snr_points)

    done: dict[float, PointResult] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            for rec in json.load(f):
                done[rec["snr_db"]] = point_result_from_json(rec)

    results = []
    for snr in points:
        res = run_point(
            preset, snr, batch=batch, device=device, step_fn=step_fn,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            start_state=done.get(snr), log=log,
        )
        results.append(res)
        if checkpoint_path:
            with open(checkpoint_path, "w") as f:
                json.dump(
                    [r.to_json(preset.code.num_info) for r in results], f, indent=1
                )
        if log:
            log(
                f"DONE {preset.name} @ {snr:.2f} dB: BLER={res.bler:.4e} "
                f"({res.errblock}/{res.frames})"
            )
    return results
