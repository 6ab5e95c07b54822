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

BPr presets (decoder kind "bpr") run on make_bpr_step and run_bpr_point,
whose step also returns the per-checkpoint stage-error table; their
iterations go through the unfused wave kernel on the card.  The fused SNR
sweep (make_multisnr_step, run_fused_sweep) runs frame i at sigmas[i %
num_snr], one launch of the frame channel with a sigma table a step, and
counts per SNR.  run_multiseed replicates a sweep over seeds.

Several processes count one sweep through torch.distributed
(parallel/mesh.py): every step builder takes mesh=, a DataMesh, and splits
its global batch B into one contiguous slice of B / W frames per rank; its
step returns the global counters on every rank, so every rank takes the
same stop decision.  The wave engines' refill order is the global one: a
step's one all-gather of each rank's counters also gives the retirements
of the ranks before it.  A step builder with mesh=None is one process on
`device`; a runner with mesh=None takes data_mesh(), the default process
group's mesh when torch.distributed is initialised.  Checkpoints and logs
come from rank 0.  The MC engine (make_wave_step_mc) has no mesh path, as
in the JAX package: a mesh of more than one rank raises ValueError.
"""
from __future__ import annotations

import contextlib
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
    bpr_decode,
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
from polardecoding_tpu_torch.ops._build import use_kernel
from polardecoding_tpu_torch.ops.channel import (
    fold_in,
    frame_llr,
    prng_key,
    random_bits,
    sigma_from_ebn0_db,
)
from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
from polardecoding_tpu_torch.ops.crc import (
    check_matrix,
    crc_encode_multiplicative,
    crc_encode_systematic,
    device_matrix,
    multiplicative_encode_matrix,
    systematic_parity_matrix,
)
from polardecoding_tpu_torch.ops.encode import (
    encode_info_mxu,
    info_sub_generator,
    polar_encode,
    scatter_info,
)
from polardecoding_tpu_torch.parallel.mesh import (
    DataMesh,
    data_mesh,
    one_rank,
    round_up_batch,
)
from polardecoding_tpu_torch.utils import trace
from polardecoding_tpu_torch.utils.pn import PN_PERIOD, pn_sequence

# wave steps run per counter read-back in run_point_waves, as the JAX
# package's scan chunk
SYNC_EVERY = 8
# frame indices end below 2^32: a frame's key folds in its index as one
# 32-bit word (ops/channel.fold_in, as jax.random.fold_in, which refuses a
# larger one), and so does the MC channel's counter (csrc/mc_channel.cu)
FRAME_LIMIT = 1 << 32


def _check_frames(end: int, what: str):
    """Raise before a frame index reaches FRAME_LIMIT: `end` bounds the
    global indices a step is about to use (exclusive)."""
    if end > FRAME_LIMIT:
        raise OverflowError(
            f"{what}: frame indices up to {end - 1} pass 2^32 - 1; a frame's "
            "key and the MC channel's counter hold its index in 32 bits, so "
            "frame 2^32 would repeat frame 0 (lower max_frames)")


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
    payload[b, i] = PN[(m_b + i) % 63], m_b = (frame_index * (K % 63)) % 63.

    m_b is computed in int64, as the C rule.  The JAX package computes it in
    int32, where the product wraps once frame_index * (K % 63) reaches 2^31:
    from frame 2^28 on at K=512 (K % 63 = 8), its offsets differ from these
    (frames 2^28 - 2 .. 2^28 + 1: here and in C 49, 57, 2, 10)."""
    m = (frame_index * (K % PN_PERIOD)) % PN_PERIOD
    idx = (m[:, None] + torch.arange(K, device=pn.device)[None, :]) % PN_PERIOD
    return pn[idx]


def _run_mesh(mesh: Optional[DataMesh], device) -> DataMesh:
    """A runner's mesh: the given one, else data_mesh() on device."""
    return data_mesh(device=device) if mesh is None else mesh


def _runner(preset: Preset, batch: Optional[int], device,
            mesh: Optional[DataMesh], log: Optional[Callable]) -> tuple:
    """A runner's mesh (_run_mesh), global batch (default: batch_per_device
    for each rank of the mesh) and log (rank 0's alone)."""
    mesh = _run_mesh(mesh, device)
    if batch is None:
        batch = round_up_batch(preset.sweep.batch_per_device * mesh.size, mesh)
    return mesh, batch, None if mesh.rank else log


def _point_setup(preset: Preset, snr_db: float, seed: Optional[int],
                 error_blocks: Optional[int], max_frames: Optional[int],
                 device, start: Optional[PointResult] = None) -> tuple:
    """One SNR point's (result so far, error-block target, frame cap, sigma,
    point key on `device`: the seed's key folded with round(100 snr_db));
    seed, target and cap default to the preset's sweep's."""
    sweep = preset.sweep
    seed = sweep.seed if seed is None else seed
    target = sweep.error_blocks if error_blocks is None else error_blocks
    cap = sweep.max_frames if max_frames is None else max_frames
    key = fold_in(prng_key(seed, device), int(round(snr_db * 100)))
    res = start or PointResult(preset.name, snr_db, 0, 0, 0, seed)
    return res, target, cap, float(sigma_from_ebn0_db(snr_db)), key


def _on_waves(preset: Preset) -> bool:
    """Whether run_point, given no frame step, takes the wave engine."""
    return preset.decoder.kind == "bp" and preset.decoder.bp_early_stop


def code_tables(code, device) -> CodeTables:
    """The code's tables from the port's own construction."""
    I = code_info_set(code)
    return code_tables_from_numpy(code_frozen_mask(code), I, pn_sequence(),
                                  info_sub_generator(I, code.N), device)


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
        crc_R = device_matrix(check_matrix(code.crc, code.num_info),
                              frozen.device)
        return lambda llr: cascl_decode(
            llr, frozen, tables.info_set, crc_R, list_size=dec.list_size,
            return_ties=True, engine=engine, **flavor)
    if dec.kind == "bpr":
        raise ValueError(f"{preset.name} is a BPr preset: its step also "
                         "returns the stage-error table, so it runs on "
                         "make_bpr_step and run_bpr_point (cli bpr)")
    raise ValueError(f"unknown decoder kind {dec.kind!r}")


def _crc_encoder(code, device) -> Callable:
    """Payload [B, K] -> [B, K'] on `device`: the code's CRC in its style,
    or the payload itself without one.  The matrix goes to the device here,
    once, and every call uses it as it is."""
    if code.crc is None:
        return lambda payload: payload
    if code.crc_style == "systematic":
        Gc = device_matrix(systematic_parity_matrix(code.crc, code.K), device)
        return lambda payload: crc_encode_systematic(payload, code.crc, Gc)
    E = device_matrix(multiplicative_encode_matrix(code.crc, code.K), device)
    return lambda payload: crc_encode_multiplicative(payload, code.crc, E)


def _mc_mode_tables(code, device):
    """(u_table, x_table) [128, N] float32 of the MC channel: row m is the
    full true u (payload and CRC bits at the info set) of PN offset m and
    row m of x_table its codeword; 63 rows, then zero rows."""
    N, K = code.N, code.K
    pn = pn_sequence()
    pays = np.stack([pn[(m + np.arange(K)) % PN_PERIOD] for m in range(PN_PERIOD)])
    w = _crc_encoder(code, "cpu")(torch.as_tensor(pays))
    u = scatter_info(w, torch.as_tensor(code_info_set(code), dtype=torch.int64), N)
    pad = torch.zeros((128 - PN_PERIOD, N), dtype=torch.float32)
    utab = torch.cat([u.to(torch.float32), pad])
    xtab = torch.cat([polar_encode(u).to(torch.float32), pad])
    return utab.to(device), xtab.to(device)


class _Frames:
    """A step builder's mesh (one process on `device` unless given), device,
    tables and encoders, and its rank's frames (global lanes first .. first
    + b - 1): their info words, codewords ("mxu", the GF(2) product, or
    "butterfly": the same ones), LLRs and info-bit errors.  A step's
    llr_dtype other than float32 raises before anything is built where the
    decode kernels (BP, SC, SCL, CA-SCL: float32 only) would take it.  It
    opens no spans: a step that records its stages passes trace.span as
    `span`."""

    def __init__(self, code, batch: int, device, mesh: Optional[DataMesh],
                 encoder: str, engine: str,
                 tables: Optional[CodeTables] = None, llr_dtype=None):
        self.mesh = one_rank(device) if mesh is None else mesh
        self.device = device = self.mesh.device
        if (llr_dtype not in (None, torch.float32)
                and use_kernel(device, engine, "llr_dtype")):
            raise ValueError(f"llr_dtype={llr_dtype}: the decode kernels are "
                             "float32-only; pass engine='plain' to decode in "
                             "another dtype")
        self.first, self.b = self.mesh.lanes(batch)
        self.tables = tables = (code_tables(code, device) if tables is None
                                else tables)
        if encoder == "mxu":
            self.encode = lambda w: encode_info_mxu(w, tables.g_rows)
        elif encoder == "butterfly":
            self.encode = lambda w: polar_encode(
                scatter_info(w, tables.info_set, code.N))
        else:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.crc = None if code.crc is None else _crc_encoder(code, device)
        self.K, self.engine = code.K, engine
        self.lanes = torch.arange(self.first, self.first + self.b,
                                  dtype=torch.int64, device=device)

    def info(self, fidx: torch.Tensor, span=contextlib.nullcontext):
        """Info words [b, K'] of frames fidx: PN payload, then the CRC."""
        with span("step.payload"):
            w = payload_from_index(fidx, self.tables.pn, self.K)
        if self.crc is None:
            return w
        with span("step.crc_encode"):
            return self.crc(w)

    def draw(self, key, fidx: torch.Tensor, sigma,
             span=contextlib.nullcontext) -> tuple:
        """(info words, channel LLRs [b, N]) of frames fidx; sigma as
        ops/channel.frame_llr's."""
        w = self.info(fidx, span)
        with span("step.encode"):
            x = self.encode(w)
        with span("step.channel"):
            return w, frame_llr(x, key, fidx, sigma, self.engine)

    def errors(self, u_hat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The info-bit error mask [b, K'] of u_hat against info words w."""
        return u_hat[:, self.tables.info_set] != w


def make_frame_step(preset: Preset, batch: int, device="cuda",
                    engine: str = "auto", encoder: str = "mxu",
                    channel: str = "threefry", noise: str = "kernel",
                    tables: Optional[CodeTables] = None,
                    llr_dtype: Optional[torch.dtype] = None,
                    mesh: Optional[DataMesh] = None) -> Callable:
    """Build the super-batch step: (key, frame_start, sigma) ->
    (errbit, errblock, pm_ties), 0-dim int64 tensors on `device` summed over
    the batch of frames frame_start .. frame_start + batch - 1.  With a mesh
    (on its device), `batch` is the global batch: this rank runs its slice
    and the counters are summed over the ranks.

    key: the point's key from ops/channel (int64 [2]); sigma: a float.
    engine: "auto" (the decoder's and the channel's CUDA kernels for a
    CUDA device, their plain versions on the CPU) or "plain".  encoder:
    "mxu" or "butterfly".  channel: "threefry" (per-frame keys, pure in
    (seed, frame index)) or "mc" (ops/channel_kernel.mc_channel: codeword
    table and counter noise, pure in (seed, frame_start, batch)), whose
    noise words are the TPU kernel's counter words (noise="kernel") or
    jax.random.bits under fold_in(key, frame_start) (noise="threefry", what
    the JAX package draws off the TPU); errors are counted over all N
    positions against the table's u (frozen positions agree).  tables: the
    code's tables (convert.code_tables_from_numpy), by default built from
    the preset.  llr_dtype: the decoder's message dtype (e.g.
    torch.bfloat16, the precision study's knob), the channel LLRs cast
    once before decode; None keeps float32.  The decode kernels are
    float32-only, so another dtype needs engine="plain" on the card
    (ValueError otherwise)."""
    code = preset.code
    if channel not in ("threefry", "mc"):
        raise ValueError(f"unknown channel {channel!r}")
    if noise not in ("kernel", "threefry"):
        raise ValueError(f"unknown noise {noise!r}")
    N, K = code.N, code.K
    frames = _Frames(code, batch, device, mesh, encoder, engine, tables,
                     llr_dtype)
    mesh, device, first, b = frames.mesh, frames.device, frames.first, frames.b
    decode = _make_decoder(preset, frames.tables, engine)
    no_ties = torch.zeros((), dtype=torch.int64, device=device)
    if channel == "mc":
        utab, xtab = _mc_mode_tables(code, device)

    def mc_llr(key, frame_start, fidx, sigma):
        # this rank's rows of the global batch's noise
        m = (fidx * (K % PN_PERIOD)) % PN_PERIOD
        k0, k1 = key.tolist()
        bits = None
        if noise == "threefry":
            bits = random_bits(fold_in(key.to(device), frame_start), b * N,
                               start=first * N).reshape(b, N)
        llr = mc_channel(m, xtab, sigma, (k0, k1, k0 ^ k1, frame_start), bits,
                         gen_bits=bits is None, engine=engine, row0=first)
        return llr, utab[m].to(torch.int8)

    def step(key, frame_start, sigma):
        _check_frames(frame_start + batch, f"{preset.name} frame step")
        fidx = frame_start + frames.lanes
        if channel == "mc":
            with trace.span("step.channel"):
                llr, u = mc_llr(key, frame_start, fidx, sigma)
        else:
            w, llr = frames.draw(key, fidx, sigma, trace.span)
        with trace.span("step.decode"):
            u_hat, ties = decode(llr if llr_dtype is None else llr.to(llr_dtype))
        with trace.span("step.count"):
            # the MC table's u is the whole frame's; w is the info bits
            bad = u_hat != u if channel == "mc" else frames.errors(u_hat, w)
            pm_ties = no_ties if ties is None else (ties > 0).sum()
            return mesh.sum(bad.sum(), bad.any(dim=-1).sum(), pm_ties)

    return step


def make_multisnr_step(preset: Preset, batch: int, num_snr: int,
                       device="cuda", llr_dtype: Optional[torch.dtype] = None,
                       engine: str = "auto", encoder: str = "mxu",
                       mesh: Optional[DataMesh] = None) -> Callable:
    """The SNR sweep folded into the batch: (key, frame_start, sigmas) ->
    (errbit, errblock, frames, pm_ties), each [num_snr] int64 on `device`,
    where frame i runs at sigmas[i % num_snr] (sigmas: float32 [num_snr]
    on `device`) and is counted under that SNR.  One frame-channel launch a
    step takes the sigma table (ops/channel.frame_llr); the decoder is
    make_frame_step's (early-stop BP presets decode with the latched early
    stop every 4 iterations, not the wave engine).  llr_dtype, engine,
    encoder and mesh as make_frame_step's."""
    frames = _Frames(preset.code, batch, device, mesh, encoder, engine,
                     llr_dtype=llr_dtype)
    mesh, device = frames.mesh, frames.device
    decode = _make_decoder(preset, frames.tables, engine)

    def per_snr(snr_idx, values):
        # index_add_, not bincount: bincount reads its input's maximum on
        # the host, a synchronisation every step on the card
        out = torch.zeros(num_snr, dtype=torch.int64, device=device)
        return out.index_add_(0, snr_idx, values.to(torch.int64))

    def step(key, frame_start, sigmas):
        if tuple(sigmas.shape) != (num_snr,):
            raise ValueError(f"sigmas must be [{num_snr}], got "
                             f"{tuple(sigmas.shape)}")
        _check_frames(frame_start + batch, f"{preset.name} multi-SNR step")
        fidx = frame_start + frames.lanes
        snr_idx = fidx % num_snr
        w, llr = frames.draw(key, fidx, sigmas)
        u_hat, ties = decode(llr if llr_dtype is None else llr.to(llr_dtype))
        bad = frames.errors(u_hat, w)
        tie_frames = (torch.zeros(num_snr, dtype=torch.int64, device=device)
                      if ties is None else per_snr(snr_idx, ties > 0))
        return mesh.sum(per_snr(snr_idx, bad.sum(dim=-1)),
                        per_snr(snr_idx, bad.any(dim=-1)),
                        per_snr(snr_idx, torch.ones_like(snr_idx)), tie_frames)

    return step


def run_fused_sweep(preset: Preset, snr_points, total_frames: int,
                    batch: int = 4096, device="cuda", seed: Optional[int] = None,
                    llr_dtype: Optional[torch.dtype] = None,
                    engine: str = "auto", encoder: str = "mxu",
                    mesh: Optional[DataMesh] = None) -> list[PointResult]:
    """Fixed-budget sweep with every SNR point fused into each batch
    (make_multisnr_step): frames 0 .. under the key prng_key(seed), in
    steps of `batch` (global, over the mesh's ranks) until total_frames are
    issued; one PointResult per SNR point, whose elapsed_s is its share of
    the wall time by frames.  The counters are summed on the device and
    read once."""
    seed = preset.sweep.seed if seed is None else seed
    snrs = list(snr_points)
    mesh = _run_mesh(mesh, device)
    device = mesh.device
    sigmas = torch.tensor([sigma_from_ebn0_db(s) for s in snrs],
                          dtype=torch.float32, device=device)
    step = make_multisnr_step(preset, batch, len(snrs), device,
                              llr_dtype=llr_dtype, engine=engine,
                              encoder=encoder, mesh=mesh)
    key = prng_key(seed, device)
    total = torch.zeros((4, len(snrs)), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    done = 0
    while done < total_frames:
        total += torch.stack(step(key, done, sigmas))
        done += batch
    eb, ebl, fr, ties = total.tolist()
    dt = time.perf_counter() - t0
    return [PointResult(preset.name, snrs[i], eb[i], ebl[i], fr[i], seed,
                        dt * fr[i] / max(done, 1), pm_ties=ties[i])
            for i in range(len(snrs))]


def make_bpr_step(preset: Preset, batch: int, device="cuda",
                  engine: str = "auto",
                  mesh: Optional[DataMesh] = None) -> Callable:
    """BPr instrumentation step (ref: BPr_128.c): (key, frame_start, sigma)
    -> (errbit, errblock, E), errbit and errblock 0-dim int64 and E the
    per-checkpoint stage-error table [num_checkpoints, n+1] int64 summed
    over the batch (models/bp.bpr_decode; the reference reports E / run,
    BPr_128.c:229-255).  Payload, butterfly encode and per-frame threefry
    channel as make_frame_step's (the frame channel's kernel on the card);
    no CRC.  engine: "auto" (the wave kernel for the iterations and the
    frame channel's kernel on a CUDA device) or "plain"; mesh as
    make_frame_step's."""
    code, dec = preset.code, preset.decoder
    frames = _Frames(code, batch, device, mesh, "butterfly", engine)
    mesh, tables = frames.mesh, frames.tables

    def step(key, frame_start, sigma):
        _check_frames(frame_start + batch, f"{preset.name} BPr step")
        fidx = frame_start + frames.lanes
        w = frames.info(fidx)
        # bpr_decode takes the scattered u, so the codeword is encoded here
        u = scatter_info(w, tables.info_set, code.N)
        llr = frame_llr(polar_encode(u), key, fidx, sigma, engine)
        u_hat, E = bpr_decode(llr, tables.frozen, u, tables.info_set,
                              iters=dec.bp_iters, flavor=dec.bp_flavor,
                              checkpoints=dec.bpr_checkpoints, engine=engine)
        bad = frames.errors(u_hat, w)
        return mesh.sum(bad.sum(), bad.any(dim=-1).sum(), E)

    return step


def run_bpr_point(preset: Preset, snr_db: float, batch: int = 256,
                  device="cuda", error_blocks: Optional[int] = None,
                  max_frames: Optional[int] = None, seed: Optional[int] = None,
                  engine: str = "auto", mesh: Optional[DataMesh] = None):
    """BPr at one SNR point -> (PointResult, E [checkpoints, n+1] int64
    numpy, summed over frames on the host; divide by frames for the
    reference's table).  Steps of the global `batch` until the error-block
    target or the frame cap, under run_point's point key (_point_setup)."""
    mesh = _run_mesh(mesh, device)
    step_fn = make_bpr_step(preset, batch, mesh.device, engine=engine,
                            mesh=mesh)
    res, target, cap, sigma, key = _point_setup(
        preset, snr_db, seed, error_blocks, max_frames, mesh.device)
    E = None
    t0 = time.perf_counter()
    while res.errblock < target and res.frames < cap:
        eb, ebl, se = step_fn(key, res.frames, sigma)
        res.errbit += int(eb)
        res.errblock += int(ebl)
        res.frames += batch
        se = se.cpu().numpy()
        E = se if E is None else E + se
    res.elapsed_s = time.perf_counter() - t0
    return res, E


def make_wave_step(preset: Preset, batch: int, wave_iters: int = 8,
                   device="cuda", fused: bool = True, encoder: str = "mxu",
                   check_every: int = 0, engine: str = "auto",
                   tables: Optional[CodeTables] = None,
                   mesh: Optional[DataMesh] = None) -> tuple:
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
    first passing check.  The fused drain gives the kernel a live mask, so
    the slots whose frames are already counted are held, not run: their
    state is left as it is.  engine: "auto" or "plain", as make_frame_step's.
    The carry's state is updated in place on the card: do not reuse a carry
    after stepping it.

    With a mesh, `batch` is the global batch and this rank holds the global
    slots first .. first + batch / W - 1; the counters are global.  A step's
    one all-gather of every rank's (errbit, errblock, frames) gives both the
    global counters and the retirements of the ranks before this one, which
    offset its refills: the refill order is the global slot order, as the
    JAX package's cumsum over the sharded batch.  The fused engine refills
    at the next step's head, so its carry also holds this rank's first
    refill index.  drain's `remaining` is global, so every rank leaves the
    drain loop at the same step."""
    code, dec = preset.code, preset.decoder
    if dec.kind != "bp":
        raise ValueError("wave stepping is a BP engine")
    if check_every and not fused:
        raise ValueError("check_every needs the fused wave kernel")
    N = code.N
    iter_max = dec.bp_iters
    frames = _Frames(code, batch, device, mesh, encoder, engine, tables)
    mesh, device, tables = frames.mesh, frames.device, frames.tables
    first, b = frames.first, frames.b
    wave = dict(iters=wave_iters, flavor=dec.bp_flavor, engine=engine)

    def retirees(u_hat, fidx, retire):
        # this rank's (errbit, errblock, frames) of the slots retire marks
        w = frames.info(fidx.clamp_min(0))
        bad = frames.errors(u_hat, w) & retire[:, None]
        return bad.sum(), bad.any(dim=-1).sum(), retire.sum()

    def count(u_hat, fidx, retire):
        """This rank's retirees' counters, exchanged -> (the global (errbit,
        errblock, frames), the retirees of the ranks before this one)."""
        out = retirees(u_hat, fidx, retire)
        if mesh.group is None:
            return out, 0
        every = mesh.gather(torch.stack(out))
        return tuple(every.sum(dim=0)), every[:mesh.rank, 2].sum()

    def refill(fidx, start, retire):
        # the retirees take start, start + 1, ... in slot order
        rank = torch.cumsum(retire.to(torch.int64), dim=0) - 1
        return torch.where(retire, start + rank, fidx)

    def drain_count(u_hat, fidx, done, iters_done):
        retire = (done | (iters_done >= iter_max)) & (fidx >= 0)
        out = retirees(u_hat, fidx, retire)
        fidx = torch.where(retire, -1, fidx)
        return fidx, mesh.sum(*out, (fidx >= 0).sum())

    zeros = torch.zeros(b, dtype=torch.int64, device=device)
    if fused:
        def init_fused(key, frame_start, sigma):
            # every slot retired: the first step's kernel merge fills it
            # with this rank's global lanes
            state = wave_init_state(torch.zeros((b, N), device=device),
                                    tables.frozen)
            return (state, zeros, zeros, zeros[0] + frame_start + batch,
                    torch.ones(b, dtype=torch.bool, device=device),
                    zeros[0] + frame_start + first)

        def step_fused(key, sigma, carry):
            state, fidx, iters_done, next_fidx, retire, start = carry
            fidx = refill(fidx, start, retire)
            iters_done = torch.where(retire, 0, iters_done)
            state, u_hat, done = bp_wave_fused(
                state, frames.draw(key, fidx, sigma)[1], retire,
                check_every=check_every, **wave)
            iters_done = iters_done + wave_iters
            retire = done | (iters_done >= iter_max)
            out, before = count(u_hat, fidx, retire)
            # the next head's refills start past the retirees of the ranks
            # before this one
            start = next_fidx + before
            return ((state, fidx, iters_done, next_fidx + out[2], retire,
                     start), out)

        def drain_fused(sigma, carry):
            # the pending retirees were counted by the last step: their
            # slots die instead of refilling.  The kernel holds the dead
            # slots (their done and u_hat 0), so a drain runs the live ones
            state, fidx, iters_done, next_fidx, retire, start = carry
            fidx = torch.where(retire, -1, fidx)
            no_retire = torch.zeros_like(retire)
            state, u_hat, done = bp_wave_fused(
                state, torch.zeros((b, N), device=device), no_retire,
                check_every=check_every, live=fidx >= 0, **wave)
            iters_done = iters_done + wave_iters
            fidx, out = drain_count(u_hat, fidx, done, iters_done)
            return (state, fidx, iters_done, next_fidx, no_retire, start), out

        return init_fused, step_fused, drain_fused

    def init(key, frame_start, sigma):
        fidx = frame_start + frames.lanes
        state = wave_init_state(frames.draw(key, fidx, sigma)[1],
                                tables.frozen)
        return state, fidx, zeros, zeros[0] + frame_start + batch

    def step(key, sigma, carry):
        state, fidx, iters_done, next_fidx = carry
        state = bp_wave(state, **wave)
        iters_done = iters_done + wave_iters
        u_hat, done = wave_decide(state, tables.frozen)
        retire = done | (iters_done >= iter_max)
        out, before = count(u_hat, fidx, retire)
        fidx = refill(fidx, next_fidx + before, retire)
        next_fidx = next_fidx + out[2]
        # R[0] is the same frozen row in every slot, so the merge is the
        # JAX package's where(retire, wave_init_state(llr), state)
        state = wave_merge(state, frames.draw(key, fidx, sigma)[1], retire)
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
                      engine: str = "auto",
                      mesh: Optional[DataMesh] = None) -> tuple:
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
    accepted and unused; engine: "auto" or "plain".  There is no mesh path,
    as in the JAX package: a mesh of more than one rank raises ValueError,
    one of one rank runs on its device."""
    code, dec = preset.code, preset.decoder
    if mesh is not None and mesh.size > 1:
        raise ValueError("the MC wave engine has no mesh path (as in the JAX "
                         "package): run it on one rank, or use the fused "
                         "engine")
    if dec.kind != "bp":
        raise ValueError("wave stepping is a BP engine")
    if noise not in ("kernel", "threefry"):
        raise ValueError(f"unknown noise {noise!r}")
    N, K = code.N, code.K
    if spares == 0:
        spares = max(2, wave_iters // 8)
    device = one_rank(device).device if mesh is None else mesh.device
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
        _check_frames(frame_start + 1, f"{preset.name} MC wave engine")
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


def _run_lagged(res: PointResult, target: int, cap: int, chunk: int,
                step: Callable, take: Callable, spans: tuple):
    """Chunks of `chunk` steps, step(i) each, until res reaches the target
    or the cap, yielding after each; a chunk's summed counters go to take
    one chunk later.  spans: the step span's name (anchored), the read's."""
    step_span, read_span = spans
    pending = None
    while res.errblock < target and res.frames < cap:
        total = 0
        for i in range(chunk):
            with trace.span(step_span, anchor=True):
                total = total + torch.stack(step(i))
        if pending is not None:
            with trace.span(read_span):
                counts = pending()
            take(counts)
        pending = _read_later(total)
        yield
    if pending is not None:
        with trace.span(read_span):
            counts = pending()
        take(counts)


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
    mesh: Optional[DataMesh] = None,
) -> PointResult:
    """Adaptive MC at one SNR point on the continuous-batching BP engine:
    engine="fused" (make_wave_step, with `fused` and `check_every`) or "mc"
    (make_wave_step_mc, with `noise`, `cadence` and `spares`; one rank
    only).

    The steps run in chunks of SYNC_EVERY; a chunk's summed counters are
    read while the next chunk runs, so the stop check lags one chunk (the
    frames run meanwhile are counted).  Then the frames in flight are
    drained, so that slow frames are not censored.  A point counts the same
    frames as the JAX package's run_point_waves.  `batch` is global
    (default batch_per_device per rank of the mesh); the counters every
    decision reads are global, so every rank stops and drains at the same
    step.

    While tracing is on (utils/trace) the call records, inside run_point's
    `point` span, `waves.build` around the stepper's build (counts `batch`
    and `wave_iters`), `waves.step` around each step's enqueue (opened with
    a clock anchor), `waves.read` around each wait for a chunk's counters
    and `waves.drain` around each drain and its counters' read."""
    mesh, batch, log = _runner(preset, batch, device, mesh, log)
    device = mesh.device
    with trace.span("waves.build", batch=batch, wave_iters=wave_iters):
        if engine == "mc":
            init, step, drain = make_wave_step_mc(
                preset, batch, wave_iters, device, noise=noise,
                cadence=cadence, spares=spares, mesh=mesh)
        elif engine == "fused":
            init, step, drain = make_wave_step(
                preset, batch, wave_iters, device, fused=fused,
                check_every=check_every, mesh=mesh)
        else:
            raise ValueError(f"unknown wave engine {engine!r}")
    res, target, cap, sigma, key = _point_setup(
        preset, snr_db, seed, error_blocks, max_frames, device, start_state)
    carry = init(key, res.frames, sigma)
    t0 = time.perf_counter()

    def take(counts):
        res.errbit += counts[0]
        res.errblock += counts[1]
        res.frames += counts[2]

    def one_step(_):
        nonlocal carry
        if engine == "fused":
            # the slots hold at most `batch` frames past those counted, and
            # the chunk run meanwhile and this one retire at most
            # 2 SYNC_EVERY batches more
            _check_frames(res.frames + batch * (2 * SYNC_EVERY + 1),
                          f"{preset.name} wave engine")
        carry, out = step(key, sigma, carry)
        return out

    for _ in _run_lagged(res, target, cap, SYNC_EVERY, one_step, take,
                         ("waves.step", "waves.read")):
        if log:
            # counted frames lag one chunk behind the steps run
            log(f"{preset.name} @ {snr_db:.2f} dB (waves): "
                f"counted={res.frames} errblock={res.errblock} "
                f"bler={res.bler:.3e}")
    remaining = batch
    while remaining > 0:
        with trace.span("waves.drain"):
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
    sync_every: int = 1,
    mesh: Optional[DataMesh] = None,
) -> PointResult:
    """Adaptive-length MC for one SNR point: run super-batches until the
    error-block target or the frame cap (ref stop rule, e.g. BP_128.c:168).

    sync_every: steps per counter read, with the JAX package's meaning.  At
    1 the counters are read after every step.  At k > 1 a chunk of k steps
    (frame starts issued, issued + batch, ...) is summed on the device and
    read one chunk behind (the copy overlaps the next chunk); each chunk
    counts batch * k frames, the last pending one included, so a point
    counts whole chunks past the stop.  The default stays 1 on every
    device: JAX's 8 pays for a TPU dispatch floor of about 24 ms a call,
    while a step here takes 10-19 ms of card time against 35-55 us of host
    time a call (PERF.md sections 5 and 6).

    BP early-stop presets run on the wave engine (run_point_waves, each
    frame retiring at its own convergence wave) unless a step_fn is
    given.  `batch` is global (default batch_per_device per rank of the
    mesh), a given step_fn must be built on the same mesh, and only rank 0
    logs.

    While tracing is on (utils/trace) the call records the span `point`,
    and in it `point.step` around each step's call (the host's enqueue) and
    `point.read` around each wait for counters."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    with trace.span("point"):
        if step_fn is None and _on_waves(preset):
            return run_point_waves(preset, snr_db, batch=batch, device=device,
                                   mesh=mesh, error_blocks=error_blocks,
                                   max_frames=max_frames, seed=seed,
                                   start_state=start_state, log=log)
        mesh, batch, log = _runner(preset, batch, device, mesh, log)
        device = mesh.device
        if step_fn is None:
            step_fn = make_frame_step(preset, batch, device, mesh=mesh)
        res, target, cap, sigma, key = _point_setup(
            preset, snr_db, seed, error_blocks, max_frames, device,
            start_state)
        t0 = time.perf_counter()

        def take(counts, frames):
            res.errbit += int(counts[0])
            res.errblock += int(counts[1])
            res.pm_ties += int(counts[2])
            res.frames += frames

        if sync_every == 1:
            while res.errblock < target and res.frames < cap:
                with trace.span("point.step", anchor=True):
                    out = step_fn(key, res.frames, sigma)
                with trace.span("point.read"):
                    counts = [int(c) for c in out[:3]]
                take(counts, batch)
                if log:
                    log(
                        f"{preset.name} @ {snr_db:.2f} dB: frames={res.frames} "
                        f"errblock={res.errblock} bler={res.bler:.3e}"
                    )
        else:
            issued = res.frames  # frames run (res.frames lags one chunk)
            for _ in _run_lagged(
                    res, target, cap, sync_every,
                    lambda i: step_fn(key, issued + i * batch, sigma),
                    lambda counts: take(counts, batch * sync_every),
                    ("point.step", "point.read")):
                issued += batch * sync_every
                if log:
                    log(f"{preset.name} @ {snr_db:.2f} dB: issued={issued} "
                        f"counted={res.frames} errblock={res.errblock} "
                        f"bler={res.bler:.3e}")
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
    mesh: Optional[DataMesh] = None,
) -> list[PointResult]:
    """Full SNR sweep with optional JSON checkpointing: each finished point
    is written, and a rerun resumes every point from its record (a
    checkpoint of either package).  Over a mesh every rank reads the
    checkpoint, rank 0 alone writes it and logs, and the ranks meet at a
    barrier after each write."""
    mesh, batch, log = _runner(preset, batch, device, mesh, log)
    # an early-stop BP preset takes run_point's wave-engine path
    step_fn = None if _on_waves(preset) else make_frame_step(
        preset, batch, mesh.device, mesh=mesh)
    points = preset.sweep.snr_points() if snr_points is None else list(snr_points)

    done: dict[float, PointResult] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            for rec in json.load(f):
                done[rec["snr_db"]] = point_result_from_json(rec)

    results = []
    for snr in points:
        res = run_point(
            preset, snr, batch=batch, mesh=mesh, step_fn=step_fn,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            start_state=done.get(snr), log=log,
        )
        results.append(res)
        if checkpoint_path:
            if mesh.rank == 0:
                with open(checkpoint_path, "w") as f:
                    json.dump(
                        [r.to_json(preset.code.num_info) for r in results], f,
                        indent=1)
            mesh.barrier()
        if log:
            log(
                f"DONE {preset.name} @ {snr:.2f} dB: BLER={res.bler:.4e} "
                f"({res.errblock}/{res.frames})"
            )
    return results


def run_multiseed(
    preset: Preset,
    seeds,
    snr_points=None,
    error_blocks: Optional[int] = None,
    max_frames: Optional[int] = None,
    batch: Optional[int] = None,
    device="cuda",
    log: Optional[Callable[[str], None]] = None,
    mesh: Optional[DataMesh] = None,
):
    """The reference's multi-seed replication: run_sweep once per seed.
    Returns (per_seed {seed: [PointResult]}, averaged [dict]), each averaged
    record pooling the error counts of every seed at one SNR point (the JAX
    package's run_multiseed)."""
    mesh = _run_mesh(mesh, device)
    per_seed = {}
    for seed in seeds:
        per_seed[seed] = run_sweep(
            preset, batch=batch, mesh=mesh, snr_points=snr_points,
            error_blocks=error_blocks, max_frames=max_frames, seed=seed,
            log=log,
        )
    averaged = []
    for i, snr in enumerate(r.snr_db for r in per_seed[seeds[0]]):
        frames = sum(per_seed[s][i].frames for s in seeds)
        errblock = sum(per_seed[s][i].errblock for s in seeds)
        errbit = sum(per_seed[s][i].errbit for s in seeds)
        averaged.append({
            "preset": preset.name,
            "snr_db": snr,
            "seeds": list(seeds),
            "frames": frames,
            "errblock": errblock,
            "bler": errblock / max(frames, 1),
            "ber": errbit / max(frames * preset.code.num_info, 1),
        })
    return per_seed, averaged
