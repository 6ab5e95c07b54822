"""Monte-Carlo simulation harness: batched frame pipeline + adaptive-stop sweep
(torch port of polardecoding_tpu.parallel.harness, BP frame step).

  reference (per frame, serial)            here (per super-batch, on the card)
  ---------------------------------        -------------------------------------
  payload from PN window                   PN gather, frame-index arithmetic
  encode x = u . Fn  (O(N^2) stdin matrix) GF(2) product or butterfly encode
  normal() noise loop                      counter-based per-frame keys
  decode                                   batched BP (CUDA kernel on the card)
  count info-bit errors                    vectorized compare + reduce
  stop when errBlock >= target             host-side stop on the counters

Payloads and noise are pure functions of (seed, frame index), with the JAX
package's generator (ops/channel.py), so a frame here is the same frame as
there and results are independent of batch size.  Error counts follow the
reference: block error = any mismatch over the info set; BLER =
errBlock / run.

Out of this slice (each raises NotImplementedError): decoder kinds other than
"bp" (ROADMAP A5, A6), channel="mc" (ROADMAP B5), and early-stop BP presets in
run_point/run_sweep, which the JAX package runs on its wave engine
(ROADMAP A7).  There is no multi-device path yet (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

from polardecoding_tpu_torch.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu_torch.configs import Preset
from polardecoding_tpu_torch.convert import (
    CodeTables,
    code_tables_from_numpy,
    point_result_from_json,
)
from polardecoding_tpu_torch.models.bp import bp_decode_auto
from polardecoding_tpu_torch.ops.channel import awgn_llr, fold_in, frame_keys, prng_key
from polardecoding_tpu_torch.ops.crc import crc_encode_multiplicative, crc_encode_systematic
from polardecoding_tpu_torch.ops.encode import (
    encode_info_mxu,
    info_sub_generator,
    polar_encode,
    scatter_info,
)
from polardecoding_tpu_torch.utils.pn import PN_PERIOD, pn_sequence


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


def make_frame_step(preset: Preset, batch: int, device="cuda",
                    bp_engine: str = "auto", encoder: str = "mxu",
                    channel: str = "threefry",
                    tables: Optional[CodeTables] = None) -> Callable:
    """Build the super-batch step: (key, frame_start, sigma) ->
    (errbit, errblock, pm_ties), 0-dim int64 tensors on `device` summed over
    the batch of frames frame_start .. frame_start + batch - 1.

    key: the point's key from ops/channel (int64 [2]); sigma: a float.
    bp_engine: "auto" (the CUDA kernel for a CUDA device, the plain version
    on the CPU) or "plain".  encoder: "mxu" or "butterfly".  tables: the
    code's tables (convert.code_tables_from_numpy), by default built from the
    preset."""
    code, dec = preset.code, preset.decoder
    if dec.kind != "bp":
        raise NotImplementedError(
            f"decoder kind {dec.kind!r} is not ported yet: the SC/SCL/CA-SCL "
            "frame steps are ROADMAP A5-A6")
    if channel == "mc":
        raise NotImplementedError(
            "channel='mc' needs mc_channel_pallas ported (ROADMAP B5)")
    if channel != "threefry":
        raise ValueError(f"unknown channel {channel!r}")
    N, K = code.N, code.K
    device = torch.device(device)
    if tables is None:
        tables = code_tables(code, device)
    encode = _make_encoder(encoder, tables, N)
    early_stop_every = 4 if dec.bp_early_stop else 0
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    no_ties = torch.zeros((), dtype=torch.int64, device=device)

    def step(key, frame_start, sigma):
        fidx = frame_start + lanes
        payload = payload_from_index(fidx, tables.pn, K)
        if code.crc is None:
            w = payload
        elif code.crc_style == "systematic":
            w = crc_encode_systematic(payload, code.crc)
        else:
            w = crc_encode_multiplicative(payload, code.crc)
        llr = awgn_llr(encode(w), frame_keys(key.to(device), fidx), sigma)
        u_hat = bp_decode_auto(llr, tables.frozen, iters=dec.bp_iters,
                               flavor=dec.bp_flavor,
                               early_stop_every=early_stop_every,
                               engine=bp_engine)
        bad = u_hat[:, tables.info_set] != w
        return bad.sum(), bad.any(dim=-1).sum(), no_ties

    return step


def _check_frame_step_path(preset: Preset):
    if preset.decoder.kind == "bp" and preset.decoder.bp_early_stop:
        raise NotImplementedError(
            f"{preset.name}: early-stop BP presets run on the continuous-"
            "batching wave engine (run_point_waves), ROADMAP A7; pass an "
            "explicit step_fn from make_frame_step for the per-check early "
            "stop")


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
    of the JAX package's run_point with sync_every=1."""
    if step_fn is None:
        _check_frame_step_path(preset)
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
    _check_frame_step_path(preset)
    if batch is None:
        batch = preset.sweep.batch_per_device
    step_fn = make_frame_step(preset, batch, device)
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
