"""Flooding BP with G-matrix early stopping, as the wave engine decides a
frame (BP_1024.c's BP, reference/bp.py's message update, with the G-matrix
criterion of Yuan & Parhi, IEEE Trans. Signal Processing 62(24), 2014).

A frame runs in waves of `wave_iters` iterations.  After each wave its
hard decision u_hat = [L[0] + R[0] < 0] on the info bits is re-encoded and
checked, x(u_hat) == [L[n] + R[n] < 0] at all N positions; the frame
retires at its first passing wave, or at the end of the first wave that
brings its iterations to `iters` or more (104 at 100 and 8), with that
wave's u_hat.  So a frame's retirement and decision are a pure function of
(seed, SNR, frame index, wave_iters), whatever shares its batch: every
operation is elementwise in the frame.

`Reference.frames` gives each frame's outcome up to a horizon, the
iterations the wave engine says it ran, which is what the wave check
compares (portbench/wave_check.py); `counters` has the interface of
reference.step.Reference, each frame decoded to its retirement.  Any float
dtype, which the control uses (bfloat16)."""
from __future__ import annotations

import torch

from portbench.reference import bp, channel
from portbench.reference.code import Code, polar_encode


class Reference:
    """One early-stop BP configuration's reference on a device."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.code = Code(config["code"], self.device)
        step = config.get("step", {})
        if step.get("channel", "threefry") != "threefry":
            raise ValueError("the reference's channel is the threefry channel")
        self.decoder = dict(config["decoder"])
        if self.decoder["kind"] != "bp" or not self.decoder.get("early_stop"):
            raise ValueError("the bp_es reference decodes early-stop BP "
                             "(decoder.kind bp, decoder.early_stop true)")
        if self.decoder.get("flavor", "minsum_lut") != "minsum_lut":
            raise ValueError("the reference's BP check node is the table min-sum")
        if self.code.crc:
            raise ValueError("the wave engine counts the payload bits: no CRC")
        # the wave length the configuration states: run_point's wave path
        # runs run_point_waves' default, 8
        self.wave_iters = int(self.decoder["wave_iters"])
        self.iters = int(self.decoder["iters"])

    def inputs_of(self, seed: int, snr_db: float, fidx: torch.Tensor):
        """(w [B, K] int8 payloads, noise words [B, N], LLRs [B, N] float32)
        of the frames fidx [B] (int64 on the reference's device)."""
        c = self.code
        w = c.codeword_bits(c.payload(fidx))
        words = channel.noise_words(channel.point_key(seed, snr_db, self.device),
                                    fidx, c.N)
        return w, words, channel.llr_from_words(c.encode(w), words,
                                                channel.sigma_of(snr_db))

    def inputs(self, seed: int, snr_db: float, frame_start: int, batch: int):
        fidx = frame_start + torch.arange(batch, dtype=torch.int64, device=self.device)
        return self.inputs_of(seed, snr_db, fidx)

    def waves(self, llr: torch.Tensor, horizon=None, chk_fn=None) -> tuple:
        """(at [B] int64, u_hat [B, N] int8) of LLRs [B, N] in their dtype:
        the iterations after which each frame retired, 0 where it had not
        by its horizon [B] (default: none), and the decision it retired
        with, else its decision at the horizon.  A frame leaves the batch
        when it retires or reaches its horizon."""
        B, N = llr.shape
        n = N.bit_length() - 1
        frozen = self.code.frozen
        kw = {} if chk_fn is None else {"chk_fn": chk_fn}
        if horizon is None:
            horizon = torch.full((B,), self.iters, dtype=torch.int64, device=llr.device)
        at = torch.zeros(B, dtype=torch.int64, device=llr.device)
        u = torch.zeros((B, N), dtype=torch.int8, device=llr.device)
        rows = torch.arange(B, device=llr.device)
        Ls, Rs = bp.messages(llr, frozen)
        ran = 0
        while rows.numel():
            bp.iterate(Ls, Rs, self.wave_iters, **kw)
            ran += self.wave_iters
            u_hat = bp.decision(Ls, Rs, frozen)
            post = (Ls[n] + Rs[n] < 0).to(torch.int8)
            retire = (polar_encode(u_hat) == post).all(dim=-1) | (ran >= self.iters)
            end = retire | (horizon[rows] <= ran)
            at[rows[retire]] = ran
            u[rows[end]] = u_hat[end]
            keep = ~end
            rows = rows[keep]
            Ls = [x[keep] for x in Ls]
            Rs = [x[keep] for x in Rs]
        return at, u

    def decode(self, llr: torch.Tensor, chk_fn=None):
        """(u_hat [B, N] int8, None): each frame's decision at retirement."""
        return self.waves(llr, chk_fn=chk_fn)[1], None

    @torch.no_grad()
    def frames(self, seed: int, snr_db: float, fidx: torch.Tensor,
               horizon: torch.Tensor, dtype=torch.float32) -> tuple:
        """(at, errbit, errblock), each [B] int64, of the frames fidx [B] run
        alone up to horizon [B] iterations: `at` as waves() gives it, the
        counters those of the decision waves() gives."""
        w, _, llr = self.inputs_of(seed, snr_db, fidx.to(self.device))
        at, u_hat = self.waves(llr.to(dtype), horizon.to(self.device))
        bad = u_hat[:, self.code.info] != w
        return at, bad.sum(dim=-1), bad.any(dim=-1).to(torch.int64)

    @torch.no_grad()
    def counters(self, seed: int, snr_db: float, frame_start: int, batch: int,
                 dtype=torch.float32):
        """(errbit, errblock, 0) of frames frame_start .. + batch - 1, each
        decoded to its retirement."""
        fidx = frame_start + torch.arange(batch, dtype=torch.int64, device=self.device)
        horizon = torch.full((batch,), self.iters, dtype=torch.int64, device=self.device)
        _, eb, ebl = self.frames(seed, snr_db, fidx, horizon, dtype)
        return int(eb.sum()), int(ebl.sum()), 0
