"""The counters of one frame step, from the configuration and (seed, SNR,
first frame, batch) alone: frames f = frame_start .. frame_start + batch -
1 at SNR `snr_db` under the point key of `seed`.  errbit counts the info
bits (payload and CRC) decoded wrong, errblock the frames with any, and
pm_ties the frames in which the list decoder met an exact metric tie at
the survival threshold (0 for BP).  `dtype` is the decoder's message type:
float32 as configured, bfloat16 for the control."""
from __future__ import annotations

import torch

from portbench.reference import bp, channel, scl
from portbench.reference.code import Code


class Reference:
    """One configuration's reference pipeline on a device."""

    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.code = Code(config["code"], self.device)
        if config.get("step", {}).get("channel", "threefry") != "threefry":
            raise ValueError("the reference's channel is the frame step's "
                             "threefry channel")
        self.decoder = dict(config["decoder"])
        if self.decoder.get("early_stop"):
            raise ValueError("the step reference decodes fixed iterations; an "
                             "early-stop configuration names its own reference "
                             "(\"reference\": \"bp_es\")")
        if self.decoder.get("r1", 0):
            raise ValueError("the reference decodes exact SCL only (r1 = 0)")
        if self.decoder["kind"] == "bp" and self.decoder.get("flavor", "minsum_lut") != "minsum_lut":
            raise ValueError("the reference's BP check node is the table min-sum")
        if self.decoder["kind"] not in ("bp", "cascl", "scl"):
            raise ValueError(f"no reference decoder {self.decoder['kind']!r}")

    def inputs(self, seed: int, snr_db: float, frame_start: int, batch: int):
        """(w [B, K + r] int8 transmitted info bits, noise words [B, N],
        LLRs [B, N] float32) of one step's frames."""
        c = self.code
        fidx = frame_start + torch.arange(batch, dtype=torch.int64, device=self.device)
        w = c.codeword_bits(c.payload(fidx))
        x = c.encode(w)
        words = channel.noise_words(channel.point_key(seed, snr_db, self.device),
                                    fidx, c.N)
        return w, words, channel.llr_from_words(x, words, channel.sigma_of(snr_db))

    def decode(self, llr: torch.Tensor, chk_fn=None):
        """(u_hat [B, N] int8, ties [B] int32 or None) of LLRs in their dtype."""
        d, c = self.decoder, self.code
        if d["kind"] == "bp":
            kw = {} if chk_fn is None else {"chk_fn": chk_fn}
            return bp.bp_decode(llr, c.frozen, int(d["iters"]), **kw), None
        u_all, PM, ties = scl.scl_decode(llr, c.frozen, int(d["list_size"]))
        rem = c.rem if d["kind"] == "cascl" else None
        return scl.cascl_select(u_all, PM, c.info, rem), ties

    @torch.no_grad()
    def counters(self, seed: int, snr_db: float, frame_start: int, batch: int,
                 dtype=torch.float32):
        """(errbit, errblock, pm_ties) of one step, its batch decoded at once."""
        w, _, llr = self.inputs(seed, snr_db, frame_start, batch)
        u_hat, ties = self.decode(llr.to(dtype))
        bad = u_hat[:, self.code.info] != w
        return (int(bad.sum()), int(bad.any(dim=-1).sum()),
                0 if ties is None else int((ties > 0).sum()))
