"""SCL with the bounded-fork rate-1 rule: the reference of a configuration
whose decoder has r1 > 0 (SCL_1024_L8_FASTR1), in plain PyTorch, batched
over frames with the list as a tensor axis, in any float dtype.

The rule is the rate-1 node of fast-SSC list decoding (S. A. Hashemi, C.
Condo and W. J. Gross, "Fast and Flexible Successive-Cancellation List
Decoders for Polar Codes", IEEE Trans. Signal Process. 65(21), 2017): an
all-information block is decided at once, and a path forks only on the
block's least reliable positions, at most min(L - 1, w) of them.

The code tree's nodes are taken as `decompose` takes them: a block of
width w = 2^s at leaf `off` is, in this order, R0 (every leaf frozen), REP
(every leaf but the last frozen), R1 (no leaf frozen, w >= max(r1, 2)),
LOOP (w <= wloop) or a branch of its two halves.  R0, REP and LOOP nodes
decode exactly as bit-by-bit SCL does (reference/scl.py), so every bit
outside an R1 node is decoded as exact SCL decodes it: the table-corrected
PHI, the stable 2L -> L selection, the tie counter.  An R1 node of stage s
takes each path's stage-s LLRs alpha, from the same f and g operations in
the same order as exact SCL, and

  1. decides beta = (alpha < 0);
  2. takes t = min(L - 1, w) fork rounds on the successive minima of
     |alpha| of the path it descends from, the first position on equal
     magnitudes (a stable sort of |alpha|);
  3. round k puts every path's two candidates, PM (keep) and PM +
     |alpha_e| (flip its k-th position e), through exact SCL's stable 2L ->
     L selection, with its tie counter;
  4. flips the chosen positions of beta, writes u = beta F (the transform
     is its own inverse) and continues the partial sums from the block.

The answer is the least-PM path, the first on equal metrics
(scl.cascl_select without a CRC).

Where this departs from the paper: the paper's list decoder charges the
hard metric |alpha| at every bit, here only an R1 node does, and every
other bit pays the C program's table-corrected PHI (SCL_1024.c:481-502);
the paper leaves the order of equally reliable positions and of equal
candidates open, here both are fixed as above.  Where it departs from
exact SCL: an R1 node forks t times instead of w times, its kept bits pay
nothing (exact SCL adds delta(|l|) at every leaf) and its flips pay
|alpha| at the node's input, not PHI at the leaves.

It models SCL alone; exact SCL (r1 = 0) is the step reference's
(reference/step.py), which refuses r1 > 0."""
from __future__ import annotations

import torch

from portbench.reference import scl, step
from portbench.reference.chk import chk, phi_both
from portbench.reference.code import Code, polar_encode

BIG = scl.BIG


def decompose(frozen, r1: int, wloop: int) -> list:
    """[(kind, stage, leaf offset)] of the leaves of the code tree of the
    mask `frozen` (N bools, N a power of two), in leaf order."""
    out = []

    def walk(s: int, off: int):
        w = 1 << s
        blk = frozen[off:off + w]
        if all(blk):
            out.append(("r0", s, off))
        elif w >= 2 and all(blk[:-1]) and not blk[-1]:
            out.append(("rep", s, off))
        elif r1 and w >= max(r1, 2) and not any(blk):
            out.append(("r1", s, off))
        elif w <= wloop:
            out.append(("loop", s, off))
        else:
            walk(s - 1, off)
            walk(s - 1, off + w // 2)

    walk(len(frozen).bit_length() - 1, 0)
    return out


def r1_stages(frozen, r1: int, wloop: int) -> list:
    """Per leaf: the stage of the R1 node that starts there, else 0."""
    stages = [0] * len(frozen)
    for kind, s, off in decompose([bool(b) for b in frozen], r1, wloop):
        if kind == "r1":
            stages[off] = s
    return stages


def _llr_phase(llr_c, bits_c, ch, t: int, n: int, stop: int):
    """The g node at stage t (none at t = n), then the f nodes at stages
    t - 1 .. stop: the input of a node of stage `stop` starting here."""
    if t < n:
        src = scl._src(llr_c, ch, t, n)
        w = 1 << t
        lo, hi = scl._slot(t)
        sgn = (1 - 2 * bits_c[..., lo:hi]).to(src.dtype)
        llr_c[..., lo:hi] = src[..., w:] + sgn * src[..., :w]
    for i in range(t - 1, stop - 1, -1):
        src = scl._src(llr_c, ch, i, n)
        w = 1 << i
        lo, hi = scl._slot(i)
        llr_c[..., lo:hi] = chk(src[..., :w], src[..., w:])


def _sum_phase(bits_c, x, s: int, t1: int, n: int):
    """The partial sums after a decided block x [..., 2^s] (a bit at s = 0)
    combined up through stage t1, then kept as stage t1's pending half."""
    v = x
    for i in range(s, t1):
        lo, hi = scl._slot(i)
        v = torch.cat([bits_c[..., lo:hi] ^ v, v], dim=-1)
    if t1 < n:
        lo, hi = scl._slot(t1)
        bits_c[..., lo:hi] = v


def _select(PM, pen0, pen1, L: int):
    """Exact SCL's selection of the L least of the 2L candidates [PM +
    pen0, PM + pen1], stable: (PM, parent [B, L], bit [B, L] int8, tie [B]
    int32, 1 where the L-th and (L+1)-th candidates are equal below BIG /
    2)."""
    vals, idx = torch.sort(torch.cat([PM + pen0, PM + pen1], dim=-1),
                           dim=-1, stable=True)
    tie = (vals[:, L - 1] == vals[:, L]) & (vals[:, L] < BIG / 2)
    idx = idx[:, :L]
    return vals[:, :L], idx % L, (idx >= L).to(torch.int8), tie.to(torch.int32)


def r1_node(alpha, PM):
    """One R1 node: alpha [B, L, w] the node's LLRs per path, PM [B, L].
    Returns (x [B, L, w] int8 the decided block, PM, ties [B] int32, the
    path before the node that each path descends from [B, L])."""
    B, L, w = alpha.shape
    t = min(L - 1, w)
    beta = (alpha < 0).to(torch.int8)
    ties = torch.zeros((B,), dtype=torch.int32, device=alpha.device)
    origin = torch.arange(L, device=alpha.device).expand(B, L)
    if t == 0:
        return beta, PM, ties, origin
    mags, where = torch.sort(alpha.abs(), dim=-1, stable=True)
    mags, where = mags[..., :t], where[..., :t]
    flips = torch.zeros((B, L, t), dtype=torch.int8, device=alpha.device)
    for k in range(t):
        cost = torch.take_along_dim(mags[..., k], origin, dim=1)
        PM, parent, bit, tie = _select(PM, 0.0, cost, L)
        ties = ties + tie
        origin = torch.take_along_dim(origin, parent, dim=1)
        flips = torch.take_along_dim(flips, parent[..., None], dim=1)
        flips[..., k] = bit
    x = torch.take_along_dim(beta, origin[..., None], dim=1)
    pos = torch.take_along_dim(where, origin[..., None], dim=1)
    return x.scatter(-1, pos, x.gather(-1, pos) ^ flips), PM, ties, origin


def scl_r1_decode(llr: torch.Tensor, frozen: torch.Tensor, L: int, r1: int,
                  wloop: int):
    """(u_all [B, L, N] int8, PM [B, L], ties [B] int32) of the LLRs [B, N]
    in their dtype: exact SCL but on the R1 nodes of decompose(frozen, r1,
    wloop)."""
    B, N = llr.shape
    n = N.bit_length() - 1
    dt, dev = llr.dtype, llr.device
    llr_c = torch.zeros((B, L, N - 1), dtype=dt, device=dev)
    bits_c = torch.zeros((B, L, N - 1), dtype=torch.int8, device=dev)
    u_all = torch.zeros((B, L, N), dtype=torch.int8, device=dev)
    PM = torch.full((B, L), BIG, dtype=dt, device=dev)
    PM[:, 0] = 0.0
    ties = torch.zeros((B,), dtype=torch.int32, device=dev)
    ch = llr[:, None, :].expand(B, L, N)
    zero = torch.zeros((B, L, 1), dtype=torch.int8, device=dev)
    fz = frozen.tolist()
    stages = r1_stages(fz, r1, wloop)
    j = 0
    while j < N:
        s = stages[j]
        _llr_phase(llr_c, bits_c, ch, scl._ntz(j | N), n, s)
        if s:
            alpha = ch if s == n else llr_c[..., slice(*scl._slot(s))]
            x, PM, node_ties, parent = r1_node(alpha, PM)
            ties = ties + node_ties
            width = 1 << s
        else:
            pen0, pen1 = phi_both(llr_c[..., 0])
            if fz[j]:
                PM, x, parent = PM + pen0, zero, None
            else:
                PM, parent, bit, tie = _select(PM, pen0, pen1, L)
                ties = ties + tie
                x = bit[..., None]
            width = 1
        if parent is not None:
            llr_c = torch.take_along_dim(llr_c, parent[..., None], dim=1)
            bits_c = torch.take_along_dim(bits_c, parent[..., None], dim=1)
            u_all = torch.take_along_dim(u_all, parent[..., None], dim=1)
        u_all[:, :, j:j + width] = polar_encode(x)
        j += width
        _sum_phase(bits_c, x, s, min(scl._ntz(j), n), n)
    return u_all, PM, ties


class Reference(step.Reference):
    """The configuration's reference on a device: its frames, inputs and
    counters are the step reference's, its decoder the rate-1 flavor."""

    def __init__(self, config: dict, device):
        # the step reference's set-up refuses r1 > 0, so this one is its own
        d = dict(config["decoder"])
        if config.get("step", {}).get("channel", "threefry") != "threefry":
            raise ValueError("the reference's channel is the frame step's "
                             "threefry channel")
        if d.get("early_stop"):
            raise ValueError("the rate-1 reference decodes SCL, not early-stop BP")
        if d["kind"] != "scl":
            raise ValueError(f"the rate-1 reference decodes SCL, not {d['kind']!r}")
        if not int(d.get("r1", 0)) > 0:
            raise ValueError("r1 = 0 is exact SCL, which the step reference judges")
        self.config = config
        self.device = torch.device(device)
        self.code = Code(config["code"], self.device)
        self.decoder = d
        self.L, self.r1 = int(d["list_size"]), int(d["r1"])
        self.wloop = int(d.get("wloop", 2))

    def decode(self, llr: torch.Tensor):
        """(u_hat [B, N] int8, ties [B] int32) of LLRs in their dtype."""
        u_all, PM, ties = scl_r1_decode(llr, self.code.frozen, self.L, self.r1,
                                        self.wloop)
        return scl.cascl_select(u_all, PM, self.code.info, None), ties
