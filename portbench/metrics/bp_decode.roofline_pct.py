"""bp_decode.roofline_pct: the BP decode kernel's share of its roofline on
the first COUNTED_STEPS traced steps: the least time that their decodes
need at the H100's peaks (bp_work), over the device time of the kernels
named bp_decode_kernel in those steps.

The work is the flooding BP of the reference over the step's own LLRs
(worked out again by the reference): every CHK the sweep needs, and of
those the ones whose table difference is +0 on these inputs, which need
fewer operations (counted_chks)."""
from portbench.peaks import least_seconds

KERNEL = "bp_decode_kernel"
COUNTED_STEPS = 2
# a table-corrected min-sum CHK (reference/chk.chk): a+b, a-b, two abs, two
# 3-level select trees, the table difference, the sign (two compares, an
# equality, a select), |a|, |b|, min, the product, the final add
CHK_OPS = 27
# one whose table difference is +0: the sign, |a|, |b|, min and product
# (8), ||a| - |b|| and its compare with the last threshold (3), the add (1)
CHK_ZERO_OPS = 12


def counted_chks(reference, llr):
    """{"chks", "zero"}: the CHKs a fixed-iteration decode of llr needs,
    every call but the L sweep's CHK(R[n-1], L[n]) at stage n-1, which
    repeats the R sweep's on the same operands; and of those, the ones
    whose table difference is +0 (reference/chk.table_zero)."""
    from portbench.reference.chk import chk, table_zero

    counts = {"chks": 0, "zero": 0}
    zero, last = [], [0]

    def counted(a, b):
        if a.shape[-2] == 1:  # stage n-1: R: (ru, ld+rd), (ru, lu); L: ..
            last[0] += 1
            if last[0] % 4 == 0:
                return chk(a, b)
        z = table_zero(a, b)
        counts["chks"] += z.numel()
        zero.append(z.sum())
        return chk(a, b)

    reference.decode(llr, chk_fn=counted)
    counts["zero"] = int(sum(zero)) if zero else 0
    return counts


def bp_sweep_ops(chks):
    """The sweep's operations: each CHK with the add beside it."""
    return ((chks["chks"] - chks["zero"]) * CHK_OPS + chks["zero"] * CHK_ZERO_OPS
            + chks["chks"])


def bp_work(B, N, chks):
    """(bytes, operations) of one fixed-iteration BP decode of B frames:
    LLRs and frozen row in, decisions out; the sweep's operations."""
    return B * N * 4 + N * 4 + B * N, bp_sweep_ops(chks)


def read(ctx):
    per = ctx.launches_per_step(KERNEL)
    if per is None:
        return None
    least = busy = 0.0
    steps = ctx.traced_steps()[:COUNTED_STEPS]
    for (plan, rec), launches in zip(steps, per):
        _, _, llr = ctx.reference.inputs(plan.seed, plan.snr_db, rec.frame_start,
                                         plan.batch)
        chks = counted_chks(ctx.reference, llr)
        least += least_seconds(*bp_work(plan.batch, ctx.reference.code.N, chks))
        busy += sum(b - a for _, a, b in launches) / 1e6
    pct = 100.0 * least / busy
    ctx.note(f"bp_decode.roofline_pct {pct} over {len(steps)} steps: least "
             f"{least} s, kernel {busy} s, {ctx.card['name']} at "
             f"{ctx.card['power_limit']}")
    return pct
