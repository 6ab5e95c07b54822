"""scl_decode.roofline_pct: the SCL list-decode kernel's share of its
roofline in the traced points: the least time that exact SCL decoding of
each traced step's batch needs at the H100's peaks (scl_work), summed, over
the device time of the kernels named scl_decode_kernel in those steps.

The work is counted from the algorithm (the reference's bit-by-bit
schedule on the configuration's frozen set), not from the kernel: a kernel
that skips work reads above what it did."""
from portbench.peaks import least_seconds

KERNEL = "scl_decode_kernel"
# a table-corrected min-sum CHK: a+b, a-b, two abs, two 3-level select
# trees (3 compares, 3 selects each), the table difference, the sign (two
# compares, an equality, a select), |a|, |b|, min, the product, the add
CHK_OPS = 27
# PHI: |l| and its 3-level table tree, shared; per penalty a compare, a
# select, the add to the table value and the add to the path metric
PHI_BASE_OPS = 7
PHI_PEN_OPS = 4


def scl_work(B, N, L, frozen):
    """(bytes, operations) of exact SCL on B frames: LLRs and mask in,
    u_all, PM and ties out.  Per path and bit j, with t = ntz(j) (n at j =
    0) and t1 = ntz(j + 1): the g node at stage t (a product and an add an
    element), a CHK an f-node element below it, PHI (one penalty at a
    frozen bit, both at an info bit) and the 2^t1 - 1 partial-sum xors; per
    info bit, the L smallest of 2L candidates in a stable order, about
    2L log2(2L) compares."""
    n = N.bit_length() - 1
    per_path = select = 0
    for j in range(N):
        t = n if j == 0 else (j & -j).bit_length() - 1
        t1 = min(((j + 1) & -(j + 1)).bit_length() - 1, n)
        if t < n:
            per_path += 2 * (1 << t)
        per_path += ((1 << t) - 1) * CHK_OPS
        if t1 < n:
            per_path += (1 << t1) - 1
        per_path += PHI_BASE_OPS + PHI_PEN_OPS * (1 if frozen[j] else 2)
        if not frozen[j]:
            select += 2 * L * ((2 * L).bit_length() - 1)
    nbytes = B * N * 4 + N + B * L * N + B * L * 4 + B * 4
    return nbytes, B * (L * per_path + select)


def read(ctx):
    per = ctx.launches_per_step(KERNEL)
    if per is None:
        return None
    code = ctx.reference.code
    frozen = code.frozen.tolist()
    L = int(ctx.config["decoder"]["list_size"])
    least = sum(least_seconds(*scl_work(plan.batch, code.N, L, frozen))
                for plan, _ in ctx.traced_steps())
    busy = sum(b - a for launches in per for _, a, b in launches) / 1e6
    pct = 100.0 * least / busy
    ctx.note(f"scl_decode.roofline_pct {pct} over {len(per)} steps: least "
             f"{least} s, kernel {busy} s, {ctx.card['name']} at "
             f"{ctx.card['power_limit']}")
    return pct
