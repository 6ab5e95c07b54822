"""scl_decode_r1.roofline_pct: the rate-1 flavor of the SCL list-decode
kernel's share of its roofline in the traced points: the least time that
the flavor's work on each traced step's batch needs at the H100's peaks
(scl_work with the configuration's r1 and wloop), summed, over the device
time of the flavor's launches in those steps, scl_decode_kernel<true, ..>
(the exact mode's scl_decode_kernel<false, ..> is not counted).

The work is counted from the algorithm on the benchmark's own
decomposition of the configuration's frozen set (reference/scl_r1.py), not
from the kernel: the forks that the flavor skips are not credited to it,
and a kernel that skips more work reads above what it did."""
from portbench.peaks import least_seconds
from portbench.reference.scl_r1 import r1_stages

KERNEL = "scl_decode_kernel<true"
# as scl_decode.roofline_pct counts them: a table-corrected min-sum CHK;
# PHI's shared |l| and table tree, and per penalty a compare, a select and
# two adds
CHK_OPS = 27
PHI_BASE_OPS = 7
PHI_PEN_OPS = 4


def scl_work(B, N, L, frozen, r1=0, wloop=2):
    """(bytes, operations) of SCL with the rate-1 flavor on B frames: LLRs
    and mask in, u_all, PM and ties out.  Per path and bit j outside an R1
    node, with t = ntz(j) (n at j = 0) and t1 = ntz(j + 1): the g node at
    stage t (a product and an add an element), a CHK an f-node element
    below it, PHI (one penalty at a frozen bit, both at an info bit) and
    the 2^t1 - 1 partial-sum xors; per info bit the L smallest of 2L
    candidates in a stable order, about 2L log2(2L) compares.  An R1 node
    of stage s (width w) starting at leaf j instead takes, per path, the f
    nodes down to stage s only, |alpha| and its sign (2w), t = min(L-1, w)
    argmin passes of a compare and a select an element (2tw), t flips, the
    transform's s w / 2 xors and the partial sums up from the block's end;
    and t forks of 2L adds and the selection's compares.  At r1 = 0 this is
    exact SCL's count."""
    n = N.bit_length() - 1
    stages = r1_stages(frozen, r1, wloop)
    per_path = select = 0
    j = 0
    while j < N:
        t = n if j == 0 else (j & -j).bit_length() - 1
        s = stages[j]
        w = 1 << s
        last = j + (w if s else 1) - 1
        t1 = min(((last + 1) & -(last + 1)).bit_length() - 1, n)
        if t < n:
            per_path += 2 * (1 << t)
        per_path += ((1 << t) - (1 << s)) * CHK_OPS
        if t1 < n:
            per_path += (1 << t1) - 1
        if s:
            forks = min(L - 1, w)
            per_path += 2 * w + 2 * forks * w + forks + s * w // 2
            select += forks * (2 * L + 2 * L * ((2 * L).bit_length() - 1))
            j += w
            continue
        per_path += PHI_BASE_OPS + PHI_PEN_OPS * (1 if frozen[j] else 2)
        if not frozen[j]:
            select += 2 * L * ((2 * L).bit_length() - 1)
        j += 1
    nbytes = B * N * 4 + N + B * L * N + B * L * 4 + B * 4
    return nbytes, B * (L * per_path + select)


def read(ctx):
    per = ctx.launches_per_step(KERNEL)
    if per is None:
        return None
    code = ctx.reference.code
    frozen = code.frozen.tolist()
    d = ctx.config["decoder"]
    L, r1, wloop = int(d["list_size"]), int(d.get("r1", 0)), int(d.get("wloop", 2))
    least = sum(least_seconds(*scl_work(plan.batch, code.N, L, frozen, r1, wloop))
                for plan, _ in ctx.traced_steps())
    busy = sum(b - a for launches in per for _, a, b in launches) / 1e6
    pct = 100.0 * least / busy
    ctx.note(f"scl_decode_r1.roofline_pct {pct} over {len(per)} steps: least "
             f"{least} s, kernel {busy} s, {ctx.card['name']} at "
             f"{ctx.card['power_limit']}")
    return pct
