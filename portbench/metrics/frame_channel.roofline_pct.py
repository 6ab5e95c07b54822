"""frame_channel.roofline_pct: the frame channel kernel's share of its
roofline on the first COUNTED_STEPS traced steps: the least time that the
channel of their frames needs at the H100's peaks (frame_channel_work),
over the device time of the kernels named frame_channel_kernel in those
steps.

The work is counted from the channel's arithmetic on the step's own noise
words (worked out again by the reference): a fold-in per frame, a
threefry block, the uniform and the LLR per element, and the branch of
log1p and of erf_inv that each element takes (channel_branches)."""
from portbench.peaks import least_seconds

KERNEL = "frame_channel_kernel"
COUNTED_STEPS = 8
# a two-word threefry2x32 block whose counter's first word is 0: the key
# added to the second word, 20 mixes of an add, a rotate and a xor, and 10
# key injections of one add
THREEFRY2_INT_OPS = 1 + 20 * 3 + 10
# per element besides: integer, the words' xor and the uniform's shift and
# or; float, the uniform (a subtraction, the product, the add, the clamp),
# t = u * -u, the branch compares of log1p and erf_inv, erf_inv's argument
# (one subtraction), Giles' 8 fmaf, the product with u, and the LLR
# (1 - 2x, the fma, y + y, the divide)
FRAME_INT_OPS = 1 + 2
FRAME_OPS = 4 + 1 + 1 + 1 + 1 + 8 + 1 + 5
# log1p for |t| < sqrt(2) - 1: 6 + 6 fmaf, t^2, t^3, P/Q, the product, the
# fma and the add; else t + 1 and XLA's log (integer: the exponent's and
# mantissa's shift, subtraction and logic op; float: a conversion and 22)
LOG1P_SMALL_OPS = 12 + 6
LOG1P_LOG_OPS, LOG1P_LOG_INT_OPS = 1 + 23, 3


def channel_branches(words):
    """(elements whose log1p takes the rational branch, elements whose
    erf_inv takes the sqrt branch) of the channel on the words [B, N]."""
    from portbench.reference.channel import LOG1P_SMALL, log1p_f32, uniform

    u = uniform(words)
    t = u * -u
    ge5 = ~(log1p_f32(t) > -5.0)
    return int((t.abs() < LOG1P_SMALL).sum()), int(ge5.sum())


def frame_channel_work(B, N, small, ge5):
    """(bytes, operations, integer operations) of the channel of B frames
    of N: codeword bits in, LLRs out, frame indices and key in."""
    elements = B * N
    logs = elements - small
    int_ops = (B * THREEFRY2_INT_OPS
               + elements * (THREEFRY2_INT_OPS + FRAME_INT_OPS)
               + logs * LOG1P_LOG_INT_OPS)
    ops = (int_ops + elements * FRAME_OPS + small * LOG1P_SMALL_OPS
           + logs * LOG1P_LOG_OPS + ge5)
    return elements * 8 + B * 8 + 16, ops, int_ops


def read(ctx):
    per = ctx.launches_per_step(KERNEL)
    if per is None:
        return None
    least = busy = 0.0
    steps = ctx.traced_steps()[:COUNTED_STEPS]
    for (plan, rec), launches in zip(steps, per):
        _, words, _ = ctx.reference.inputs(plan.seed, plan.snr_db,
                                           rec.frame_start, plan.batch)
        small, ge5 = channel_branches(words)
        least += least_seconds(*frame_channel_work(plan.batch, ctx.reference.code.N,
                                                   small, ge5))
        busy += sum(b - a for _, a, b in launches) / 1e6
    pct = 100.0 * least / busy
    ctx.note(f"frame_channel.roofline_pct {pct} over {len(steps)} steps: "
             f"least {least} s, kernel {busy} s, {ctx.card['name']} at "
             f"{ctx.card['power_limit']}")
    return pct
