"""bp_wave_fused.roofline_pct: the fused wave kernel's share of its roofline
over the traced points' calls of the wave stepper: the least time that the
calls' work needs at the H100's peaks (portbench/peaks.least_seconds, call
by call), over the device time of the kernels named bp_wave_kernel in those
calls (one launch a call).

The work is what the early-stop engine is defined to do (run_point_waves
with make_wave_step's fused stepper), counted from shapes and not from the
kernel: a call runs `wave_iters` flooding iterations on each slot it runs,
then the G-matrix decide.  A step runs every slot; a drain runs the slots
still live before it: for a point's first drain the batch less the last
step's retirees (their slots die at the drain's head instead of
refilling), then the previous drain's `remaining`.  An iteration's CHKs
are counted as bp_decode.roofline_pct's counted_chks counts those of a
one-iteration decode, each at that metric's CHK_OPS with the add beside
it: a CHK whose table difference is +0 on the slot's messages
(zero-difference, which the kernel skips) is counted at full cost, since
the count does not read the messages.  Bytes: the state's 2(n+1) float32
planes read and written once, fresh LLRs in on a step, the decisions and
the done flags out."""
from portbench.peaks import least_seconds
from portbench.spec import metric_reader

KERNEL = "bp_wave_kernel"
CHK_OPS = metric_reader("bp_decode.roofline_pct").CHK_OPS


def chks_per_iteration(N: int) -> int:
    """A slot's CHKs in one flooding iteration: four a butterfly at each of
    the n stages (two in each sweep), less the L sweep's CHK(R[n-1], L[n])
    at stage n-1, which repeats the R sweep's on the same operands."""
    n = N.bit_length() - 1
    return (4 * n - 1) * N // 2


def slot_ops(N: int, wave_iters: int) -> int:
    """A slot's operations in one call: the iterations' CHKs, each with its
    add, then the decide: the decision re-encoded (n N / 2 XORs) and
    compared with the channel side's hard decision (N compares)."""
    n = N.bit_length() - 1
    return wave_iters * chks_per_iteration(N) * (CHK_OPS + 1) + n * N // 2 + N


def slot_bytes(N: int, step: bool) -> int:
    """A slot's bytes in one call: 2(n+1) float32 planes in and out, N
    float32 LLRs in on a step, N int8 decisions and a done byte out."""
    n = N.bit_length() - 1
    return 2 * 2 * (n + 1) * N * 4 + (4 * N if step else 0) + N + 1


def call_slots(calls: list, batch: int) -> list:
    """The slots each of a run of whole points' calls (waves.Call, in
    order) runs: the batch on a step; on a drain, the batch less the
    retirees of the step before it, or the remaining of the drain before
    it."""
    out = []
    for i, c in enumerate(calls):
        if c.kind == "step":
            out.append(batch)
        elif calls[i - 1].kind == "step":
            out.append(batch - int(calls[i - 1].out[2]))
        else:
            out.append(int(calls[i - 1].out[3]))
    return out


def wave_work(calls: list, batch: int, N: int, wave_iters: int) -> list:
    """[(bytes, operations)] of each call."""
    return [(s * slot_bytes(N, c.kind == "step"), s * slot_ops(N, wave_iters))
            for c, s in zip(calls, call_slots(calls, batch))]


def read(ctx):
    per = ctx.launches_per_step(KERNEL)
    if per is None:
        return None
    steps = ctx.traced_steps()
    calls = [c for _, c in steps]
    work = wave_work(calls, steps[0][0].batch, ctx.config["code"]["N"],
                     ctx.config["decoder"]["wave_iters"])
    least = sum(least_seconds(b, ops) for b, ops in work)
    busy = sum(b - a for launches in per for _, a, b in launches) / 1e6
    pct = 100.0 * least / busy
    ctx.note(f"bp_wave_fused.roofline_pct {pct} over {len(calls)} calls "
             f"({sum(c.kind == 'drain' for c in calls)} drains): least {least} s, "
             f"kernel {busy} s, {ctx.card['name']} at {ctx.card['power_limit']}")
    return pct
