"""The PM-tie policy study (port of scripts/tie_impact_study.py): the same
CA-SCL frames decoded under the kept-exactly-L selection (the port's
default) and the reference's strict-below-median policy, then
cascl_select; counts of tie frames, block errors under each policy, block
outcomes and decoded bits that differ.  The default policy runs row 6's
kernel; no kernel has the strict policy (neither the TPU's nor the port's),
so that arm runs the plain models/scl.scl_decode(strict_median=True) on the
same device.  The two tie counters must be equal, as the script asserts.

CASCL_128_L32 at 2.0 dB over 8192 frames is the script's default, and its
record (results/hw_queue_r3/tie_study_128_L32.log) was written on the CPU
by the JAX package: held exactly (STUDY_PINS).  CASCL_1024_L32 at 1.5 dB
over 4096 frames (--preset/--snr/--frames) is the TPU's record
hw_queue_r3/tie_study_1024_L32.log (results/REPRODUCTION_EXTRA.md:162-165),
held by z.
"""
from __future__ import annotations

import time

from polardecoding_tpu_torch.studies._common import (
    STUDY_PINS,
    Z_LIMIT,
    Recorder,
    add_counts,
    counting,
    launches_text,
    read_log,
    tpu_ref,
    two_proportion_z,
)

FILE = "tie_impact.jsonl"
# tie_impact_study.py:45-50
PRESET = "CASCL_128_L32"
FRAMES = 8192
SNR = 2.0
BATCH = 512
TPU_LOGS = {("CASCL_128_L32", 2.0): "hw_queue_r3/tie_study_128_L32.log",
            ("CASCL_1024_L32", 1.5): "hw_queue_r3/tie_study_1024_L32.log"}
# the running and final lines' counters
COUNTERS = ("tie_frames", "blk_default", "blk_strict", "outcome_differs",
            "decoded_bits_differ", "tie_err_default", "tie_err_strict")
# the 1024 log's keys (an unarchived variant of the script) for the running
# line's
TPU_1024_KEYS = {"ties": "tie_frames", "blk_d": "blk_default",
                 "blk_s": "blk_strict", "outcome_diff": "outcome_differs",
                 "bits_diff_frames": "decoded_bits_differ"}


def make_batch(p, device, snr_db: float):
    """tie_impact_study.py:60-67: frames fidx -> (LLRs, payload || CRC
    words): PN payload, multiplicative CRC, scattered on the info set,
    encoded, under the keys fold_in(PRNGKey(seed), i).  The script's
    generator closes over sigma, so its LLRs are XLA's constant-folded form
    (ops/channel.awgn_llr_const_sigma, plain PyTorch), not the frame step's
    that the frame channel kernel computes: with the kernel's, one frame of
    the 8192 of CASCL_128_L32 at 2.0 dB ties that does not in the record,
    and one that does, does not."""
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_info_set
    from polardecoding_tpu_torch.ops.channel import (awgn_llr_const_sigma,
                                                     fold_in, prng_key)
    from polardecoding_tpu_torch.ops.crc import crc_encode_multiplicative
    from polardecoding_tpu_torch.ops.encode import polar_encode, scatter_info
    from polardecoding_tpu_torch.parallel.harness import payload_from_index
    from polardecoding_tpu_torch.utils.pn import pn_sequence

    code = p.code
    info = torch.as_tensor(code_info_set(code), dtype=torch.int64, device=device)
    pn = torch.as_tensor(pn_sequence(), device=device)
    key = prng_key(p.sweep.seed, device)
    sigma = float(10.0 ** (-snr_db / 20.0))

    def gen(fidx):
        w = crc_encode_multiplicative(payload_from_index(fidx, pn, code.K),
                                      code.crc)
        x = polar_encode(scatter_info(w, info, code.N))
        return awgn_llr_const_sigma(x, fold_in(key, fidx), sigma), w

    return gen, info


def decode_both(llr, frozen, info, R, L: int):
    """(u_default, u_strict, ties, ties_strict): the kernel's (or on the
    CPU the plain) default selection and the plain strict one, each through
    cascl_select."""
    from polardecoding_tpu_torch.models.scl import (cascl_select, scl_decode,
                                                    scl_decode_auto)

    u_all, pm, ties = scl_decode_auto(llr, frozen, list_size=L, return_all=True,
                                      return_ties=True)
    ud, _ = cascl_select(u_all, pm, info, R)
    u_all, pm, ties2 = scl_decode(llr, frozen, list_size=L, return_all=True,
                                  return_ties=True, strict_median=True)
    us, _ = cascl_select(u_all, pm, info, R)
    return ud, us, ties, ties2


def run(rec: Recorder, preset_name: str = PRESET, snr: float = SNR,
        frames: int = FRAMES, batch: int = BATCH) -> list:
    """The running lines (one a batch, the script's keys with preset and
    snr_db) and the final line; a run cut short resumes from its last
    batch.  The final line adds the seconds, the launches, the TPU's (or
    the CPU record's) final counts and the z of tie and error rates."""
    import torch

    from polardecoding_tpu_torch.analysis.construction import code_frozen_mask
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.crc import check_matrix

    p = preset(preset_name)
    L = p.decoder.list_size
    arm = f"{preset_name}@{snr} frames={frames} batch={batch}"
    line = rec.done(arm)
    if line is not None:
        return [line]
    frozen = torch.as_tensor(code_frozen_mask(p.code), device=rec.device)
    gen, info = make_batch(p, rec.device, snr)
    R = check_matrix(p.code.crc, p.code.num_info)
    state = rec.checkpoint(arm) or {"done": 0, "seconds": 0.0, "launches": {},
                                    **{k: 0 for k in COUNTERS}}
    lines = []
    while state["done"] < frames:
        t0 = time.perf_counter()
        fidx = state["done"] + torch.arange(batch, dtype=torch.int64,
                                            device=rec.device)
        with counting(rec.device) as got:
            llr, w = gen(fidx)
            ud, us, ties, ties2 = decode_both(llr, frozen, info, R, L)
        if not torch.equal(ties, ties2):
            raise RuntimeError(f"tie study {arm}: the policies' tie counters "
                               f"differ at frames {state['done']}..")
        bad_d = (ud[:, info] != w).any(dim=-1)
        bad_s = (us[:, info] != w).any(dim=-1)
        t = ties > 0
        add = {"tie_frames": t.sum(), "blk_default": bad_d.sum(),
               "blk_strict": bad_s.sum(), "outcome_differs": (bad_d != bad_s).sum(),
               "tie_err_default": bad_d[t].sum(), "tie_err_strict": bad_s[t].sum()}
        for k, v in add.items():
            state[k] += int(v)
        # the script's bits_differ is the last batch's, not a running sum
        state["decoded_bits_differ"] = int((ud != us).any(dim=-1).sum())
        state["bits_differ_total"] = (state.get("bits_differ_total", 0)
                                      + state["decoded_bits_differ"])
        state["done"] += batch
        state["seconds"] += time.perf_counter() - t0
        state["launches"] = add_counts(state["launches"], got)
        lines.append(rec.write({
            "preset": preset_name, "snr_db": snr, "frames": state["done"],
            **{k: state[k] for k in COUNTERS[:5]}}))
        rec.save(arm, state)
    done = state["done"]
    tpu = tpu_final(preset_name, snr)
    final = {
        "preset": preset_name, "snr_db": snr, "frames": done,
        "tie_frames": state["tie_frames"],
        "tie_rate": state["tie_frames"] / done,
        "blk_default": state["blk_default"], "blk_strict": state["blk_strict"],
        "block_outcome_differs": state["outcome_differs"],
        "tie_frame_errors_default": state["tie_err_default"],
        "tie_frame_errors_strict": state["tie_err_strict"],
        "decoded_bits_differ_total": state["bits_differ_total"],
        "batch": batch, "seconds": state["seconds"],
        "launches": state["launches"], "tpu": tpu}
    if tpu is not None:
        final["z_tie_rate"] = two_proportion_z(final["tie_frames"], done,
                                               tpu["tie_frames"], tpu["frames"])
        final["z"] = two_proportion_z(final["blk_default"], done,
                                      tpu["blk_default"], tpu["frames"])
        final["same_as_tpu"] = all(final[k] == tpu[k] for k in FINAL_KEYS
                                   if k in tpu)
    lines.append(rec.finish(arm, final))
    return lines


# the final line's counts that a record holds
FINAL_KEYS = ("frames", "tie_frames", "blk_default", "blk_strict",
              "block_outcome_differs", "tie_frame_errors_default",
              "tie_frame_errors_strict")


def tpu_final(preset_name: str, snr: float):
    """The archived final counts of a run: the script's final line
    (CASCL_128_L32, 2.0 dB), or the 1024 log's last running line under the
    script's keys (the variant that wrote it printed no final line)."""
    log = TPU_LOGS.get((preset_name, snr))
    if log is None:
        return None
    recs = read_log(log).records
    final = [r for r in recs if "preset" in r]
    if final:
        return tpu_ref(log, final[-1])
    last = recs[-1]
    rec = {TPU_1024_KEYS.get(k, k): v for k, v in last.items()}
    rec["block_outcome_differs"] = rec.pop("outcome_differs")
    return tpu_ref(log, rec)


def checks(lines: list) -> list:
    """The CPU record exactly (STUDY_PINS["tie_impact_128"]); elsewhere no
    block outcome that differs, and |z| <= 4 of the tie and error rates."""
    bad = []
    pin = STUDY_PINS["tie_impact_128"]
    for x in lines:
        if "block_outcome_differs" not in x:
            continue
        if (x["preset"], x["snr_db"], x["frames"]) == (
                pin["preset"], pin["snr_db"], pin["frames"]):
            got = {k: x[k] for k in pin if k in x}
            want = {k: v for k, v in pin.items() if k in x}
            if got != want:
                bad.append(f"tie study {x['preset']}: {got} against {want}")
        elif x["block_outcome_differs"] or any(
                abs(x.get(k) or 0.0) > Z_LIMIT for k in ("z", "z_tie_rate")):
            bad.append(f"tie study {x['preset']} @ {x['snr_db']}: outcome "
                       f"diffs {x['block_outcome_differs']}, z {x.get('z')}, "
                       f"tie-rate z {x.get('z_tie_rate')}")
    return bad


def report(lines: list) -> list:
    out = ["## tie_impact_study: kept-exactly-L against strict-below-median "
           "(scripts/tie_impact_study.py; records: results/hw_queue_r3/"
           "tie_study_128_L32.log, JAX on the CPU, and tie_study_1024_L32.log, "
           "the TPU)", "",
           "| preset | Eb/N0 | frames | tie frames | blk default | blk strict | "
           "outcome diffs | bit diffs (all batches) | tie-frame errors d/s | s | "
           "launches | record's tie frames | record's blk d/s | record's diffs | "
           "z (tie rate) | z (BLER) | same counts |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for x in lines:
        if "block_outcome_differs" not in x:
            continue
        t = x["tpu"] or {}
        out.append(
            f"| {x['preset']} | {x['snr_db']} | {x['frames']} | {x['tie_frames']} | "
            f"{x['blk_default']} | {x['blk_strict']} | {x['block_outcome_differs']} | "
            f"{x['decoded_bits_differ_total']} | {x['tie_frame_errors_default']}/"
            f"{x['tie_frame_errors_strict']} | {x['seconds']:.3f} | "
            f"{launches_text(x['launches'])} | "
            + (f"{t['tie_frames']} | {t['blk_default']}/{t['blk_strict']} | "
               f"{t['block_outcome_differs']} | {x['z_tie_rate']:+.2f} | "
               f"{x['z']:+.2f} | {'yes' if x['same_as_tpu'] else 'no'} |"
               if t else " | | | | | |"))
    return out + [""]


def main_args(args) -> dict:
    return dict(preset_name=args.preset or PRESET,
                snr=SNR if args.snr is None else args.snr,
                frames=args.frames or FRAMES, batch=args.batch or BATCH)
