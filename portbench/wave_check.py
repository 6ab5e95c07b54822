"""Whether what the early-stop entry's timed path produced is correct
(portbench/waves.py records it).

Every number compared is a gap that a sound run reads as 0, each with the
limit 0 (PERF.md gives the readings they were set from):

  errbit_gap, errblock_gap  over the checked calls, |program - reference|
      of the call's counters, as it returned them to run_point_waves,
      against the reference's counters of the frames the call retired
      (portbench/reference/bp_es.py: each frame run alone);
  retire_gap  over the checked calls, the retirees whose iterations differ
      from the reference's retirement, plus the frames still in a slot that
      the reference had retired by the iterations they ran, plus |the
      call's frames - its retirees|;
  point_sum_gap  over every complete point, |the point's counters - the
      sums of its calls'| plus |its frames - the frame indices handed out
      (the last step's next frame index less its retirees)|;
  stop_rule_gap  the points that broke the wave engine's rule: steps in
      whole chunks, the last chunk the first to start once the counters
      read one chunk behind reach the target (the frame cap, 2^34, is never
      reached), then drains until no slot is left, and nothing after;
  failed_points  the points that raised or ran past the window's grace.

The checked calls are those the run's reservoirs kept: `check.final_steps`
of the points' last steps and drains and `check.other_steps` of the other
steps, drawn from --seed, of complete points.
"""
from __future__ import annotations

import torch

from portbench.cell import Window
from portbench.traffic import Traffic

LIMITS = {"errbit_gap": 0, "errblock_gap": 0, "retire_gap": 0,
          "point_sum_gap": 0, "stop_rule_gap": 0, "failed_points": 0}
CALL_GAPS = ("errbit_gap", "errblock_gap", "retire_gap")


def counts(window: Window) -> list:
    """[errbit, errblock, frames, x] of every call, as it returned them: x
    is a drain's remaining slots and a step's next frame index (read once
    the window has closed)."""
    if not window.steps:
        return []
    rows = [torch.stack([torch.as_tensor(c).reshape(()) for c in
                         (*c.out[:3], c.out[3] if c.kind == "drain" else c.next_fidx)])
            for c in window.steps]
    return torch.stack(rows).cpu().tolist()


def sample_calls(window: Window) -> list:
    """The kept calls of complete points, by index."""
    kept = window.kept["final"] + window.kept["other"]
    return sorted(i for i in kept
                  if window.points[window.steps[i].point].result is not None)


def harness_gaps(window: Window, rows: list) -> tuple:
    """(point_sum_gap, stop_rule_gap) over the complete points."""
    chunk = window.kept["chunk"]
    sum_gap = stop_gap = 0
    for p in window.points:
        res = p.result
        if res is None:
            continue
        calls = window.steps[p.first:p.last]
        rr = rows[p.first:p.last]
        kinds = [c.kind for c in calls]
        n = kinds.index("drain") if "drain" in kinds else len(kinds)
        sums = [sum(r[k] for r in rr) for k in range(3)]
        sum_gap += (abs(res.errbit - sums[0]) + abs(res.errblock - sums[1])
                    + abs(res.frames - sums[2]))
        sum_gap += abs(res.frames - (rr[n - 1][3] - rr[n - 1][2])) if n else 1
        ok = n > 0 and n % chunk == 0
        if ok:
            reached = [0]
            for j in range(n // chunk):
                reached.append(reached[-1] + sum(r[1] for r in rr[j * chunk:(j + 1) * chunk]))
            last = n // chunk
            target = p.plan.error_blocks
            ok = (last >= 2 and reached[last - 1] >= target
                  and reached[last - 2] < target)
        left = [r[3] for r in rr[n:]]
        ok = (ok and all(k == "drain" for k in kinds[n:]) and bool(left)
              and left[-1] == 0 and all(x > 0 for x in left[:-1]))
        stop_gap += int(not ok)
    return sum_gap, stop_gap


def _slots(call, device):
    """(frame indices, retirees, frames still in a slot, iterations done)."""
    if call.kind == "step":
        fidx, retire, iters = (t.to(device) for t in call.slots)
        return fidx, retire & (fidx >= 0), ~retire & (fidx >= 0), iters
    fidx, pending, after, iters = (t.to(device) for t in call.slots)
    return fidx, (fidx >= 0) & ~pending & (after < 0), after >= 0, iters


def outcomes(call, plan, reference, dtype=torch.float32) -> tuple:
    """(retirees, held, the reference's (at, errbit, errblock)) of a call's
    slots that hold a frame (retirees and held index into them)."""
    fidx, named, held, iters = _slots(call, reference.device)
    use = named | held
    return (named[use], held[use],
            reference.frames(plan.seed, plan.snr_db, fidx[use], iters[use], dtype),
            iters[use])


def call_gaps(call, row: list, plan, reference) -> dict:
    named, held, (at, eb, ebl), iters = outcomes(call, plan, reference)
    return {"errbit_gap": abs(row[0] - int(eb[named].sum())),
            "errblock_gap": abs(row[1] - int(ebl[named].sum())),
            "retire_gap": (int((at[named] != iters[named]).sum())
                           + int((at[held] > 0).sum())
                           + abs(row[2] - int(named.sum())))}


def compare(window: Window, traffic: Traffic, reference, seed: int) -> tuple:
    """({name: (value, limit)}, picks, the failed points' count); the picks
    were drawn from the seed while the window ran."""
    rows = counts(window)
    picks = sample_calls(window)
    gaps = dict.fromkeys(CALL_GAPS, 0)
    bad = set()
    for i in picks:
        call = window.steps[i]
        g = call_gaps(call, rows[i], window.points[call.point].plan, reference)
        for k, v in g.items():
            gaps[k] += v
        if any(g.values()):
            bad.add(call.point)
    gaps["point_sum_gap"], gaps["stop_rule_gap"] = harness_gaps(window, rows)
    failed = sum(p.result is None for p in window.points)
    gaps["failed_points"] = failed
    return {k: (v, LIMITS[k]) for k, v in gaps.items()}, picks, failed + len(bad)


def control(window: Window, traffic: Traffic, reference, seed: int, dtype) -> tuple:
    """({name: (value, limit)}, picks) of the control: the reference in
    `dtype` put in the program's place on the same calls' slots, its
    counters over each call's retirees and its retirements against the
    configured reference's."""
    picks = sample_calls(window)
    gaps = dict.fromkeys(CALL_GAPS, 0)
    for i in picks:
        call = window.steps[i]
        plan = window.points[call.point].plan
        named, _, (at, eb, ebl), _ = outcomes(call, plan, reference)
        _, _, (at2, eb2, ebl2), _ = outcomes(call, plan, reference, dtype)
        gaps["errbit_gap"] += abs(int(eb2[named].sum()) - int(eb[named].sum()))
        gaps["errblock_gap"] += abs(int(ebl2[named].sum()) - int(ebl[named].sum()))
        gaps["retire_gap"] += int((at2 != at).sum())
    return {k: (v, LIMITS[k]) for k, v in gaps.items()}, picks


def correct(compared: dict) -> bool:
    return all(v <= lim for v, lim in compared.values())
