"""Whether what the timed path produced is correct.

Every number compared is a gap that a sound run reads as 0, each with the
limit 0 (PERF.md gives the readings they were set from):

  errbit_gap, errblock_gap, tie_gap  over steps drawn from --seed, the sum
      of |program - reference| of the step's counters (errbit, errblock,
      pm_ties) as the step returned them to run_point, against the plain
      reference's counters of the same frames (portbench/reference);
  point_sum_gap  over every point, |the point's counters and frames -
      the sums of its steps' counters and batch x steps| plus the steps
      whose first frame is not the point's next frame;
  stop_rule_gap  the points that stopped before their error-block target,
      or ran a step past it;
  failed_points  the points that raised or ran past the window's grace.

The steps drawn are `check.final_steps` of the points' last steps (each
holds an error block by the stop rule) and `check.other_steps` of the
rest, from complete points only.
"""
from __future__ import annotations

import numpy as np

from portbench.cell import Window
from portbench.traffic import Traffic

LIMITS = {"errbit_gap": 0, "errblock_gap": 0, "tie_gap": 0,
          "point_sum_gap": 0, "stop_rule_gap": 0, "failed_points": 0}


def sample_steps(window: Window, traffic: Traffic, seed: int) -> list:
    """Indices of window.steps that the check compares, drawn from seed."""
    done = [p for p in window.points if p.result is not None and p.last > p.first]
    finals = [p.last - 1 for p in done]
    others = [s for p in done for s in range(p.first, p.last - 1)]
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0xC4EC])
    pick = []
    for pool, k in ((finals, traffic.check["final_steps"]),
                    (others, traffic.check["other_steps"])):
        k = min(int(k), len(pool))
        if k:
            pick.extend(int(s) for s in rng.choice(pool, size=k, replace=False))
    return sorted(pick)


def harness_gaps(window: Window, counts: list) -> tuple:
    """(point_sum_gap, stop_rule_gap) over the complete points."""
    sum_gap = stop_gap = 0
    for p in window.points:
        res = p.result
        if res is None:
            continue
        rows = np.asarray(counts[p.first:p.last], dtype=np.int64).reshape(-1, 3)
        sums = rows.sum(axis=0)
        n = len(rows)
        sum_gap += (abs(res.errbit - int(sums[0])) + abs(res.errblock - int(sums[1]))
                    + abs(res.pm_ties - int(sums[2]))
                    + abs(res.frames - n * p.plan.batch))
        starts = [s.frame_start for s in window.steps[p.first:p.last]]
        sum_gap += sum(s != k * p.plan.batch for k, s in enumerate(starts))
        cum = np.cumsum(rows[:, 1])
        target = p.plan.error_blocks
        stop_gap += int(n == 0 or cum[-1] < target or (n > 1 and cum[-2] >= target))
    return sum_gap, stop_gap


def reference_counts(window: Window, picks: list, reference, dtype=None) -> list:
    """The reference's counters of each picked step, in `dtype` (default
    the configured float32)."""
    kw = {} if dtype is None else {"dtype": dtype}
    out = []
    for s in picks:
        rec = window.steps[s]
        plan = window.points[rec.point].plan
        out.append(reference.counters(plan.seed, plan.snr_db, rec.frame_start,
                                      plan.batch, **kw))
    return out


def step_gaps(counts: list, picks: list, ref: list) -> dict:
    gaps = {"errbit_gap": 0, "errblock_gap": 0, "tie_gap": 0}
    for s, want in zip(picks, ref):
        for name, got, w in zip(gaps, counts[s], want):
            gaps[name] += abs(int(got) - int(w))
    return gaps


def compare(window: Window, traffic: Traffic, reference, seed: int) -> tuple:
    """({name: (value, limit)}, picks, the failed points' count): the
    numbers compared for the run's `correct`."""
    counts = window.counts()
    picks = sample_steps(window, traffic, seed)
    ref = reference_counts(window, picks, reference)
    gaps = step_gaps(counts, picks, ref)
    gaps["point_sum_gap"], gaps["stop_rule_gap"] = harness_gaps(window, counts)
    failed = sum(p.result is None for p in window.points)
    gaps["failed_points"] = failed
    # the complete points whose checked steps disagree, counted once each
    bad = {window.steps[s].point for s, want in zip(picks, ref)
           if tuple(counts[s]) != tuple(want)}
    return {k: (v, LIMITS[k]) for k, v in gaps.items()}, picks, failed + len(bad)


def control(window: Window, traffic: Traffic, reference, seed: int, dtype) -> tuple:
    """({name: (value, limit)}, picks) of the control: the counters of the
    steps drawn from the seed decoded by the reference in `dtype`, put in
    the program's place, against the configured reference's."""
    picks = sample_steps(window, traffic, seed)
    want = reference_counts(window, picks, reference)
    got = reference_counts(window, picks, reference, dtype=dtype)
    gaps = step_gaps(got, list(range(len(picks))), want)
    return {k: (v, LIMITS[k]) for k, v in gaps.items()}, picks


def correct(compared: dict) -> bool:
    return all(v <= lim for v, lim in compared.values())
