"""What the six studies share: their records and checkpoints, the reader of
the TPU's logs, and the launch counts.

Each study appends JSON lines to out/<file> (results/h100/ by default, never
inside the TPU archive: reproduce.check_out), each line with the script's
own keys plus `arm` (the key a rerun finds it by), `card` (nvidia-smi's name
and power limit, or the CPU), `commit`, `launches` (the kernels this arm
launched) and `tpu`, the TPU's record of the same run where one is archived.
An arm whose line is in the file is not run again; an arm cut short resumes
from its checkpoint (out/studies_checkpoint.json, one entry an arm, removed
when the arm's line is written).
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, NamedTuple, Optional

from polardecoding_tpu_torch.reproduce import (  # noqa: F401  (re-exported)
    ARCHIVE,
    DEFAULT_OUT,
    Z_LIMIT,
    check_out,
    commit_id,
    launch_counts,
    two_proportion_z,
)

CHECKPOINT_FILE = "studies_checkpoint.json"
# a frame-step arm saves its checkpoint every CHUNK_STEPS steps
CHUNK_STEPS = 64

# Counts that the JAX package gives on the CPU for the first
# step of an arm (the studies' own frames, the scripts' batches), and the
# tie study's CPU record (results/hw_queue_r3/tie_study_128_L32.log, the
# script run on the CPU).  The plain versions give them on the CPU and the
# kernels, bit-equal to the plain versions, on the card.
STUDY_PINS = {
    # bler_r1: SCL_128_L8 at 3.0 dB, frames 0..8191 of run_point's key
    # fold_in(PRNGKey(1024), 300): (errbit, errblock, pm_ties)
    "bler_r1_exact": {"preset": "SCL_128_L8", "snr_db": 3.0, "batch": 8192,
                      "counts": (750, 78, 1)},
    # its rate-1 twin, the JAX frame step with tests/scl_fast_ref.py as its
    # kernel (the JAX package decodes _FASTR1 exact off the TPU)
    "bler_r1_fastr1": {"preset": "SCL_128_L8_FASTR1", "snr_db": 3.0,
                       "batch": 8192, "counts": (764, 81, 1)},
    # bf16_study: BP_128 at 4.0 dB, frames 0..8191 under PRNGKey(1024),
    # make_frame_step(llr_dtype=...,  bp_engine="jnp"): (errbit, errblock,
    # pm_ties)
    "bf16_bfloat16": {"preset": "BP_128", "snr_db": 4.0, "batch": 8192,
                      "counts": (163, 19, 0)},
    "bf16_f32": {"preset": "BP_128", "snr_db": 4.0, "batch": 8192,
                 "counts": (161, 18, 0)},
    # tie_impact_study.py's final line on the CPU
    "tie_impact_128": {"preset": "CASCL_128_L32", "snr_db": 2.0, "frames": 8192,
                       "tie_frames": 4, "blk_default": 142, "blk_strict": 142,
                       "block_outcome_differs": 0, "decoded_bits_differ_total": 0,
                       "tie_frame_errors_default": 0,
                       "tie_frame_errors_strict": 0},
}


class TpuLog(NamedTuple):
    """An archived TPU log: its JSON records in order, each with the
    `section` header (a `=== ... ===` line) above it or None, and its
    other lines (PARITY PASS, rc=0, ...).  JAX's WARNING: lines are
    dropped."""

    records: list
    text: list


def read_log(rel_path: str) -> TpuLog:
    """The TPU log at ARCHIVE/rel_path."""
    records, text, section = [], [], None
    with open(os.path.join(ARCHIVE, rel_path)) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("WARNING:"):
                continue
            if line.startswith("==="):
                section = line.strip("= ").strip()
            elif line.startswith("{"):
                records.append(dict(json.loads(line), section=section))
            else:
                text.append(line)
    return TpuLog(records, text)


def find(records: list, **want) -> Optional[dict]:
    """The first record holding every key of `want` with its value."""
    for r in records:
        if all(r.get(k) == v for k, v in want.items()):
            return r
    return None


def tpu_ref(rel_path: str, rec: Optional[dict]) -> Optional[dict]:
    """A TPU record as a line carries it: the record and its file."""
    if rec is None:
        return None
    return dict({k: v for k, v in rec.items() if k != "section"},
                file=f"results/{rel_path}"
                + (f" ({rec['section']})" if rec.get("section") else ""))


def z_against(errblock: int, frames: int, tpu: Optional[dict]) -> Optional[float]:
    """The two-proportion z of (errblock, frames) against a TPU record."""
    if tpu is None:
        return None
    return two_proportion_z(errblock, frames, tpu["errblock"], tpu["frames"])


def z_over(lines: list, label: Callable[[dict], str]) -> list:
    """"<label>: z ..." for each line whose z lies beyond Z_LIMIT."""
    return [f"{label(x)}: z {x['z']:+.2f}" for x in lines
            if x.get("z") is not None and abs(x["z"]) > Z_LIMIT]


def launches_text(launches: dict) -> str:
    """A line's launches for a report: "kernel n, ..." or "none"."""
    return ", ".join(f"{k} {v}" for k, v in sorted(launches.items())) or "none"


def card_of(device) -> str:
    import torch

    if torch.device(device).type == "cuda":
        from polardecoding_tpu_torch.utils.card import card_line

        return card_line()
    return "cpu (plain versions)"


def _load(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def read_lines(out: str, file: str) -> list:
    """The lines of out/file, oldest first ([] if there is none)."""
    path = os.path.join(out, file)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


class Recorder:
    """One study's records in `out`: its lines (out/<file>) and its arms'
    checkpoints, on `device`, with the card and commit that every line
    carries.  On the card it builds the kernels first, so that no arm's
    time holds a build."""

    def __init__(self, study: str, file: str, out: str = DEFAULT_OUT,
                 device="cuda", commit: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = print):
        import torch

        check_out(out)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("studies: no CUDA device (--device cpu runs "
                                   "the plain versions)")
            from polardecoding_tpu_torch.ops import _build

            _build.build_all()
        os.makedirs(out, exist_ok=True)
        self.study, self.file, self.out = study, file, out
        self.card = card_of(self.device)
        self.commit = commit or commit_id()
        self.log = log or (lambda m: None)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def done(self, arm: str) -> Optional[dict]:
        """The line of a finished arm, or None."""
        return find(read_lines(self.out, self.file), arm=arm)

    def write(self, line: dict) -> dict:
        """Append a line with the card and commit; log it."""
        line = dict(line, card=self.card, commit=self.commit)
        with open(os.path.join(self.out, self.file), "a") as f:
            f.write(json.dumps(line) + "\n")
        self.log(json.dumps(line))
        return line

    def _ckpt_key(self, arm: str) -> str:
        return f"{self.study}/{arm}"

    def checkpoint(self, arm: str) -> Optional[dict]:
        """The saved state of an arm cut short, or None."""
        return (_load(os.path.join(self.out, CHECKPOINT_FILE)) or {}).get(
            self._ckpt_key(arm))

    def save(self, arm: str, state: Optional[dict]):
        """Save an arm's state (None: remove it, and the file once empty)."""
        path = os.path.join(self.out, CHECKPOINT_FILE)
        ckpt = _load(path) or {}
        if state is None:
            ckpt.pop(self._ckpt_key(arm), None)
        else:
            ckpt[self._ckpt_key(arm)] = state
        if ckpt:
            _dump(ckpt, path)
        elif os.path.exists(path):
            os.remove(path)

    def finish(self, arm: str, line: dict) -> dict:
        """Write an arm's line and drop its checkpoint."""
        line = self.write(dict(line, arm=arm))
        self.save(arm, None)
        return line


@contextlib.contextmanager
def counting(device):
    """Counts the kernel launches made inside: yields a dict filled on exit
    with each kernel launched and its count (synchronising the card)."""
    import torch

    got = {}
    before = launch_counts()
    try:
        yield got
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        after = launch_counts()
        got.update({k: after[k] - before[k] for k in after
                    if after[k] != before[k]})


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in sorted({*a, *b})}


def run_resumable(rec: Recorder, arm: str, preset, snr_db: float, batch: int,
                  error_blocks: int, max_frames: int, advance: Callable):
    """Run a point in runs of CHUNK_STEPS steps of `batch` frames, saving
    its counters, seconds and launches after each run, so that a point cut
    short resumes where its checkpoint ends.  advance(res, end) runs steps
    of frames res.frames, res.frames + batch, ... into the PointResult res
    while res.errblock < error_blocks and res.frames < end, as run_point
    does; since every step is pure in its frame start, the runs count what
    one uninterrupted run would.  Returns (PointResult, launches)."""
    from polardecoding_tpu_torch.convert import point_result_from_json
    from polardecoding_tpu_torch.parallel.harness import PointResult

    state = rec.checkpoint(arm)
    res = (point_result_from_json(state["point"]) if state
           else PointResult(preset.name, snr_db, 0, 0, 0, preset.sweep.seed))
    launches = state["launches"] if state else {}
    if state:
        rec.log(f"{arm}: resumed at {res.frames} frames, {res.errblock} "
                "error blocks")
    while res.errblock < error_blocks and res.frames < max_frames:
        with counting(rec.device) as got:
            advance(res, min(max_frames, res.frames + CHUNK_STEPS * batch))
        launches = add_counts(launches, got)
        rec.save(arm, {"point": res.to_json(preset.code.num_info),
                       "launches": launches})
        rec.log(f"{arm}: {res.frames} frames, {res.errblock} error blocks, "
                f"{res.elapsed_s:.3f} s")
    return res, launches


def run_point_resumable(rec: Recorder, arm: str, preset, snr_db: float,
                        batch: int, error_blocks: int, max_frames: int):
    """The port's run_point (sync_every=1, its own point key) through
    run_resumable: one frame step built, each run a run_point call that
    starts from the counters so far and stops at the run's frame cap."""
    from polardecoding_tpu_torch.parallel.harness import (make_frame_step,
                                                          run_point)

    step_fn = make_frame_step(preset, batch, rec.device)

    def advance(res, end):
        run_point(preset, snr_db, batch=batch, device=rec.device,
                  step_fn=step_fn, error_blocks=error_blocks, max_frames=end,
                  start_state=res)

    return run_resumable(rec, arm, preset, snr_db, batch, error_blocks,
                         max_frames, advance)
