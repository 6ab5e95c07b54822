"""The work counts that the roofline metrics divide by equal the ones
chip_smoke.py (the program's hardware check) counts, on the same small
shapes and inputs: the benchmark keeps its own copy, which later changes to
the program cannot move."""
import os
import sys

import numpy as np
import pytest
import torch

from portbench.spec import ROOT, metric_reader
from portbench.reference.step import Reference

SCL = metric_reader("scl_decode.roofline_pct")
BP = metric_reader("bp_decode.roofline_pct")
FC = metric_reader("frame_channel.roofline_pct")

CASCL_128 = {"code": {"N": 128, "K": 64, "crc": [0, 5, 6]},
             "decoder": {"kind": "cascl", "list_size": 8},
             "step": {"channel": "threefry"}}
BP_N = {64: {"code": {"N": 64, "K": 32}, "decoder": {"kind": "bp", "iters": 6},
             "step": {"channel": "threefry"}},
        128: {"code": {"N": 128, "K": 64}, "decoder": {"kind": "bp", "iters": 5},
              "step": {"channel": "threefry"}}}


@pytest.fixture(scope="module")
def chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("N,L,B", [(128, 8, 33), (1024, 8, 16384), (1024, 32, 4),
                                   (64, 2, 7)])
def test_scl_work_is_chip_smokes(chip_smoke, N, L, B):
    rng = np.random.default_rng(N * L)
    for frozen in (Reference({"code": {"N": N, "K": N // 2}, "decoder": {"kind": "scl", "list_size": L},
                              "step": {"channel": "threefry"}}, "cpu").code.frozen.tolist(),
                   list(rng.random(N) < 0.5)):
        assert SCL.scl_work(B, N, L, frozen) == chip_smoke.scl_work(B, N, L, frozen, 0)


@pytest.mark.parametrize("N", [64, 128])
def test_bp_work_is_chip_smokes_on_the_same_llrs(chip_smoke, N):
    from polardecoding_tpu_torch.models.bp import bp_decode

    cfg = BP_N[N]
    ref = Reference(cfg, "cpu")
    _, _, llr = ref.inputs(1024, 3.0, 4096, 24)
    mine = BP.counted_chks(ref, llr)
    with chip_smoke.counted_chks("minsum_lut") as theirs:
        bp_decode(llr, ref.code.frozen, iters=cfg["decoder"]["iters"])
    assert mine == {"chks": theirs["chks"], "zero": theirs["zero"]}
    assert 0 < mine["zero"] < mine["chks"]
    assert BP.bp_work(24, N, mine) == chip_smoke.bp_work(24, N, theirs)


@pytest.mark.parametrize("snr", [-2.0, 2.5, 10.0])
def test_frame_channel_work_is_chip_smokes(chip_smoke, snr):
    ref = Reference(CASCL_128, "cpu")
    _, words, _ = ref.inputs(77, snr, 2**31 - 5, 64)
    mine = FC.channel_branches(words)
    assert mine == chip_smoke.channel_branches(words)
    assert FC.frame_channel_work(64, 128, *mine) == chip_smoke.frame_channel_work(64, 128, *mine)


def test_peaks_are_chip_smokes(chip_smoke):
    from portbench import peaks

    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.OPS_PER_S == chip_smoke.OPS_PER_S
    assert peaks.INT_OPS_PER_S == chip_smoke.INT_OPS_PER_S
    for nbytes, ops, iops in [(1e9, 1e9, 0), (1e6, 1e12, 1e9), (10, 10, 1e12)]:
        want, _ = chip_smoke.bound(nbytes, ops, iops)
        assert peaks.least_seconds(nbytes, ops, iops) * 1e3 == pytest.approx(want, rel=1e-12)
