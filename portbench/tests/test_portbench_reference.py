"""The frozen reference gives the counters of the program's plain versions
(its frame step on the CPU) on the same frames, at test sizes."""
import pytest
import torch

from portbench.reference.step import Reference
from portbench.tests.conftest import DATA

CRC24 = [0, 1, 2, 4, 8, 12, 13, 15, 17, 20, 21, 23, 24]
CASES = [
    ("CASCL_128_L8", {"N": 128, "K": 64, "crc": [0, 5, 6]}, {"kind": "cascl", "list_size": 8}, 64),
    ("SCL_128_L8", {"N": 128, "K": 64}, {"kind": "scl", "list_size": 8}, 64),
    ("BP_128", {"N": 128, "K": 64}, {"kind": "bp", "iters": 100}, 64),
    ("CASCL_1024_L8", {"N": 1024, "K": 512, "crc": CRC24}, {"kind": "cascl", "list_size": 8}, 8),
    ("BP_1024", {"N": 1024, "K": 512}, {"kind": "bp", "iters": 100}, 8),
]
POINTS = [(1024, 1.0, 0), (2**33 + 5, 0.5, 12_345_678), (2**31 + 77, 2.0, 2**31 - 3)]


@pytest.mark.parametrize("name,code,decoder,batch", CASES, ids=[c[0] for c in CASES])
def test_reference_counters_are_the_plain_steps(name, code, decoder, batch):
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    step = make_frame_step(preset(name), batch, "cpu")
    ref = Reference({"code": code, "decoder": decoder, "step": {"channel": "threefry"}}, "cpu")
    points = POINTS if code["N"] == 128 else POINTS[:2]
    seen = 0
    for seed, snr, start in points:
        key = fold_in(prng_key(seed, "cpu"), int(round(snr * 100)))
        got = tuple(int(c) for c in step(key, start, float(10 ** (-snr / 20))))
        want = ref.counters(seed, snr, start, batch)
        assert got == want, (seed, snr, start)
        seen += want[1]
    assert seen > 0


def test_reference_refuses_what_it_does_not_model():
    base = {"code": {"N": 128, "K": 64}, "decoder": {"kind": "bp", "iters": 5},
            "step": {"channel": "threefry"}}
    for change in ({"step": {"channel": "mc"}},
                   {"decoder": {"kind": "scl", "list_size": 8, "r1": 4}},
                   {"code": {"N": 128, "K": 64, "construction": "ga_sc"}}):
        with pytest.raises(ValueError):
            Reference({**base, **change}, "cpu")


def test_the_control_in_bfloat16_differs():
    """The control, the reference decoded in bfloat16, reads other counters
    than float32 at a test size on three seeds (the chip reads it at the
    cells' own sizes: portbench/control.py)."""
    from portbench.spec import load_json
    import os

    for name in ("cascl_128_l8", "bp_128"):
        ref = Reference(load_json(os.path.join(DATA, f"{name}.json")), "cpu")
        for seed in (11, 12, 13):
            f32 = ref.counters(seed, 1.5, 0, 256)
            bf16 = ref.counters(seed, 1.5, 0, 256, dtype=torch.bfloat16)
            assert f32 != bf16, (name, seed, f32)


@pytest.mark.parametrize("config", ["cascl_128_l8", "bp_128"])
def test_the_control_comes_out_not_correct_through_the_check(config):
    """portbench.control at a test size: the program's seed comes out
    correct by check.correct and check.LIMITS, each control seed not."""
    import dataclasses

    from portbench import control
    from portbench.tests.conftest import make_cell

    cell = make_cell(config)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "batch": 256,
                                              "snr_db": 1.5})
    rows = control.readings(cell, [21], [11, 12, 13], 0.3, "cpu")
    assert [(r["kind"], r["correct"]) for r in rows] == \
        [("program", True)] + [("control", False)] * 3
