"""BPr (the per-stage convergence instrumentation of BPr_128.c) in the port
against the JAX package on the CPU: models/bp.bpr_decode's u_hat and
stage-error table E bit-equal to JAX's bpr_decode in float32, with repeated
checkpoints and one past the iterations; the float64 golden check against
the patched C reference; make_bpr_step, run_bpr_point and `cli bpr` equal
to JAX's; and a BPr preset refused by make_frame_step.  Inputs come from
numpy seeds."""
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import cli as jcli
from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.models.bp import bpr_decode as jax_bpr_decode
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.utils.gf2 import dense_generator, encode_dense
from polardecoding_tpu.utils.pn import payload_bits_host
from polardecoding_tpu.utils.rng import golden_noise
from polardecoding_tpu.utils.sequences import frozen_mask, info_set
from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.models.bp import bpr_decode, bpr_stage_errors
from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
from polardecoding_tpu_torch.parallel import harness as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "bpr_128_snr2.txt")
CHECKPOINTS = (3, 6, 10, 20, 40, 80)


def _frames(N, B, snr, seed):
    """(llr float32 [B, N], frozen, u int8 [B, N], I) of random payloads at
    rate 1/2 through BPSK and numpy's Gaussian noise at snr dB."""
    rng = np.random.default_rng(seed)
    I = info_set(N, N // 2)
    u = np.zeros((B, N), np.int8)
    u[:, I] = rng.integers(0, 2, (B, N // 2))
    x = (u.astype(np.int64) @ dense_generator(N)) % 2
    sigma = 10.0 ** (-snr / 20.0)
    y = (1.0 - 2.0 * x) + sigma * rng.standard_normal((B, N))
    return (2.0 * y / sigma ** 2).astype(np.float32), frozen_mask(N, N // 2), u, I


def _both(llr, frozen, u, I, **kw):
    want = jax_bpr_decode(jnp.asarray(llr), jnp.asarray(frozen), jnp.asarray(u),
                          jnp.asarray(I), **kw)
    got = bpr_decode(torch.as_tensor(llr), torch.as_tensor(frozen),
                     torch.as_tensor(u), torch.as_tensor(I), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("N", [32, 128])
@pytest.mark.parametrize("snr", [1.0, 2.0, 3.0])
def test_bpr_decode_equals_jax(N, snr):
    """u_hat and E bit-equal to JAX's bpr_decode in float32 at BPr_128's
    checkpoints and 90 iterations, B=64."""
    (wu, wE), (gu, gE) = _both(*_frames(N, 64, snr, N), iters=90,
                               checkpoints=CHECKPOINTS)
    assert gu.dtype == np.int8 and gE.dtype == np.int64
    assert gE.shape == (len(CHECKPOINTS), N.bit_length())
    assert (gu == wu).all() and (gE == wE).all()
    assert gE[-1, 0] > 0 or snr == 3.0  # the table counts errors


@pytest.mark.parametrize("checkpoints", [(12, 5, 5), (10, 95)])
def test_bpr_checkpoints_repeat_and_pass_the_iterations(checkpoints):
    """Checkpoints are taken in sorted order; a repeat snapshots the same
    state again (two equal rows), and one past `iters` runs the iterations
    on to it, u_hat decided there, as in JAX."""
    (wu, wE), (gu, gE) = _both(*_frames(32, 64, 1.5, 3), iters=90,
                               checkpoints=checkpoints)
    assert (gu == wu).all() and (gE == wE).all()
    if len(set(checkpoints)) < len(checkpoints):  # sorted: 5, 5, 12
        assert (gE[0] == gE[1]).all()


def test_bpr_stage_errors_by_hand():
    """Stage i's decisions carried left through levels i-1 .. 0, one plane
    at a time, give the batched snapshot's count."""
    rng = np.random.default_rng(0)
    n, B, N = 3, 5, 8
    state = torch.as_tensor(rng.standard_normal((2 * (n + 1), B, N)),
                            dtype=torch.float32)
    I = torch.tensor([3, 5, 6, 7])
    true = torch.as_tensor(rng.integers(0, 2, (B, 4)), dtype=torch.int8)
    want = []
    for i in range(n + 1):
        b = (state[i] + state[n + 1 + i] < 0).to(torch.int8)
        for k in range(i - 1, -1, -1):
            d = 1 << k
            v = b.reshape(B, N // (2 * d), 2, d).clone()
            v[:, :, 0] ^= v[:, :, 1]
            b = v.reshape(B, N)
        want.append(int((b[:, I] != true).sum()))
    assert bpr_stage_errors(state, I, true).tolist() == want


def _parse_golden():
    txt = open(GOLDEN).read()
    rows = re.findall(r"After\s+(\d+) iterations:\n([\d.\t]+)\n", txt)
    E = {int(it): np.array([float(v) for v in vals.split()]) for it, vals in rows}
    return E, int(re.search(r"error block = (\d+)", txt).group(1))


def test_bpr_golden_float64():
    """The float64 check of tests/test_bpr_golden.py on the port: BPr_128.c
    with seed 1024, 300 frames at 2.0 dB, the C's Ranq1 noise; each table
    entry within 0.2 and the block errors within 3 (non-converged BP
    trajectories are chaotic under last-ulp differences)."""
    E_ref, errblock_ref = _parse_golden()
    N, K, frames, snr = 128, 64, 300, 2.0
    sigma = 10.0 ** (-snr / 20.0)
    I = info_set(N, K)
    u = np.zeros((frames, N), np.int8)
    for f in range(frames):
        u[f, I] = payload_bits_host(f, K)
    x = encode_dense(u, dense_generator(N))
    y = (1.0 - 2.0 * x.astype(np.float64)) + golden_noise(1024, frames, N, sigma)
    llr = torch.as_tensor(2.0 * y / sigma / sigma, dtype=torch.float64)
    u_hat, E = bpr_decode(llr, torch.as_tensor(frozen_mask(N, K)),
                          torch.as_tensor(u), torch.as_tensor(I), iters=90,
                          checkpoints=CHECKPOINTS)
    E = E.numpy() / frames
    for row, it in enumerate(CHECKPOINTS):
        np.testing.assert_allclose(E[row], E_ref[it], atol=0.2,
                                   err_msg=f"checkpoint {it}")
    errblock = int((u_hat.numpy()[:, I] != u[:, I]).any(axis=1).sum())
    assert abs(errblock - errblock_ref) <= 3


def test_bpr_step_and_point_equal_jax():
    """make_bpr_step's counters and E, and run_bpr_point's result and E
    summed in int64, equal to JAX's on BPr_128 at batch 64."""
    sigma = 10.0 ** (-2.0 / 20.0)
    key = jax.random.fold_in(jax.random.PRNGKey(1024), 200)
    want = jh.make_bpr_step(jcfg.preset("BPr_128"), 64)(key, jnp.int32(64), sigma)
    got = th.make_bpr_step(tcfg.preset("BPr_128"), 64, "cpu")(
        fold_in(prng_key(1024), 200), 64, sigma)
    assert [int(v) for v in got[:2]] == [int(v) for v in want[:2]]
    assert (got[2].numpy() == np.asarray(want[2])).all()
    wr, wE = jh.run_bpr_point(jcfg.preset("BPr_128"), 2.0, batch=64,
                              error_blocks=10)
    gr, gE = th.run_bpr_point(tcfg.preset("BPr_128"), 2.0, batch=64,
                              device="cpu", error_blocks=10)
    fields = lambda r: (r.errbit, r.errblock, r.frames, r.seed)  # noqa: E731
    assert fields(gr) == fields(wr) and gr.frames > 64
    assert gE.dtype == np.int64 and (gE == wE).all()


def test_cli_bpr_equals_jax(capsys):
    argv = ["bpr", "--snr", "2.0", "--batch", "64", "--error-blocks", "6",
            "--seed", "7"]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert list(got) == ["2.0"] and got["2.0"]["checkpoints"] == list(CHECKPOINTS)


def test_frame_step_refuses_a_bpr_preset():
    with pytest.raises(ValueError, match="make_bpr_step"):
        th.make_frame_step(tcfg.preset("BPr_128"), 8, "cpu")


@pytest.mark.parametrize("checkpoints,iters,segments", [
    (CHECKPOINTS, 90, [3, 3, 4, 10, 20, 40, 10]), ((5, 5, 12), 12, [5, 7]),
    ((0, 10, 95), 90, [10, 85])])
def test_bpr_advances_in_segments_and_never_by_zero(monkeypatch, checkpoints,
                                                    iters, segments):
    """bpr_decode advances through bp_wave (on the card one kernel launch a
    call) once a non-empty segment: BPr_128's 90 iterations are 7 launches,
    and a repeated checkpoint, one at 0 or one at the end adds none;
    chip_smoke's count of them agrees."""
    from polardecoding_tpu_torch.models import bp as tbp

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    seen = []
    plain = tbp.bp_wave

    def counted(state, iters, flavor, engine):
        seen.append(iters)
        return plain(state, iters, flavor, engine)

    monkeypatch.setattr(tbp, "bp_wave", counted)
    llr, frozen, u, I = _frames(16, 4, 2.0, 1)
    bpr_decode(torch.as_tensor(llr), torch.as_tensor(frozen), torch.as_tensor(u),
               torch.as_tensor(I), iters=iters, checkpoints=checkpoints)
    assert seen == segments
    assert chip_smoke.bpr_segments(checkpoints, iters) == segments
