"""The port's BP wave engines against the JAX package's on the CPU: the wave
steps', MC steps' and MC-channel frame step's counters, run_point on an
early-stop preset and a run_sweep resume equal to JAX's; the MC engine's
census, drain and determinism; the CLI on an early-stop preset.  Most of
the time goes to the JAX package's traces and compiles of its engines."""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.ops import bp_wave_kernel, bp_wave_mc_kernel
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel import harness as th

SIGMA_2DB = float(np.float32(10.0 ** (-2.0 / 20.0)))


def _steps(init, step, drain, key, sigma, n_steps, batch):
    carry = init(key, 0, sigma)
    rows = []
    for _ in range(n_steps):
        carry, out = step(key, sigma, carry)
        rows.append([int(v) for v in out])
    tail, rem, rounds = [0, 0, 0], batch, 0
    while rem > 0:
        carry, out = drain(sigma, carry)
        out = [int(v) for v in out]
        tail = [a + b for a, b in zip(tail, out[:3])]
        rem, rounds = out[3], rounds + 1
        assert rounds < 100, "drain did not terminate"
    return rows, tail, carry


def test_wave_step_counters_equal_jax():
    """make_wave_step's per-step counters and drain totals equal to JAX's,
    fused (check_every 0 and 1) and unfused (BP_128, B=64, six steps); fused
    and unfused per-step counters equal each other, as the JAX package's
    test_wave_fused_step_matches_unfused holds for its own."""
    jp, tp = jcfg.preset("BP_128"), tcfg.preset("BP_128")
    jkey = jax.random.PRNGKey(jp.sweep.seed)
    rows = {}
    for fused, ce in ((False, 0), (True, 0), (True, 1)):
        want = _steps(*jh.make_wave_step(jp, batch=64, wave_iters=8, fused=fused,
                                         check_every=ce), jkey,
                      jnp.float32(SIGMA_2DB), 6, 64)
        got = _steps(*th.make_wave_step(tp, 64, 8, "cpu", fused=fused,
                                        check_every=ce),
                     prng_key(jp.sweep.seed), SIGMA_2DB, 6, 64)
        assert got[:2] == want[:2], (fused, ce)
        rows[fused, ce] = got[0]
    assert rows[False, 0] == rows[True, 0]
    assert sum(r[2] for r in rows[True, 0]) > 64


def _float_bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("check_every", [0, 1])
def test_fused_drain_holds_the_dead_slots(monkeypatch, check_every):
    """make_wave_step's fused drain on the CPU (BP_128, B=64, after six
    steps): each call gives the wave the live mask fidx >= 0, taken after
    the pending retirees are killed, and leaves every dead slot's state as
    it was, bit for bit; call by call its (errbit, errblock, frames,
    remaining), fidx, iters_done and live slots' state equal those of the
    same drain with every slot run, which changes the dead slots' state."""
    tp = tcfg.preset("BP_128")
    init, step, drain = th.make_wave_step(tp, 64, 8, "cpu",
                                          check_every=check_every)
    key = prng_key(tp.sweep.seed)
    carry = init(key, 0, SIGMA_2DB)
    for _ in range(6):
        carry, _ = step(key, SIGMA_2DB, carry)
    fused = th.bp_wave_fused

    def drained(hold):
        """[(out, fidx, iters_done, live given, state in, state out)]"""
        given = []

        def wave(state, *args, live=None, **kw):
            given.append((live, state.clone()))
            return fused(state, *args, live=live if hold else None, **kw)

        monkeypatch.setattr(th, "bp_wave_fused", wave)
        c, calls, rem = tuple(t.clone() for t in carry), [], 64
        while rem > 0:
            c, out = drain(SIGMA_2DB, c)
            calls.append(([int(v) for v in out], c[1], c[2], *given[-1], c[0]))
            rem = int(out[3])
            assert len(calls) < 20, "drain did not terminate"
        return calls

    held, run = drained(True), drained(False)
    assert len(held) == len(run) > 1
    fidx = torch.where(carry[4], -1, carry[1])
    mixed, moved = 0, 0
    for h, r in zip(held, run):
        live = h[3]
        assert torch.equal(live, fidx >= 0) and torch.equal(r[3], live)
        assert h[0] == r[0] and torch.equal(h[1], r[1])
        assert torch.equal(h[2], r[2])
        assert torch.equal(_float_bits(h[5][:, ~live]),
                           _float_bits(h[4][:, ~live]))
        assert torch.equal(_float_bits(h[5][:, live]),
                           _float_bits(r[5][:, live]))
        mixed += bool(live.any() and not live.all())
        moved += not torch.equal(r[5][:, ~live], r[4][:, ~live])
        fidx = h[1]
    assert mixed and moved


def test_wave_step_mc_counters_equal_jax():
    """make_wave_step_mc(noise="threefry") draws jax.random.bits, as the JAX
    package's make_wave_step_mc does on the CPU: equal per-step counters and
    drain totals."""
    # BP_128_FASTCHK's decoder on an N=32 code keeps the JAX trace small
    jp, tp = (dataclasses.replace(cfg.preset("BP_128_FASTCHK"),
                                  code=cfg.CodeConfig(32, 16))
              for cfg in (jcfg, tcfg))
    want = _steps(*jh.make_wave_step_mc(jp, 32, wave_iters=4, cadence=2),
                  jax.random.PRNGKey(3), jnp.float32(SIGMA_2DB), 5, 32)
    got = _steps(*th.make_wave_step_mc(tp, 32, 4, "cpu", noise="threefry",
                                       cadence=2),
                 prng_key(3), SIGMA_2DB, 5, 32)
    assert got[:2] == want[:2]
    assert sum(r[1] for r in want[0]) > 0


def test_frame_step_mc_channel_counters_equal_jax():
    """make_frame_step(channel="mc", noise="threefry") counters equal to the
    JAX package's channel="mc" step on the CPU, both counted over all N."""
    key = jax.random.PRNGKey(4)
    for frame_start in (0, 640):
        want = [int(v) for v in jh.make_frame_step(
            jcfg.preset("BP_128"), 64, channel="mc")(
                key, jnp.int32(frame_start), jnp.float32(SIGMA_2DB))]
        got = [int(v) for v in th.make_frame_step(
            tcfg.preset("BP_128"), 64, "cpu", channel="mc", noise="threefry")(
                prng_key(4), frame_start, SIGMA_2DB)]
        assert got == want and want[1] > 0


def _fields(res):
    d = dict(vars(res))
    d.pop("elapsed_s")
    return d


def test_run_point_early_stop_preset_equals_jax():
    """run_point sends BP_1024_ES to run_point_waves, as the JAX package's
    does: the same chunks, lookahead and drain give an equal PointResult."""
    kw = dict(batch=8, error_blocks=4, max_frames=32)
    want = jh.run_point(jcfg.preset("BP_1024_ES"), 2.0, **kw)
    launches = dict(bp_wave_kernel.LAUNCHES)
    got = th.run_point(tcfg.preset("BP_1024_ES"), 2.0, device="cpu", **kw)
    assert bp_wave_kernel.LAUNCHES == launches
    assert _fields(got) == _fields(want)
    assert got.frames > 32 and got.pm_ties == 0


def _es(cfg, name):
    """BP_128 with early stop on: an N=128 early-stop preset in either
    package."""
    p = cfg.preset("BP_128")
    return dataclasses.replace(p, name=name, decoder=dataclasses.replace(
        p.decoder, bp_early_stop=True))


def test_run_sweep_resume_on_wave_engine_equals_jax(tmp_path):
    """A checkpoint record resumes on the wave engine in the port's
    run_sweep as in the JAX package's: the point restarts at the recorded
    frame count and the two give equal records."""
    kw = dict(batch=32, snr_points=[2.5], max_frames=1 << 20)
    first = dict(preset="BP_128_ES", snr_db=2.5, errbit=61, errblock=5,
                 frames=320, bler=5 / 320, ber=61 / 320 / 64, seed=1024,
                 elapsed_s=0.0, pm_ties=0)
    ck, ck_port = tmp_path / "ck.json", tmp_path / "ck_port.json"
    ck.write_text(json.dumps([first]))
    shutil.copy(ck, ck_port)
    target = first["errblock"] + 3
    want = jh.run_sweep(_es(jcfg, "BP_128_ES"), error_blocks=target,
                        checkpoint_path=str(ck), **kw)
    got = th.run_sweep(_es(tcfg, "BP_128_ES"), device="cpu", error_blocks=target,
                       checkpoint_path=str(ck_port), **kw)
    assert first["frames"] < got[0].frames
    assert _fields(got[0]) == _fields(want[0])
    assert json.loads(ck_port.read_text())[0]["errblock"] >= target


def test_mc_census_and_drain():
    """Every frame put in flight is counted once across steps and drain:
    the drain ends with every slot dead (the port of test_wave_mc.py's
    check)."""
    p = tcfg.preset("BP_128_FASTCHK")
    B = 32
    launches = bp_wave_mc_kernel.LAUNCHES
    rows, tail, carry = _steps(*th.make_wave_step_mc(p, B, 4, "cpu"),
                               prng_key(3), float(np.float32(10 ** (-3 / 20))),
                               6, B)
    assert bp_wave_mc_kernel.LAUNCHES == launches
    assert all(r[1] <= r[2] for r in rows)
    fr = sum(r[2] for r in rows) + tail[2]
    ebl = sum(r[1] for r in rows) + tail[1]
    eb = sum(r[0] for r in rows) + tail[0]
    assert int(carry[1][3, :, 0].sum()) == B
    assert fr >= B and ebl <= fr and eb <= fr * p.code.num_info


def test_mc_determinism_and_mid_wave_retirement():
    """Two runs give the same counters; at 5 dB a wave of K=8 retires more
    than one frame per slot, which only mid-wave refills allow."""
    p = tcfg.preset("BP_128_FASTCHK")
    B = 64

    def run(snr):
        init, step, _ = th.make_wave_step_mc(p, B, 8, "cpu")
        sigma = float(np.float32(10 ** (-snr / 20)))
        carry = init(prng_key(11), 0, sigma)
        out = []
        for _ in range(3):
            carry, o = step(prng_key(11), sigma, carry)
            out.append([int(v) for v in o])
        return out

    assert run(2.0) == run(2.0)
    assert run(5.0)[1][2] > B


def test_wave_paths_reject_what_they_do_not_take():
    p = tcfg.preset("BP_128")
    with pytest.raises(ValueError, match="check_every"):
        th.make_wave_step(p, 8, device="cpu", fused=False, check_every=2)
    with pytest.raises(ValueError, match="BP engine"):
        th.make_wave_step(tcfg.preset("SC_128"), 8, device="cpu")
    with pytest.raises(ValueError, match="noise"):
        th.make_wave_step_mc(p, 8, device="cpu", noise="hw")
    with pytest.raises(ValueError, match="wave engine"):
        th.run_point_waves(p, 2.0, batch=8, device="cpu", engine="jnp")
    state = tbp.wave_init_state(torch.zeros(8, 128), torch.zeros(128, dtype=torch.bool))
    meta = tbp.mc_meta_init(8, 128, 64)
    tabs = tbp.mc_tables(np.arange(64, 128), 64, 128)
    with pytest.raises(ValueError, match="tf32"):
        tbp.bp_wave_mc(state, meta, *tabs, 0.8, (0, 0, 0, 0), bit_gen="hw")
    with pytest.raises(ValueError, match="CUDA"):
        bp_wave_kernel.bp_wave_cuda(state)
    with pytest.raises(ValueError, match="CUDA"):
        bp_wave_mc_kernel.bp_wave_mc_cuda(state, meta, *tabs, 0.8, (0, 0, 0, 0))


def test_cli_runs_early_stop_preset(capsys):
    """cli run --preset BP_1024_ES goes through run_sweep to the wave
    engine."""
    tcli.main(["run", "--preset", "BP_1024_ES", "--snr", "2.0", "--batch", "8",
               "--error-blocks", "2", "--max-frames", "8", "--device", "cpu"])
    (rec,) = json.loads(capsys.readouterr().out)
    assert rec["preset"] == "BP_1024_ES" and rec["frames"] > 8
    assert rec["pm_ties"] == 0 and 0 <= rec["bler"] < 1
