"""ROADMAP queue A's drivers on the CPU at small sizes against the JAX
package on the same frames: the ab_chkfast study's BP_128 pair against
JAX's run_point_waves; torch_verify_drive --fast at reduced frames against
JAX's run_point; make_wave_step(check_every=c) for each of ab_wavecheck's
cadences against JAX's.  Counters are equal, tolerance 0.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from polardecoding_tpu.configs import preset as jpreset
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.parallel.mesh import data_mesh
from polardecoding_tpu_torch import studies as S
from polardecoding_tpu_torch.configs import preset as tpreset
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel.harness import make_wave_step
from polardecoding_tpu_torch.studies import ab_chkfast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def one():
    """A one-device mesh: the port's one process (the counts do not depend
    on the mesh, and JAX compiles for one device, not eight, here)."""
    return data_mesh(jax.devices()[:1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain decoders run thousands of small tensor operations, for which
    intra-op threads cost far more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_chkfast_arms_equal_jax(tmp_path, monkeypatch, one):
    """BP_128 and BP_128_FASTCHK through the study's BLER phase (fused wave
    engine, K=8) at batch 32 to one error block: each arm's counters are
    JAX's run_point_waves'."""
    monkeypatch.setattr(ab_chkfast, "BASES", ("BP_128",))
    lines = S.run_study("ab_chkfast", str(tmp_path), device="cpu", log=None,
                        commit="test", perf=False, bler=True, bler_snr=2.0,
                        error_blocks=1, batch=32)
    assert [x.get("preset") for x in lines] == ["BP_128", "BP_128_FASTCHK", None]
    for x in lines[:2]:
        want = jh.run_point_waves(jpreset(x["preset"]), 2.0, batch=32,
                                  error_blocks=1,
                                  max_frames=ab_chkfast.MAX_FRAMES, mesh=one)
        assert [x[k] for k in ("errbit", "errblock", "frames")] == [
            want.errbit, want.errblock, want.frames]
    assert tpreset("BP_128_FASTCHK").decoder.bp_flavor == "minsum_lut_fast"


def test_verify_fast_checks_equal_jax(tmp_path, one):
    """torch_verify_drive --fast at 64 frames a check: each check's counts
    are JAX's run_point's at the same settings (batch min(4096, frames),
    error_blocks 10**9)."""
    v = _script("torch_verify_drive")
    rc = v.main(["--device", "cpu", "--fast", "--max-frames", "64",
                 "--out", str(tmp_path)])
    lines = _lines(tmp_path / "verify_drive.jsonl")
    assert rc == (0 if lines[-1]["verify"] == "PASS" else 1)
    checks = [x for x in lines if "check" in x]
    assert [x["check"] for x in checks] == [c[0] for c in v.CHECKS]
    for x in checks:
        want = jh.run_point(jpreset(x["check"]), x["snr_db"], batch=64,
                            error_blocks=10**9, max_frames=64, mesh=one)
        assert [x[k] for k in ("errbit", "errblock", "frames", "pm_ties")] == [
            want.errbit, want.errblock, want.frames, want.pm_ties]
        assert x["jax_cpu"] is None and x["tpu"] is None


def test_wavecheck_cadences_equal_jax(one):
    """make_wave_step(check_every=c) for each of ab_wavecheck's cadences on
    BP_128 at batch 8, K=8, 2.0 dB: two steps' counters equal JAX's."""
    c = _script("torch_ab_wavecheck")
    sigma = 10.0 ** (-2.0 / 20.0)
    p, jp = tpreset("BP_128"), jpreset("BP_128")
    key, jkey = prng_key(p.sweep.seed), jax.random.PRNGKey(jp.sweep.seed)
    for ce in c.CES:
        init, step, _ = make_wave_step(p, 8, wave_iters=8, device="cpu",
                                       check_every=ce)
        jinit, jstep, _ = jh.make_wave_step(jp, 8, wave_iters=8, mesh=one,
                                            check_every=ce)
        carry = init(key, 0, sigma)
        jcarry = jinit(jkey, jnp.int32(0), jnp.float32(sigma))
        for _ in range(2):
            carry, out = step(key, sigma, carry)
            jcarry, jout = jstep(jkey, jnp.float32(sigma), jcarry)
            assert [int(o) for o in out] == [int(o) for o in jout], ce
