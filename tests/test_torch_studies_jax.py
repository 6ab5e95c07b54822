"""The port's hardware studies on the CPU at small sizes against the JAX
package on the same frames: bler_r1's exact arm against JAX's run_point
and its rate-1 arm against JAX's with the numpy twin tests/scl_fast_ref.py
as its kernel; bler_wavemc's arms against JAX's run_point_waves; the parity
studies' frames and records against JAX's decoders; the tie study against
the script's JAX generator, scl_decode in both policies and cascl_select;
bf16_study's arms against the script's own run_arm; precision part 1's C
arm against the JAX package's native.golden_mc; and the STUDY_PINS that
cost seconds recomputed with JAX.  Counters are equal, tolerance 0.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scl_fast_ref import decode_batch

from polardecoding_tpu import native as jnative
from polardecoding_tpu.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu.configs import preset as jpreset
from polardecoding_tpu.models import bp as jbp
from polardecoding_tpu.models import scl as jscl
from polardecoding_tpu.ops.channel import awgn_llr as jawgn_llr
from polardecoding_tpu.ops.crc import check_matrix, crc_encode_multiplicative
from polardecoding_tpu.ops.encode import polar_encode, scatter_info
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.utils.pn import pn_sequence
from polardecoding_tpu_torch import studies as S
from polardecoding_tpu_torch.configs import preset as tpreset
from polardecoding_tpu_torch.models import scl as tscl
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.studies import (
    _common,
    bf16_study,
    scl_parity_hw,
    tie_impact_study,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain decoders run thousands of small tensor operations, for which
    intra-op threads cost far more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """scripts/<name>.py as a module, the environment it sets put back."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "scripts", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def _study(name, tmp_path, **kw):
    return S.run_study(name, str(tmp_path), device="cpu", log=None,
                       commit="test", **kw)


@pytest.fixture
def jax_twin_kernel(monkeypatch):
    """The JAX package's SCL dispatch with the numpy twin as its kernel, so
    that its run_point decodes the rate-1 flavor on the CPU, where it would
    decode exact."""
    def kernel(ch_llr, frozen, list_size, r1=0):
        B, N = ch_llr.shape
        fr = np.asarray(frozen, bool)
        wloop = jscl.default_wloop(N.bit_length() - 1, list_size)
        out = (jax.ShapeDtypeStruct((B, list_size, N), jnp.int8),
               jax.ShapeDtypeStruct((B, list_size), jnp.float32),
               jax.ShapeDtypeStruct((B,), jnp.int32))
        return jax.pure_callback(
            lambda llr: decode_batch(np.asarray(llr), fr, list_size,
                                     wloop=wloop, r1min=r1), out, ch_llr)

    monkeypatch.setattr(jscl, "_pallas_ok", lambda *a, **k: True)
    monkeypatch.setattr(jscl, "_scl_kernel", kernel)


def test_bler_r1_arms_equal_jax(tmp_path, jax_twin_kernel):
    """Both arms of a case at batch 32: the exact arm's counts are JAX's
    run_point's, the rate-1 arm's JAX's with the twin as its kernel."""
    lines = _study("bler_r1", tmp_path, cases=[("SCL_128_L8", 1.5, 256)],
                   error_blocks=6, batch=32)
    assert [x.get("preset") for x in lines] == ["SCL_128_L8",
                                                "SCL_128_L8_FASTR1", None]
    for x in lines[:2]:
        want = jh.run_point(jpreset(x["preset"]), 1.5, batch=32, error_blocks=6,
                            max_frames=256, sync_every=1)
        assert [x[k] for k in ("errbit", "errblock", "frames", "pm_ties")] == [
            want.errbit, want.errblock, want.frames, want.pm_ties]
        assert x["errblock"] >= 6 and x["launches"] == {}
    assert lines[2]["verdict"] == "OK" and lines[2]["tpu"]["verdict"] == "OK"


def test_r1_twin_leaves_the_preset_table():
    from polardecoding_tpu_torch.configs import PRESETS
    from polardecoding_tpu_torch.studies import bler_r1

    before = dict(PRESETS)
    assert bler_r1.r1_twin("SCL_1024_L8", 2) is PRESETS["SCL_1024_L8_FASTR1"]
    twin = bler_r1.r1_twin("SCL_128_L16", 4)
    assert (twin.name, twin.decoder.scl_r1, twin.decoder.list_size) == (
        "SCL_128_L16_FASTR1", 4, 16)
    assert PRESETS == before


@pytest.mark.parametrize("engine,kw", [
    ("fused", dict(engine="fused")),
    ("mc-tf", dict(engine="mc", noise="threefry"))])
def test_wave_arms_equal_jax(tmp_path, engine, kw):
    """The fused and mc-tf arms against JAX's run_point_waves (the mc arm's
    counter words are the TPU kernel's, which JAX draws only on a TPU: off
    it, noise="kernel" is its threefry)."""
    lines = _study("bler_wavemc", tmp_path, snrs=[2.0], preset_name="BP_128",
                   engines=[engine], batch=32, error_blocks=4, mc_k=4)
    x = lines[0]
    want = jh.run_point_waves(jpreset("BP_128"), 2.0, batch=32,
                              wave_iters=8 if engine == "fused" else 4,
                              error_blocks=4, max_frames=200_000_000, **kw)
    assert [x[k] for k in ("errbit", "errblock", "frames")] == [
        want.errbit, want.errblock, want.frames]
    assert x["tpu"] is None and lines[1][f"ratios_vs_{engine}"] == {engine: 1.0}


def test_parity_frames_and_records_equal_jax(tmp_path):
    """The studies' frames are the port's frame channel of the script's
    payloads and keys, the frame step's form (bit-equal to JAX's awgn_llr
    under jit with sigma an argument); on them the port's SCL and
    early-stop BP equal JAX's decoders, and the CPU records are bit-equal."""
    script = _script("scl_parity_hw")
    for ncode, frames, snr in ((128, 16, 2.0), (1024, 4, 1.5)):
        p = jpreset(f"SCL_{ncode}_L8")
        fidx = jnp.arange(frames, dtype=jnp.int32)
        code = p.code
        x = polar_encode(scatter_info(
            jh.payload_from_index(fidx, jnp.asarray(pn_sequence()), code.K),
            jnp.asarray(code_info_set(code)), code.N))
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1024),
                                                     i))(fidx)
        want = jax.jit(jawgn_llr)(x, keys, jnp.float32(10.0 ** (-snr / 20.0)))
        got = scl_parity_hw.channel_llrs(tpreset(p.name), frames, snr, "cpu")
        assert (got.numpy() == np.asarray(want)).all()
        # the script's own (eager) frames carry the same payloads and noise
        eager = np.asarray(script.channel_llrs(p, frames, snr))
        assert np.abs(eager - got.numpy()).max() <= 1e-4 * np.abs(eager).max()
        if ncode != 128:
            continue
        fr = np.asarray(code_frozen_mask(code))
        ju, jpm = jscl.scl_decode(jnp.asarray(got.numpy()), jnp.asarray(fr),
                                  list_size=8, return_all=True)
        tu, tpm = tscl.scl_decode(got, torch.as_tensor(fr), list_size=8,
                                  return_all=True)
        assert (tu.numpy() == np.asarray(ju)).all()
        assert (tpm.numpy() == np.asarray(jpm)).all()
    lines = _study("scl_parity_hw", tmp_path, frames=4, flavors=True)
    assert len(lines) == 7 and not scl_parity_hw.checks(lines)
    assert lines[-1]["bit_identical_vs_twin"] and lines[-1]["tpu"][
        "bit_identical_vs_twin"]
    assert all(x["tpu"]["max_pm_err"] == 0.0 for x in lines[:6])
    p = tpreset("BP_128")
    llr = scl_parity_hw.channel_llrs(p, 16, 2.5, "cpu")
    from polardecoding_tpu_torch.models.bp import bp_decode

    fr = np.asarray(code_frozen_mask(p.code))
    want = jbp.bp_decode(jnp.asarray(llr.numpy()), jnp.asarray(fr), iters=100,
                         early_stop_every=4)
    got = bp_decode(llr, torch.as_tensor(fr), iters=100, early_stop_every=4)
    assert (got.numpy() == np.asarray(want)).all()


def test_const_sigma_channel_equals_jax_closure():
    """awgn_llr_const_sigma is JAX's awgn_llr jitted with sigma a constant
    of the function (the tie script's generator), not the frame step's."""
    B, N, sigma = 64, 128, 10.0 ** (-2.0 / 20.0)
    x = np.random.default_rng(3).integers(0, 2, (B, N)).astype(np.int8)
    fidx = np.arange(B)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1024), i))(
        jnp.asarray(fidx, jnp.int32))
    s = jnp.float32(sigma)
    want = jax.jit(lambda x, k: jawgn_llr(x, k, s))(jnp.asarray(x), keys)
    keys_t = tch.fold_in(tch.prng_key(1024), torch.as_tensor(fidx))
    got = tch.awgn_llr_const_sigma(torch.as_tensor(x), keys_t, sigma)
    assert (got.numpy() == np.asarray(want)).all()
    assert (tch.awgn_llr(torch.as_tensor(x), keys_t, sigma).numpy()
            != np.asarray(want)).any()


def _jax_tie(name, snr, frames, batch):
    """tie_impact_study.py:50-101 on `name`: each batch's counters."""
    p = jpreset(name)
    code, L = p.code, p.decoder.list_size
    frozen = jnp.asarray(code_frozen_mask(code))
    I = np.asarray(code_info_set(code))
    R = check_matrix(code.crc, code.num_info)
    pn = jnp.asarray(pn_sequence())
    key = jax.random.PRNGKey(p.sweep.seed)
    sigma = jnp.float32(10.0 ** (-snr / 20.0))

    @jax.jit
    def gen(fidx):
        w = crc_encode_multiplicative(jh.payload_from_index(fidx, pn, code.K),
                                      code.crc)
        x = polar_encode(scatter_info(w, jnp.asarray(I), code.N))
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        return jawgn_llr(x, keys, sigma), w

    @functools.partial(jax.jit, static_argnames=("strict",))
    def decode(llr, strict):
        u_all, PM, ties = jscl.scl_decode(llr, frozen, list_size=L,
                                          return_all=True, return_ties=True,
                                          strict_median=strict)
        return jscl.cascl_select(u_all, PM, tuple(I), R)[0], ties

    rows, tie_frames, blk_d, blk_s, differs = [], 0, 0, 0, 0
    for done in range(0, frames, batch):
        llr, w = gen(done + jnp.arange(batch, dtype=jnp.int32))
        ud, ties = decode(llr, False)
        us, ties2 = decode(llr, True)
        assert bool(jnp.all(ties == ties2))
        bad_d = np.asarray(jnp.any(ud[:, I] != w, axis=-1))
        bad_s = np.asarray(jnp.any(us[:, I] != w, axis=-1))
        tie_frames += int((np.asarray(ties) > 0).sum())
        blk_d += int(bad_d.sum())
        blk_s += int(bad_s.sum())
        differs += int((bad_d != bad_s).sum())
        rows.append([done + batch, tie_frames, blk_d, blk_s, differs,
                     int((np.asarray(ud) != np.asarray(us)).any(axis=-1).sum())])
    return rows


def test_tie_study_equals_the_script_with_jax(tmp_path):
    """CASCL_128_L8 at 1.0 dB, 64 frames in batches of 32: every running
    line equal to the script's loop run with JAX."""
    lines = _study("tie_impact_study", tmp_path, preset_name="CASCL_128_L8",
                   snr=1.0, frames=64, batch=32)
    want = _jax_tie("CASCL_128_L8", 1.0, 64, 32)
    got = [[x[k] for k in ("frames", "tie_frames", "blk_default", "blk_strict",
                           "outcome_differs", "decoded_bits_differ")]
           for x in lines[:-1]]
    assert got == want and want[-1][2] > 0
    final = lines[-1]
    assert (final["frames"], final["blk_default"]) == (64, want[-1][2])
    assert final["tpu"] is None and final["launches"] == {}


def test_bf16_arms_equal_the_script(tmp_path):
    """Part 2's arms at batch 32 against the script's run_arm with JAX (the
    jnp engine): the float32 and bfloat16 counts equal."""
    script = _script("bf16_study")
    lines = _study("bf16_study", tmp_path, blocks=6, part1=[],
                   points=[("BP_128", 2.0, 32, 4096)])
    got = {x["dtype"]: x for x in lines if "dtype" in x}
    for dtype, jdtype in (("f32", None), ("bfloat16", jnp.bfloat16)):
        want = script.run_arm("BP_128", 2.0, jdtype, 6, 32, 4096)
        assert want["dtype"] == dtype
        assert (got[dtype]["errblock"], got[dtype]["frames"]) == (
            want["errblock"], want["frames"])
    assert got["bfloat16"]["engine"] == "plain"
    ratio = lines[-1]["bler_ratio_bf16_over_f32"]
    assert ratio == got["bfloat16"]["bler"] / got["f32"]["bler"]


def test_c_arm_equals_the_jax_package_native(tmp_path):
    """Part 1's C arm (chunks under seeds C_SEED + c, two threads) counts
    what the JAX package's native.golden_mc counts on the same chunks."""
    lines = _study("bf16_study", tmp_path, blocks=3, points=[],
                   part1=[("SC_128", 3.0, 64, 4096)], c_chunk=128, c_workers=2)
    c = lines[0]
    info = np.asarray(code_info_set(jpreset("SC_128").code))
    eb = ebl = 0
    for k in range(c["chunks"]):
        a, b, _ = jnative.golden_mc(128, 64, info, bf16_study.C_SEED + k, 3.0, 128,
                                    decoder="sc")
        eb, ebl = eb + a, ebl + b
    assert (c["errbit"], c["errblock"], c["frames"]) == (eb, ebl, 128 * c["chunks"])
    assert c["threads"] == 2 and c["chunks"] % 2 == 0 and c["errblock"] >= 3


@pytest.mark.parametrize("pin", ["bler_r1_exact", "bf16_f32", "bf16_bfloat16"])
def test_pins_recomputed_with_jax(pin):
    """The pins that cost seconds, from the JAX package's frame step on the
    CPU (bler_r1_fastr1, the twin on 8192 frames, costs about a minute)."""
    want = _common.STUDY_PINS[pin]
    p = jpreset(want["preset"])
    sigma = jnp.float32(10.0 ** (-want["snr_db"] / 20.0))
    if pin.startswith("bler_r1"):
        step = jh.make_frame_step(p, want["batch"])
        key = jax.random.fold_in(jax.random.PRNGKey(p.sweep.seed),
                                 int(round(want["snr_db"] * 100)))
    else:
        step = jh.make_frame_step(
            p, want["batch"], llr_dtype=jnp.bfloat16 if pin == "bf16_bfloat16"
            else None, bp_engine="jnp")
        key = jax.random.PRNGKey(p.sweep.seed)
    got = tuple(int(v) for v in step(key, jnp.int32(0), sigma))
    assert got == want["counts"]
