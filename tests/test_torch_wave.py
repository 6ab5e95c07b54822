"""The port's BP wave functions and MC channel against the JAX package's on
the CPU: the wave primitives, the fused wave, the MC wave and the MC channel
bit-equal to the JAX functions.  The engines built on them are held in
test_torch_wave_steps.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu.models import bp as jbp
from polardecoding_tpu.ops import noise as jnoise
from polardecoding_tpu.ops.pallas.channel_kernel import mc_channel_jnp
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.ops import bp_wave_kernel, channel_kernel
from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
from polardecoding_tpu_torch.parallel import harness as th

SIGMA_2DB = float(np.float32(10.0 ** (-2.0 / 20.0)))
FLAVORS = ("minsum_lut", "minsum_lut_fast")


def _t(a):
    return torch.as_tensor(np.array(a))


def _bits_equal(got, want):
    """Equal bit patterns (so -0.0 is not +0.0) of a port float32 tensor and
    a JAX array."""
    g, w = got.numpy(), np.asarray(want)
    return g.dtype == w.dtype and g.shape == w.shape and (
        g.view(np.int32) == w.view(np.int32)).all()


def _state(N, B, seed, iters=8):
    """JAX wave state after `iters` iterations on random LLRs, the frozen
    mask of the N/2-bit code, and more fresh LLRs."""
    rng = np.random.default_rng(seed)
    frozen = code_frozen_mask(jcfg.CodeConfig(N, N // 2))
    llr = (rng.normal(size=(B, N)) * 2.5 + 2.0).astype(np.float32)
    llr[0, :4] = (0.0, -0.0, 0.0, -0.0)  # signed zeros survive the merge
    fresh = (rng.normal(size=(B, N)) * 2.5 + 2.0).astype(np.float32)
    state = jbp.bp_wave_jnp(jbp.wave_init_state(jnp.asarray(llr),
                                                jnp.asarray(frozen)), iters=iters)
    return np.asarray(state), frozen, fresh, rng.random(B) < 0.5


@pytest.mark.parametrize("flavor", FLAVORS)
def test_wave_primitives_bit_equal_to_jax(flavor):
    """wave_init_state, bp_wave, wave_decide and wave_merge bit-equal to the
    JAX functions, on a CPU tensor through the plain versions."""
    _, frozen, llr, retire = _state(128, 32, seed=1, iters=0)
    jstate = jbp.wave_init_state(jnp.asarray(llr), jnp.asarray(frozen))
    state = tbp.wave_init_state(_t(llr), _t(frozen))
    assert _bits_equal(state, jstate)
    jstate = jbp.bp_wave_jnp(jstate, iters=8, flavor=flavor)
    launches = dict(bp_wave_kernel.LAUNCHES)
    state = tbp.bp_wave(state, iters=8, flavor=flavor)
    assert bp_wave_kernel.LAUNCHES == launches  # the CPU takes the plain path
    assert _bits_equal(state, jstate)
    ju, jdone = jbp.wave_decide(jstate, jnp.asarray(frozen))
    u, done = tbp.wave_decide(state, _t(frozen))
    assert (u.numpy() == np.asarray(ju)).all() and u.dtype == torch.int8
    assert (done.numpy() == np.asarray(jdone)).all() and 0 < done.sum() < 32
    merged = tbp.wave_merge(state, _t(llr), _t(retire))
    assert _bits_equal(merged, jbp.wave_merge(jstate, jnp.asarray(llr),
                                              jnp.asarray(retire)))


@pytest.mark.parametrize("N,B,check_every,flavor",
                         [(128, 32, ce, f) for ce in (0, 1, 4) for f in FLAVORS]
                         + [(1024, 8, 4, "minsum_lut")])
def test_wave_fused_bit_equal_to_jax(N, B, check_every, flavor):
    """merge -> K iterations -> decide, with the in-wave latch for
    check_every > 0: state, u_hat and done bit-equal to bp_wave_fused_jnp."""
    state, _, llr, retire = _state(N, B, seed=N + check_every)
    js, ju, jd = jbp.bp_wave_fused_jnp(jnp.asarray(state), jnp.asarray(llr),
                                       jnp.asarray(retire), iters=8,
                                       flavor=flavor, check_every=check_every)
    s, u, d = tbp.bp_wave_fused(_t(state), _t(llr), _t(retire), iters=8,
                                flavor=flavor, check_every=check_every)
    assert _bits_equal(s, js)
    assert u.dtype == torch.int8 and (u.numpy() == np.asarray(ju)).all()
    assert d.dtype == torch.bool and (d.numpy() == np.asarray(jd)).all()


@pytest.mark.parametrize("N,B,check_every,flavor",
                         [(128, 32, ce, f) for ce in (0, 4) for f in FLAVORS]
                         + [(1024, 8, 0, "minsum_lut")])
def test_wave_fused_live_mask_holds_the_dead_slots(N, B, check_every, flavor):
    """bp_wave_fused's live mask on the CPU (the plain version): with every
    slot live the output is the unmasked one bit for bit; with a mask, a
    slot neither live nor retired comes back with its state as it went in
    (-0.0 included), done False and u_hat 0, and every other slot, retired
    ones marked dead included, equals the unmasked run and
    bp_wave_fused_jnp's.  No kernel is launched or counted as masked."""
    state, _, llr, retire = _state(N, B, seed=3 * N + check_every)
    retire[:4] = (False, True, False, True)  # slot 3: retired, not live
    live = np.arange(B) % 3 != 0
    held = ~live & ~retire
    assert held[0] and held.sum() < B
    js, ju, jd = jbp.bp_wave_fused_jnp(jnp.asarray(state), jnp.asarray(llr),
                                       jnp.asarray(retire), iters=8,
                                       flavor=flavor, check_every=check_every)
    launches = dict(bp_wave_kernel.LAUNCHES), dict(bp_wave_kernel.MASKED)
    kw = dict(iters=8, flavor=flavor, check_every=check_every)
    unmasked = tbp.bp_wave_fused(_t(state), _t(llr), _t(retire), **kw)
    every = tbp.bp_wave_fused(_t(state), _t(llr), _t(retire),
                              live=torch.ones(B, dtype=torch.bool), **kw)
    s, u, d = tbp.bp_wave_fused(_t(state), _t(llr), _t(retire),
                                live=_t(live), **kw)
    assert (dict(bp_wave_kernel.LAUNCHES), dict(bp_wave_kernel.MASKED)) == launches
    assert _bits_equal(unmasked[0], js) and _bits_equal(every[0], js)
    for got in (unmasked, every):
        assert (got[1].numpy() == np.asarray(ju)).all()
        assert (got[2].numpy() == np.asarray(jd)).all()
    assert _bits_equal(s[:, held], state[:, held])
    assert (_bits_equal(s[:, ~held], np.asarray(js)[:, ~held])
            and not _bits_equal(s, js))
    assert u.dtype == torch.int8 and (u[held] == 0).all()
    assert (u[~held].numpy() == np.asarray(ju)[~held]).all()
    assert d.dtype == torch.bool and not d[held].any()
    assert (d[~held].numpy() == np.asarray(jd)[~held]).all()


# each cadence, spares count and noise source; each case costs two JAX
# compiles of the unrolled twin (drain off and on)
@pytest.mark.parametrize("cadence,spares,source",
                         [(1, 2, "counter"), (2, 4, "jax.random.bits")])
def test_wave_mc_bit_equal_to_jax(cadence, spares, source):
    """Five MC waves, the last in drain: state, meta and stats bit-equal to
    bp_wave_mc_jnp, fed the TPU kernel's counter words (which the port draws
    itself from the seeds) or jax.random.bits."""
    # an N=32 code keeps the JAX twin's unrolled trace small
    code = jcfg.CodeConfig(32, 16)
    N, K, B = 32, 16, 16
    I = code_info_set(code)
    frozen = code_frozen_mask(code)
    utab, xtab = jbp.mc_tables(I, K, N)
    tut, txt = tbp.mc_tables(I, K, N)
    assert (tut.numpy() == np.asarray(utab)).all()
    assert (txt.numpy() == np.asarray(xtab)).all()
    delta = jbp.mc_delta(B, K)
    assert tbp.mc_delta(B, K) == delta
    k0, k1 = 0x13198A2E, 0x03707344
    lanes = (np.arange(B)[:, None] * N + np.arange(N)).astype(np.uint32)
    kw = dict(iters=4, flavor="minsum_lut_fast", iter_max=12, delta=delta,
              spares=spares, cadence=cadence)
    js = jbp.wave_init_state(jnp.zeros((B, N), jnp.float32), jnp.asarray(frozen))
    jm = jbp.mc_meta_init(B, N, K)
    s = tbp.wave_init_state(torch.zeros(B, N), _t(frozen))
    m = tbp.mc_meta_init(B, N, K)
    assert _bits_equal(m, jm)
    retired = 0
    for step in range(5):
        seeds = (k0, k1, k0 ^ k1, step)
        if source == "counter":
            bits = jnp.stack([jnoise.threefry2x32(
                k0, k1, np.uint32(step * spares + g), lanes)[0]
                for g in range(spares)])
            tbits = None
        else:
            bits = jax.random.bits(jax.random.fold_in(
                jax.random.PRNGKey(7), step), (spares, B, N), jnp.uint32)
            tbits = _t(np.asarray(bits).astype(np.int64))
        js, jm, jst = jbp.bp_wave_mc_jnp(js, jm, utab, jnp.float32(SIGMA_2DB),
                                         bits, drain=step == 4, **kw)
        s, m, st = tbp.bp_wave_mc(s, m, tut, txt, SIGMA_2DB, seeds, tbits,
                                  gen_bits=tbits is None, drain=step == 4, **kw)
        assert _bits_equal(s, js), step
        assert _bits_equal(m, jm), step
        assert _bits_equal(st, jst), step
        retired += int(st[:, 2].sum())
    assert retired > B  # slots retired and refilled within waves


def test_mc_channel_bit_equal_to_jax_jit():
    """The MC channel's LLRs bit-equal to jax.jit(mc_channel_jnp) for the
    TPU kernel's counter words and for given words, with the tables of
    harness._mc_mode_tables equal to JAX's (CRC bits included)."""
    for name in ("BP_128", "CASCL_128_L8"):
        jut, jxt = jh._mc_mode_tables(jcfg.preset(name).code)
        ut, xt = th._mc_mode_tables(tcfg.preset(name).code, "cpu")
        assert (ut.numpy() == np.asarray(jut)).all()
        assert (xt.numpy() == np.asarray(jxt)).all()
    B, N = 48, 128
    m = (np.arange(B, dtype=np.int32) * 7 + 3) % 63
    k0, k1, step = 0xDEADBEEF, 12345, 4096
    lanes = (np.arange(B)[:, None] * N + np.arange(N)).astype(np.uint32)
    counter = jnoise.threefry2x32(k0, k1, np.uint32(step), lanes)[0]
    given = jax.random.bits(jax.random.PRNGKey(9), (B, N), jnp.uint32)
    jfn = jax.jit(mc_channel_jnp)
    launches = channel_kernel.LAUNCHES
    for bits, tbits in ((counter, None), (given, np.asarray(given).astype(np.int64))):
        want = jfn(jnp.asarray(m), jxt, jnp.float32(SIGMA_2DB), bits)
        got = mc_channel(torch.as_tensor(m), xt, SIGMA_2DB, (k0, k1, k0 ^ k1, step),
                         None if tbits is None else torch.as_tensor(tbits),
                         gen_bits=tbits is None)
        assert _bits_equal(got, want)
    assert channel_kernel.LAUNCHES == launches
    with pytest.raises(ValueError, match="tf32"):
        mc_channel(torch.as_tensor(m), xt, SIGMA_2DB, (0, 0, 0, 0), bit_gen="hw")
