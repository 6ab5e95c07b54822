"""Port ops against the JAX package on the CPU: CHK/PHI, encoders, the
threefry generator, normals and the AWGN channel."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu.ops import channel as jch
from polardecoding_tpu.ops import chk as jchk
from polardecoding_tpu.ops import encode as jenc
from polardecoding_tpu.ops import noise as jnoise
from polardecoding_tpu.utils.sequences import info_set
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.ops import chk as tchk
from polardecoding_tpu_torch.ops import encode as tenc
from polardecoding_tpu_torch.ops import noise as tnoise

EDGES = [0.196, 0.433, 0.71, 1.05, 1.508, 2.252, 4.5, 0.0]


def _operands(dtype, size=4096, seed=5):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=size) * 4).astype(dtype)
    b = (rng.normal(size=size) * 4).astype(dtype)
    # exact bin-edge values of |a+b| and |a-b| (b = 0), and signed zeros
    a[:8], b[:8] = EDGES, 0.0
    a[8:16], b[8:16] = EDGES, 1.0
    a[16], b[16] = -0.0, 0.0
    return a, b


def _jax(fn, *args, dtype):
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(fn(*(jnp.asarray(x) for x in args)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["chk", "chk_fast"])
def test_chk_bit_equal(name, dtype):
    a, b = _operands(dtype)
    got = getattr(tchk, name)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = _jax(getattr(jchk, name), a, b, dtype=dtype)
    assert got.dtype == want.dtype
    assert (got == want).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lut_and_phi_bit_equal(dtype):
    a, _ = _operands(dtype)
    x = np.abs(a)
    assert (tchk.lut_correction(torch.as_tensor(x)).numpy()
            == _jax(jchk.lut_correction, x, dtype=dtype)).all()
    for u in (0, 1):
        got = tchk.phi_penalty(torch.as_tensor(a), u).numpy()
        assert (got == _jax(lambda l: jchk.phi_penalty(l, u), a, dtype=dtype)).all()
    p0, p1 = tchk.phi_penalties_both(torch.as_tensor(a))
    w0, w1 = _jax(lambda l: jnp.stack(jchk.phi_penalties_both(l)), a, dtype=dtype)
    assert (p0.numpy() == w0).all() and (p1.numpy() == w1).all()


def test_chk_exact_matches_boxplus():
    """The SPA box-plus goes through exp and log1p, which each framework takes
    from its own math library, so it is held to the exact function: float64
    to 1e-12 and float32 to 4e-6 absolute, a few float32 ulps of the
    operands' scale (|a|, |b| < 20 here), against the exact function of the
    same float32 operands."""
    a, b = _operands(np.float64, size=2000)
    want = 2 * np.arctanh(np.tanh(a / 2) * np.tanh(b / 2))
    got64 = tchk.chk_exact(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got64, want, rtol=0, atol=1e-12)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    got32 = tchk.chk_exact(torch.as_tensor(a32), torch.as_tensor(b32)).numpy()
    a64, b64 = a32.astype(np.float64), b32.astype(np.float64)
    want32 = 2 * np.arctanh(np.tanh(a64 / 2) * np.tanh(b64 / 2))
    np.testing.assert_allclose(got32, want32, rtol=0, atol=4e-6)


@pytest.mark.parametrize("N", [8, 128, 1024])
def test_encoders_bit_equal(N):
    rng = np.random.default_rng(N)
    I = info_set(N, N // 2)
    w = rng.integers(0, 2, (6, N // 2)).astype(np.int8)
    u = np.array(jenc.scatter_info(jnp.asarray(w), jnp.asarray(I), N))
    assert (tenc.scatter_info(torch.as_tensor(w), torch.as_tensor(I, dtype=torch.int64),
                              N).numpy() == u).all()
    x = np.asarray(jenc.polar_encode(jnp.asarray(u)))
    assert (tenc.polar_encode(torch.as_tensor(u)).numpy() == x).all()
    g = torch.as_tensor(tenc.info_sub_generator(I, N).astype(np.float32))
    mxu = tenc.encode_info_mxu(torch.as_tensor(w), g).numpy()
    jmxu = np.asarray(jenc.encode_info_mxu(jnp.asarray(w),
                                           jenc.info_sub_generator(I, N)))
    assert mxu.dtype == np.float32 and (mxu == jmxu).all() and (mxu == x).all()


def test_threefry2x32_bit_equal():
    rng = np.random.default_rng(11)
    k0, k1, x0, x1 = (rng.integers(0, 2 ** 32, 512, dtype=np.uint64)
                      for _ in range(4))
    want = jnoise.threefry2x32(*(jnp.asarray(v.astype(np.uint32))
                                 for v in (k0, k1, x0, x1)))
    got = tnoise.threefry2x32(*(torch.as_tensor(v.astype(np.int64))
                                for v in (k0, k1, x0, x1)))
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()


FRAMES = np.array([0, 1, 2, 63, 1000, 65535, 2 ** 19 + 7, 2 ** 20 - 1, 2 ** 20])


@pytest.mark.parametrize("seed", [0, 7, 1024])
def test_keys_and_bits_bit_equal_to_jax(seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 200)
    tkey = tch.fold_in(tch.prng_key(seed), 200)
    assert (tkey.numpy() == np.asarray(jkey).astype(np.int64)).all()
    jkeys = jch.frame_keys(jkey, jnp.asarray(FRAMES, jnp.int32))
    tkeys = tch.frame_keys(tkey, torch.as_tensor(FRAMES))
    assert (tkeys.numpy() == np.asarray(jkeys).astype(np.int64)).all()
    jbits = jax.vmap(lambda k: jax.random.bits(k, (1024,), jnp.uint32))(jkeys)
    assert (tch.random_bits(tkeys, 1024).numpy()
            == np.asarray(jbits).astype(np.int64)).all()


def test_normals_bit_equal_to_jax():
    """jax.random.normal's normals, bit for bit: the uniform step, then
    XLA's erf_inv with its log1p and the FMAs its compiled code has."""
    key = jax.random.PRNGKey(1024)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(512))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (1024,), jnp.float32))(keys))
    got = tch.normal(tch.frame_keys(tch.prng_key(1024), torch.arange(512)),
                     1024).numpy()
    assert got.dtype == np.float32
    assert (got == want).all()
    bits = tch.random_bits(tch.frame_keys(tch.prng_key(1024), torch.arange(4)),
                           1024)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (1024,), jnp.float32, np.nextafter(np.float32(-1), np.float32(0)),
        1.0))(keys[:4]))
    assert (tnoise.uniform_jax(bits).numpy() == ju).all()


@pytest.mark.parametrize("name", ["log1p", "log", "erf_inv"])
def test_transcendentals_bit_equal_to_xla(name):
    """XLA's float32 log1p, log and erf_inv, jitted and eager, on the
    domains the channel uses."""
    x = -np.random.default_rng(0).uniform(0, 1, 1 << 15).astype(np.float32)
    x[:3] = (0.0, -0.41421357, -0.41421354)  # the log1p branch edge
    jfn, tfn, arg = {"log1p": (jnp.log1p, tnoise.log1p_f32, x),
                     "log": (jnp.log, tnoise.log_f32, 1.0 + x),
                     "erf_inv": (jax.lax.erf_inv, tnoise.erfinv_f32, x)}[name]
    got = tfn(torch.as_tensor(arg)).numpy()
    assert (got == np.asarray(jax.jit(jfn)(jnp.asarray(arg)))).all()
    assert (got == np.asarray(jfn(jnp.asarray(arg)))).all()


def test_fma_and_sqrt_correctly_rounded():
    """fma rounds a*b + c once (checked with exact rationals, including
    sums that land on float32 rounding ties in float64), and sqrt_f32 is
    the correctly rounded root (numpy's)."""
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=2000).astype(np.float32) for _ in range(2))
    c = (rng.normal(size=2000) * 0.5).astype(np.float32)
    # a*b + c exactly halfway between two float32 values: b = 1 + 2^-23,
    # a = 1, c = 2^-24 puts a*b + c at 1 + 1.5 * 2^-23
    a[0], b[0], c[0] = 1.0, np.float32(1 + 2 ** -23), np.float32(2 ** -24)
    got = tnoise.fma(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        g = np.float32(got[i])
        near = [np.nextafter(g, np.float32(-np.inf)), g,
                np.nextafter(g, np.float32(np.inf))]
        # nearest float32 to the exact sum, ties to the even mantissa
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(v.view(np.int32)) & 1))
        assert best == g, i
    w = rng.uniform(0, 50, 1 << 16).astype(np.float32)
    assert (tnoise.sqrt_f32(torch.as_tensor(w)).numpy() == np.sqrt(w)).all()


def _gaussian_eager(bits):
    """The in-kernel Gaussian from the port's primitives with a multiply and
    an add per Giles step, as the JAX function runs op by op."""
    x = tnoise.uniform_pm1_from_bits(bits)
    w = -tnoise.log_f32((1.0 - x) * (1.0 + x))
    lt = w < 5.0
    ws = torch.where(lt, w - 2.5, tnoise.sqrt_f32(w) - 3.0)
    p = tnoise._select(lt, tnoise._W_LT5[0], tnoise._W_GE5[0])
    for a, b in zip(tnoise._W_LT5[1:], tnoise._W_GE5[1:]):
        p = tnoise._select(lt, a, b) + p * ws
    return tnoise.SQRT2 * (p * x)


@pytest.mark.parametrize("jit", [False, True])
def test_gaussian_from_bits_bit_equal_to_jax_package(jit):
    """The JAX package's in-kernel Gaussian, bit-equal: as jax.jit compiles
    it, where XLA's x86 CPU code fuses each polynomial step into an FMA, to
    the port's gaussian_from_bits (the form its MC engines use); eagerly, as
    its ops run one by one, to the same primitives stepped with a multiply
    and an add (the two forms differ on about 4% of samples).  Uniforms
    bit-equal too."""
    bits = np.random.default_rng(2).integers(0, 2 ** 32, 1 << 16, dtype=np.uint64)
    fn = jax.jit(jnoise.gaussian_from_bits) if jit else jnoise.gaussian_from_bits
    want = np.asarray(fn(jnp.asarray(bits.astype(np.uint32))))
    tbits = torch.as_tensor(bits.astype(np.int64))
    got = (tnoise.gaussian_from_bits if jit else _gaussian_eager)(tbits).numpy()
    assert (got == want).all()
    u = tnoise.uniform_pm1_from_bits(torch.as_tensor(bits.astype(np.int64))).numpy()
    assert (u == np.asarray(jnoise.uniform_pm1_from_bits(
        jnp.asarray(bits.astype(np.uint32))))).all()


def test_awgn_llr_bit_equal_to_jax():
    """LLRs equal the JAX package's channel as XLA compiles it inside a
    jitted step, where the noise term and the BPSK symbol meet in one FMA
    (run op by op, JAX rounds there twice)."""
    sigma = 10.0 ** (-2.0 / 20.0)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2, (64, 256)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 200)
    want = np.asarray(jax.jit(jch.awgn_llr)(
        jnp.asarray(x), jch.frame_keys(key, jnp.arange(64)), jnp.float32(sigma)))
    got = tch.awgn_llr(torch.as_tensor(x),
                       tch.frame_keys(tch.fold_in(tch.prng_key(7), 200),
                                      torch.arange(64)), sigma).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (got == want).all()
    assert tch.sigma_from_ebn0_db(2.0) == pytest.approx(sigma)
    assert (tch.bpsk(torch.tensor([0, 1])).numpy() == [1.0, -1.0]).all()
