"""The port's SC, SCL and CA-SCL decoders against the JAX package's on the CPU:
the compact-state phases, u_all, path metrics and tie counters bit-equal,
the CA-SCL selection, and the SC/SCL/CA-SCL frame steps and run_point with
the same counters, pm_ties included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.models import _compact as jcompact
from polardecoding_tpu.models import scl as jscl
from polardecoding_tpu.models.sc import sc_decode as jax_sc_decode
from polardecoding_tpu.ops.crc import (
    CRC6_EXPONENTS,
    CRC24_EXPONENTS,
    check_matrix,
    crc_encode_multiplicative,
)
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.utils.sequences import frozen_mask
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.models import _compact as tcompact
from polardecoding_tpu_torch.models import scl as tscl
from polardecoding_tpu_torch.models.sc import sc_decode
from polardecoding_tpu_torch.ops import scl_kernel
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel import harness as th

# the MIXED32 mask of tests/test_scl_fast.py: R0, REP, SPC and mixed nodes
MIXED32 = np.array(
    [1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0], bool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain decoders run thousands of small tensor operations, for which
    intra-op threads cost far more than they give (a 1024-bit frame step
    takes seconds on one thread, tens of seconds on eight)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _llr(B, N, seed):
    return (np.random.default_rng(seed).normal(size=(B, N)) * 3).astype(np.float32)


def _jax_scl(llr, frozen, L, **kw):
    out = jscl.scl_decode(jnp.asarray(llr), jnp.asarray(frozen), list_size=L,
                          return_all=True, return_ties=True, **kw)
    return [np.asarray(x) for x in out]


def _port_scl(llr, frozen, L, **kw):
    out = tscl.scl_decode(torch.as_tensor(llr), torch.as_tensor(frozen),
                          list_size=L, return_all=True, return_ties=True, **kw)
    return [x.numpy() for x in out]


def _assert_same(got, want):
    u, pm, ties = got
    assert u.dtype == np.int8 and pm.dtype == np.float32 and ties.dtype == np.int32
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g == w).all()


@pytest.mark.parametrize("lead", [(3,), (3, 4)])
def test_compact_phases_equal_jax_for_every_t(lead):
    """llr_phase and bit_phase at N=16 for every t, on random compact state,
    for SC's [B] and SCL's [B, L] leading shapes."""
    N, n = 16, 4
    rng = np.random.default_rng(len(lead))
    llr_c = (rng.normal(size=lead + (N - 1,)) * 3).astype(np.float32)
    bits_c = rng.integers(0, 2, lead + (N - 1,)).astype(np.int8)
    ch = (rng.normal(size=lead + (N,)) * 3).astype(np.float32)
    u = rng.integers(0, 2, lead).astype(np.int8)
    for t in range(n + 1):
        want = np.asarray(jcompact.llr_phase(jnp.asarray(llr_c), jnp.asarray(bits_c),
                                             jnp.asarray(ch), t, n))
        got = tcompact.llr_phase(torch.as_tensor(llr_c.copy()),
                                 torch.as_tensor(bits_c), torch.as_tensor(ch), t, n)
        assert (got.numpy() == want).all(), t
        want = np.asarray(jcompact.bit_phase(jnp.asarray(bits_c), jnp.asarray(u), t, n))
        got = tcompact.bit_phase(torch.as_tensor(bits_c.copy()), torch.as_tensor(u), t, n)
        assert (got.numpy() == want).all(), t
    assert [tcompact.ntz(j | N) for j in range(4)] == [4, 0, 1, 0]
    assert tcompact.slot(3) == jcompact.slot(3)


@pytest.mark.parametrize("frozen,L,B", [
    (MIXED32, 4, 32),
    (np.random.default_rng(11).random(32) < 0.5, 8, 16),
    *[(frozen_mask(128, 64), L, B)
      for L, B in [(1, 32), (2, 32), (4, 16), (8, 16), (32, 4)]],
    (frozen_mask(1024, 512), 8, 4),
])
def test_scl_bit_equal_to_jax(frozen, L, B):
    frozen = np.asarray(frozen)
    llr = _llr(B, len(frozen), seed=L)
    launches = scl_kernel.LAUNCHES
    _assert_same(_port_scl(llr, frozen, L), _jax_scl(llr, frozen, L))
    assert scl_kernel.LAUNCHES == launches  # a CPU tensor takes the plain path


def test_scl_forced_ties_and_strict_median():
    """Symmetric +-1 LLRs force exact PM ties at the median: the tie counter
    is non-zero and equal to JAX's, in both selection policies."""
    fr = np.asarray(frozen_mask(32, 20))
    llr = np.tile(np.array([1.0, -1.0] * 16, np.float32), (32, 1))
    want = _jax_scl(llr, fr, 4)
    assert want[2].sum() > 0
    _assert_same(_port_scl(llr, fr, 4), want)
    _assert_same(_port_scl(llr, fr, 4, strict_median=True),
                 _jax_scl(llr, fr, 4, strict_median=True))
    # on tie-free frames the strict policy changes nothing
    llr = _llr(16, 32, seed=3)
    _assert_same(_port_scl(llr, fr, 8, strict_median=True), _jax_scl(llr, fr, 8))


def test_scl_u_hat_and_ties_returns():
    fr = frozen_mask(128, 64)
    llr = _llr(8, 128, seed=2)
    want_u, want_t = jscl.scl_decode(jnp.asarray(llr), jnp.asarray(fr), list_size=4,
                                     return_ties=True)
    got_u, got_t = tscl.scl_decode_auto(torch.as_tensor(llr), torch.as_tensor(fr),
                                        list_size=4, return_ties=True)
    assert (got_u.numpy() == np.asarray(want_u)).all()
    assert (got_t.numpy() == np.asarray(want_t)).all()
    got_u2 = tscl.scl_decode(torch.as_tensor(llr), torch.as_tensor(fr), list_size=4)
    assert (got_u2.numpy() == np.asarray(want_u)).all()


@pytest.mark.parametrize("N", [128, 1024])
def test_sc_equal_to_jax_and_to_scl_at_l1(N):
    fr = frozen_mask(N, N // 2)
    llr = _llr(16, N, seed=N)
    want = np.asarray(jax_sc_decode(jnp.asarray(llr), jnp.asarray(fr)))
    got = sc_decode(torch.as_tensor(llr), torch.as_tensor(fr)).numpy()
    assert got.dtype == np.int8 and (got == want).all()
    auto = tscl.sc_decode_auto(torch.as_tensor(llr), torch.as_tensor(fr)).numpy()
    assert (auto == want).all()
    assert (_port_scl(llr, fr, 1)[0][:, 0] == want).all()


@pytest.mark.parametrize("exponents,K", [(CRC6_EXPONENTS, 64),
                                         (CRC24_EXPONENTS, 512)])
def test_cascl_select_equal_to_jax(exponents, K):
    """Paths that pass the CRC, paths that fail, frames where none pass, and
    equal PMs among the passers."""
    r = max(exponents)
    N, B, L = 2 * K, 12, 8
    rng = np.random.default_rng(K)
    info = np.sort(rng.choice(N, K + r, replace=False))
    u_all = rng.integers(0, 2, (B, L, N)).astype(np.int8)
    msgs = rng.integers(0, 2, (B * L, K)).astype(np.int8)
    cws = np.asarray(crc_encode_multiplicative(jnp.asarray(msgs), exponents))
    passing = rng.random((B, L)) < 0.3
    passing[:3] = False
    flat = u_all.reshape(B * L, N)
    sel = passing.reshape(-1)
    flat[np.ix_(sel, info)] = cws[sel]
    PM = rng.integers(0, 4, (B, L)).astype(np.float32)
    R = check_matrix(exponents, K + r)
    want_u, want_ok = jscl.cascl_select(jnp.asarray(u_all), jnp.asarray(PM),
                                        info, R)
    got_u, got_ok = tscl.cascl_select(torch.as_tensor(u_all), torch.as_tensor(PM),
                                      torch.as_tensor(info), R)
    assert (got_ok.numpy() == np.asarray(want_ok)).all()
    assert 0 < got_ok.numpy().sum() < B
    assert (got_u.numpy() == np.asarray(want_u)).all()


# (preset, batch, snr_db): low SNR so that the counters are informative;
# N=1024 only at a small batch, where each plain CPU decode is cheap
STEP_CASES = [("SCL_128_L8", 64, 1.0), ("CASCL_128_L8", 64, 1.0),
              ("SCL_128_fag_L8", 64, 1.0), ("SC_128", 64, 1.5),
              ("SCL_1024_L8", 8, 1.0), ("CASCL_1024_sys_L8", 8, 1.0)]


@pytest.mark.parametrize("name,batch,snr_db", STEP_CASES)
def test_frame_step_counters_equal_jax(name, batch, snr_db):
    sigma = 10.0 ** (-snr_db / 20.0)
    want = [int(v) for v in jh.make_frame_step(jcfg.preset(name), batch)(
        jax.random.PRNGKey(9), jnp.int32(batch), jnp.float32(sigma))]
    assert want[1] > 0
    launches = scl_kernel.LAUNCHES
    got = [int(v) for v in th.make_frame_step(tcfg.preset(name), batch, "cpu")(
        prng_key(9), batch, sigma)]
    assert got == want
    assert scl_kernel.LAUNCHES == launches


def test_run_point_equals_jax_scl():
    kw = dict(batch=64, error_blocks=4, max_frames=1 << 20)
    want = jh.run_point(jcfg.preset("SCL_128_L8"), 1.5, sync_every=1, **kw)
    got = th.run_point(tcfg.preset("SCL_128_L8"), 1.5, device="cpu", **kw)
    d = {k: v for k, v in vars(got).items() if k != "elapsed_s"}
    assert d == {k: v for k, v in vars(want).items() if k != "elapsed_s"}
    assert got.errblock >= 4 and got.frames % 64 == 0


def test_scl_routes():
    """A CPU tensor runs the plain version, engine="plain" forces it, the
    kernel's wrapper refuses a CPU tensor rather than falling back, unknown
    engines raise, and the rate-1 presets build a CPU frame step (the plain
    flavor) with plausible counters."""
    fr = torch.as_tensor(frozen_mask(32, 16))
    llr = torch.as_tensor(_llr(4, 32, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        scl_kernel.scl_decode_cuda(llr, fr, 4)
    with pytest.raises(ValueError):
        tscl.scl_decode_auto(llr, fr, engine="jnp")
    a = tscl.scl_decode_auto(llr, fr, list_size=4, engine="plain")
    b = tscl.scl_decode_auto(llr, fr, list_size=4)
    assert (a == b).all()
    assert (tscl.sc_decode_auto(llr, fr, engine="plain")
            == tscl.sc_decode_auto(llr, fr)).all()
    with pytest.raises(ValueError, match="CUDA"):
        scl_kernel.scl_decode_cuda(llr, fr, 4, r1=4)
    launches = (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1)
    for name in ("SCL_1024_L8_FASTR1", "CASCL_1024_L8_FASTR1"):
        step = th.make_frame_step(tcfg.preset(name), 4, "cpu")
        eb, ebl, ties = (int(c) for c in step(prng_key(9), 0, 10.0 ** -0.05))
        assert 0 <= ebl <= 4 and eb >= ebl and 0 <= ties <= 4
    assert (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1) == launches


def test_cli_run_takes_cascl(capsys):
    """`cli run` (run_sweep -> run_point -> the CA-SCL frame step) needs no
    change of its own: its record equals JAX's run_point at sync_every=1."""
    import json

    from polardecoding_tpu_torch import cli as tcli

    tcli.main(["run", "--preset", "CASCL_128_L8", "--snr", "1.0",
               "--error-blocks", "3", "--batch", "64", "--device", "cpu"])
    (rec,) = json.loads(capsys.readouterr().out)
    want = jh.run_point(jcfg.preset("CASCL_128_L8"), 1.0, batch=64,
                        error_blocks=3, sync_every=1)
    assert [rec[k] for k in ("errbit", "errblock", "frames", "pm_ties")] == [
        want.errbit, want.errblock, want.frames, want.pm_ties]
