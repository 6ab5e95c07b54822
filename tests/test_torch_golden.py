"""Golden mode of the port: the reference's noise stream (utils/rng.py), the
port's ctypes wrapper of the C engine (native.py, native/golden_ref.c built
into polardecoding_tpu_torch/_build/) and the port's decoders, frame by
frame against the C reference.

- Ranq1, MarsagliaNormal and the three noise functions bit-equal to the JAX
  package's (several seeds, odd N) and to the C engine's noise;
- the port's golden_mc / golden_mc_list equal to the JAX package's native
  engine on SC, BP, SCL and CA-SCL at N=128;
- the five C frame dumps of tests/golden through the port's plain decoders
  (chip_smoke's golden_fixture_results on the CPU): U and y bit-equal, H
  equal on every frame, BP on the 5 frames C decoded right;
- N=1024, K=512, 2.0 dB against the C engine (chip_smoke's
  golden_engine_results on the CPU): no frame differs, and both sides count
  the same error blocks.

The comparisons are exact: no tolerance.  The cuda-marked test decodes the
fixtures through the kernels on a card and skips here; on a GPU machine,
which has no jax:

  python -m pytest --noconftest -q -m cuda tests/test_torch_golden.py
"""
import os

import numpy as np
import pytest
import torch

try:
    from polardecoding_tpu import native as jnative
    from polardecoding_tpu.utils import rng as jrng
except ImportError:  # a GPU machine: only the cuda-marked test runs there
    jrng = None

import chip_smoke
from polardecoding_tpu_torch import native
from polardecoding_tpu_torch.ops.crc import CRC6_EXPONENTS
from polardecoding_tpu_torch.utils import rng
from polardecoding_tpu_torch.utils.sequences import info_set

try:
    native.golden_noise(1, 1, 8, 1.0)
    HAVE_NATIVE = True
except Exception:  # pragma: no cover - no compiler in env
    HAVE_NATIVE = False

needs_native = pytest.mark.skipif(not HAVE_NATIVE, reason="no C compiler")
needs_jax = pytest.mark.skipif(jrng is None, reason="needs the JAX package")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (1, 1024, 2024, 2**63 + 5)


@needs_jax
@pytest.mark.parametrize("seed", SEEDS)
def test_ranq1_and_marsaglia_equal_jax(seed):
    ours, theirs = rng.Ranq1(seed), jrng.Ranq1(seed)
    for _ in range(300):
        assert ours.next_u64() == theirs.next_u64()
        assert ours.uniform() == theirs.uniform()
    ours, theirs = rng.MarsagliaNormal(seed), jrng.MarsagliaNormal(seed)
    for sigma in (0.5, 0.8912509381337456, 1.0):
        for _ in range(200):
            assert ours.pair(sigma) == theirs.pair(sigma)


@needs_jax
@pytest.mark.parametrize("seed,frames,N", [(1024, 3, 128), (7, 4, 33),
                                           (2**63 + 5, 2, 1), (2024, 5, 1024)])
def test_noise_functions_equal_jax(seed, frames, N):
    sigma = 10.0 ** (-1.5 / 20.0)
    scalar = rng.golden_noise_scalar(seed, frames, N, sigma)
    np.testing.assert_array_equal(
        scalar, jrng.golden_noise_scalar(seed, frames, N, sigma))
    fast = rng.golden_noise(seed, frames, N, sigma)
    assert fast.dtype == np.float64 and fast.shape == (frames, N)
    np.testing.assert_array_equal(fast, scalar)
    np.testing.assert_array_equal(fast, jrng.golden_noise(seed, frames, N, sigma))
    for count, lanes in ((0, 512), (1, 512), (1000, 64), (4099, 512)):
        np.testing.assert_array_equal(
            rng.ranq1_uniform_block(seed, count, lanes),
            jrng.ranq1_uniform_block(seed, count, lanes))
    block = rng.ranq1_uniform_block(seed, 64)
    r = rng.Ranq1(seed)
    np.testing.assert_array_equal(block, [r.uniform() for _ in range(64)])


@needs_jax
def test_leapfrog_helpers_equal_jax():
    cols = rng._xorshift_cols()
    np.testing.assert_array_equal(cols, jrng._xorshift_cols())
    for k in (0, 1, 5, 512, 8192):
        np.testing.assert_array_equal(rng._mat_power(cols, k),
                                      jrng._mat_power(cols, k))
    v = np.arange(1, 100, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(rng._mat_apply(cols, v), jrng._mat_apply(cols, v))
    np.testing.assert_array_equal(rng._mat_compose(cols, cols),
                                  jrng._mat_compose(cols, cols))


@needs_native
@pytest.mark.parametrize("seed,frames,N", [(2024, 6, 128), (1024, 3, 1024),
                                           (5, 4, 33)])
def test_noise_equals_c_engine(seed, frames, N):
    sigma = 10.0 ** (-2.0 / 20.0)
    np.testing.assert_array_equal(native.golden_noise(seed, frames, N, sigma),
                                  rng.golden_noise(seed, frames, N, sigma))


@needs_native
def test_native_builds_into_the_port(monkeypatch, tmp_path):
    """The wrapper compiles native/golden_ref.c as it is into the port's
    _build/ (here redirected to a scratch directory), never into
    native/build/, and rebuilds when the source is newer."""
    pkg = os.path.join(REPO, "polardecoding_tpu_torch")
    assert native._SRC == os.path.join(REPO, "native", "golden_ref.c")
    assert native._BUILD == os.path.join(pkg, "_build")
    assert os.path.dirname(native._LIB) == native._BUILD
    lib = tmp_path / "libgolden_ref.so"
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    out = native.golden_noise(3, 2, 8, 1.0)
    assert lib.exists() and os.listdir(tmp_path) == [lib.name]
    np.testing.assert_array_equal(out, rng.golden_noise(3, 2, 8, 1.0))
    os.utime(lib, (0, 0))  # older than the source: built again
    monkeypatch.setattr(native, "_lib", None)
    native._load()
    assert lib.stat().st_mtime > 0


def test_native_unavailable_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="C compiler"):
        native.golden_noise(1, 1, 8, 1.0)


@needs_native
def test_native_refuses_a_wrong_info_set():
    I = info_set(128, 64)
    with pytest.raises(ValueError):
        native.golden_mc(128, 63, I, 1, 1.0, 1)
    with pytest.raises(ValueError):
        native.golden_mc_list(128, 64, I, 1, 1.0, 1, crc_exponents=CRC6_EXPONENTS)


@needs_native
@needs_jax
@pytest.mark.parametrize("decoder,frames", [("sc", 256), ("bp", 64)])
def test_golden_mc_equals_jax(decoder, frames):
    I = info_set(128, 64)
    got = native.golden_mc(128, 64, I, 1024, 2.0, frames, decoder=decoder,
                           iters=50)
    want = jnative.golden_mc(128, 64, I, 1024, 2.0, frames, decoder=decoder,
                             iters=50)
    assert got[:2] == want[:2]
    assert got[2].dtype == np.int8 and got[2].shape == (frames, 64)
    np.testing.assert_array_equal(got[2], want[2])
    counts = native.golden_mc(128, 64, I, 1024, 2.0, frames, decoder=decoder,
                              iters=50, return_bits=False)
    assert counts == got[:2] + (None,)


@needs_native
@needs_jax
@pytest.mark.parametrize("crc", [None, CRC6_EXPONENTS])
def test_golden_mc_list_equals_jax(crc):
    I = info_set(128, 64 + (max(crc) if crc else 0))
    got = native.golden_mc_list(128, 64, I, 42, 1.5, 64, list_size=8,
                                crc_exponents=crc)
    want = jnative.golden_mc_list(128, 64, I, 42, 1.5, 64, list_size=8,
                                  crc_exponents=crc)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


@needs_jax
def test_fixtures_through_plain_decoders():
    """The C dumps on the CPU: the port's U and y bit-equal to every dump's,
    H equal on 8 of 8 frames (SC, SC_fag, SCL, CA-SCL) and, for BP, on the
    5 frames C decoded right; no kernel launched."""
    got = chip_smoke.golden_fixture_results("cpu")
    assert set(got) == {"sc", "sc_fag", "scl", "cascl", "bp"}
    for decoder, r in got.items():
        assert r["frames"] == r["u_equal"] == r["y_equal"] == 8, (decoder, r)
        assert r["launches"] == {}
        want = 5 if decoder == "bp" else 8
        assert r["h_equal"] == want, (decoder, r)
    assert got["bp"]["c_correct"] == got["bp"]["h_equal_on_c_correct"] == 5


@needs_native
def test_n1024_against_the_c_engine():
    """N=1024, K=512, 2.0 dB, seed 1024 at CPU sizes: SC 1024 frames, SCL
    (L=8) 128, CA-SCL (CRC-24, L=8) 64 and BP (100 iterations) 64; no frame
    differs from C's, and the error blocks are C's."""
    cases = (("sc", 1024, 0, None), ("scl", 128, 0, None),
             ("cascl", 64, 0, None), ("bp", 64, 0, None))
    got, seconds, noise_equal = chip_smoke.golden_engine_results("cpu", cases)
    assert noise_equal == chip_smoke.GOLDEN_NOISE_FRAMES and seconds > 0
    for decoder, frames, *_ in cases:
        r = got[decoder]
        assert r["frames"] == frames and r["differing"] == 0, (decoder, r)
        assert r["errblock"] == r["c_errblock"], (decoder, r)
        assert r["launches"] == {}
    assert got["sc"]["errblock"] > 0


def test_golden_code_and_words():
    """chip_smoke's golden frames: CA-SCL reserves K + r channels (CRC-6 at
    N=128, CRC-24 above) and its words pass the CRC; the payload repeats
    every 63 frames, which golden_y's encode relies on."""
    from polardecoding_tpu_torch.ops.crc import check_matrix, crc_passes

    for N, r in ((128, 6), (1024, 24)):
        frozen, info, exps = chip_smoke.golden_code("cascl", N, N // 2)
        assert len(info) == N // 2 + r == (~frozen).sum() and max(exps) == r
        w, u = chip_smoke.golden_words(70, N, N // 2, info, exps)
        assert bool(crc_passes(torch.as_tensor(w), check_matrix(exps, len(info))).all())
        np.testing.assert_array_equal(u[:, info], w)
        np.testing.assert_array_equal(u[63:], u[:7])
    frozen, info, exps = chip_smoke.golden_code("sc", 128, 64)
    assert exps is None and len(info) == 64


@pytest.mark.cuda
def test_fixtures_through_kernels_on_card():
    """On a card: the C dumps decoded by the kernels, H equal on every frame
    (BP: on the frames C decoded right), each decode one launch of its
    kernel and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    got = chip_smoke.golden_fixture_results("cuda")
    for decoder, r in got.items():
        assert r["launches"] == {r["kernel"]: 1}, (decoder, r)
        if decoder == "bp":
            assert r["h_equal_on_c_correct"] == r["c_correct"] == 5
        else:
            assert r["h_equal"] == r["frames"] == 8, (decoder, r)
