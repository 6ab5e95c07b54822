"""The frame step's channel (ops/channel.frame_llr, csrc/frame_channel.cu)
against the JAX package on the CPU.

The kernel's plain versions: awgn_llr(x, frame_keys(key, fidx), sigma), and
awgn_llr_from_words for its `bits` mode, bit-equal to the JAX package's
jitted awgn_llr of frame_keys and to XLA's uniform map and erf_inv on chosen
words.  Off the card the dispatcher runs the plain version and never builds
or launches; the wrapper refuses what the kernel does not take.  The
cuda-marked tests hold the kernel (and the MC channel, which shares
csrc/noise.cuh and its tiling) against the plain versions on a card and
skip here; on a GPU machine, which has no jax:

  python -m pytest --noconftest -q -m cuda tests/test_torch_frame_channel.py
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu.ops import channel as jch
except ImportError:  # a GPU machine: only the cuda-marked tests run there
    jax = None

from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.ops import noise as tnoise
from polardecoding_tpu_torch.ops.frame_channel_kernel import frame_llr_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frame indices near the 32-bit edge; -1 and 2^32 - 1 give the same key
EDGE_FRAMES = [0, 1, 2 ** 31 - 3, 2 ** 31 - 1, 2 ** 31 + 1, 2 ** 32 - 2,
               2 ** 32 - 1]
CHOSEN_WORDS = [0, 0x1FF, 0x200, 0x7FFFFFFF, 0x80000000, 0xFFFFFE00,
                0xFFFFFFFF]
LO = np.float32(np.nextafter(np.float32(-1), np.float32(0)))


def _jax_uniform(bits):
    """jax.random.uniform's map of 32-bit words to [nextafter(-1, 0), 1)
    (jax._src.random._uniform), jitted."""
    one = jax.lax.bitwise_or(jax.lax.shift_right_logical(bits, jnp.uint32(9)),
                             jnp.uint32(0x3F800000))
    floats = jax.lax.bitcast_convert_type(one, jnp.float32) - jnp.float32(1)
    return jax.lax.max(LO, floats * (jnp.float32(1) - LO) + LO)


def _frames(B):
    rng = np.random.default_rng(B)
    return np.concatenate([EDGE_FRAMES,
                           rng.integers(0, 2 ** 32, B)])[:B].astype(np.int64)


@pytest.mark.parametrize("snr", [2.0, 6.0])
@pytest.mark.parametrize("N,B", [(64, 16), (1024, 4)])
def test_words_map_equals_awgn_llr_and_jax(N, B, snr):
    """awgn_llr_from_words of the frames' threefry words equals awgn_llr and
    the JAX package's jitted awgn_llr of frame_keys, bit for bit, with frame
    indices near 2^32 - 1."""
    if jax is None:
        pytest.skip("needs jax")
    sigma = tch.sigma_from_ebn0_db(snr)
    x = np.random.default_rng(N).integers(0, 2, (B, N)).astype(np.float32)
    fidx = _frames(B)
    key = tch.fold_in(tch.prng_key(1024), 200)
    keys = tch.frame_keys(key, torch.as_tensor(fidx))
    got = tch.awgn_llr_from_words(torch.as_tensor(x),
                                  tch.random_bits(keys, N), sigma).numpy()
    plain = tch.awgn_llr(torch.as_tensor(x), keys, sigma).numpy()
    jkey = jax.random.fold_in(jax.random.PRNGKey(1024), 200)
    want = np.asarray(jax.jit(lambda x, f, s: jch.awgn_llr(
        x, jch.frame_keys(jkey, f), s))(jnp.asarray(x),
                                         jnp.asarray(fidx.astype(np.uint32)),
                                         jnp.float32(sigma)))
    assert got.dtype == np.float32 and got.shape == (B, N)
    assert (got.view(np.int32) == plain.view(np.int32)).all()
    assert (got.view(np.int32) == want.view(np.int32)).all()


def _branch_edge_words():
    """Words whose uniform u puts u * -u on either side of log1p's branch
    edge, sqrt(2) - 1 in float32, for u of both signs."""
    f = np.arange(1 << 23, dtype=np.uint32)
    one = (f | np.uint32(0x3F800000)).view(np.float32)  # word f << 9
    u = np.maximum((one - np.float32(1)) * np.float32(2) + LO, LO)
    small = np.abs(u * -u) < np.float32(tnoise._LOG1P_SMALL)
    flips = np.flatnonzero(small[1:] != small[:-1])
    assert len(flips) == 2
    return [int(w) << 9 for i in flips for w in (i - 1, i, i + 1, i + 2)]


def test_words_map_on_chosen_words_equals_xla():
    """On chosen words (both ends of the uniform, the bits below bit 9 that
    it drops, the sign bit, the log1p branch edge) the plain uniform map
    equals XLA's jitted one, itself pinned to jax.random.uniform, and the
    plain erf_inv equals jax.lax.erf_inv, jitted and eager."""
    if jax is None:
        pytest.skip("needs jax")
    key = jax.random.PRNGKey(3)
    bits = jax.random.bits(key, (4096,), jnp.uint32)
    assert (np.asarray(jax.jit(_jax_uniform)(bits)) == np.asarray(
        jax.random.uniform(key, (4096,), jnp.float32, LO, 1.0))).all()
    words = np.array(CHOSEN_WORDS + _branch_edge_words(), np.int64)
    u = tnoise.uniform_jax(torch.as_tensor(words))
    ju = np.asarray(jax.jit(_jax_uniform)(jnp.asarray(words.astype(np.uint32))))
    assert (u.numpy().view(np.int32) == ju.view(np.int32)).all()
    got = tnoise.erfinv_f32(u).numpy()
    for fn in (jax.jit(jax.lax.erf_inv), jax.lax.erf_inv):
        want = np.asarray(fn(jnp.asarray(ju)))
        assert (got.view(np.int32) == want.view(np.int32)).all()


def test_frame_llr_off_the_card_never_builds_or_launches(monkeypatch):
    """frame_llr on a CPU tensor, with engine "auto" and "plain", and a CPU
    frame step, run the plain version: building or launching raises."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    def refuse(*args, **kwargs):
        raise AssertionError("built or launched a kernel off the card")

    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (8, 64)),
                        dtype=torch.float32)
    key, fidx = tch.prng_key(5), torch.as_tensor(_frames(8))
    want = tch.awgn_llr(x, tch.frame_keys(key, fidx), 0.8)
    for engine in ("auto", "plain"):
        got = tch.frame_llr(x, key, fidx, 0.8, engine=engine)
        assert (got.view(torch.int32) == want.view(torch.int32)).all()
    with pytest.raises(ValueError, match="engine"):
        tch.frame_llr(x, key, fidx, 0.8, engine="kernel")
    step = make_frame_step(preset("BP_128"), 4, "cpu")
    assert all(int(c) >= 0 for c in step(key, 0, 0.8))


@pytest.mark.parametrize("x,match", [
    (torch.zeros(4, 64), "CUDA"),
    (torch.zeros(4, 64, dtype=torch.float64), "float32"),
    (torch.zeros(64), "float32"),
    (torch.zeros(4, 48), "power of two"),
])
def test_frame_llr_cuda_refuses(x, match):
    """The wrapper raises on a CPU tensor, a wrong dtype or shape, and an N
    that is not a power of two; it never falls back to the plain version."""
    fidx = torch.zeros(x.shape[0], dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        frame_llr_cuda(x, tch.prng_key(1), fidx, 0.8)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_chip_smoke_frame_channel_work_by_hand():
    """chip_smoke's bound of the frame channel: bytes, operations and
    integer operations of B=2 frames of N=4 with 5 elements on log1p's
    rational branch and 1 on erf_inv's sqrt branch, counted by hand; and
    its branch counts on chosen words."""
    smoke = _chip_smoke()
    # 2 fold-ins and 8 blocks of 71 integer operations, 3 more an element,
    # 3 in each of the 3 logs
    int_ops = 2 * 71 + 8 * (71 + 3) + 3 * 3
    # 22 other operations an element, 18 a rational log1p, 24 a log, a sqrt
    ops = int_ops + 8 * 22 + 5 * 18 + 3 * 24 + 1
    assert smoke.frame_channel_work(2, 4, 5, 1) == (8 * 8 + 2 * 8 + 16, ops,
                                                    int_ops)
    # word 0: u = nextafter(-1, 0), a log and the sqrt branch; 0x80000000:
    # u = 2^-24, rational; 0xFFFFFFFF: u = 1 - 2^-23, a log and the sqrt
    # branch; bit 30 alone: u = 2^-24 - 0.5, rational
    words = torch.tensor([[0, 0x80000000], [0xFFFFFFFF, 0x40000000]])
    assert smoke.channel_branches(words) == (2, 2)


CARD_CASES = [(8, 33), (64, 33), (128, 512), (1024, 33), (2048, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,B", CARD_CASES)
def test_frame_channel_kernel_equals_plain_on_card(N, B):
    """On a card: the frame channel's LLRs bit-equal to the plain version's
    on every element, with threefry words (frame indices near 2^32 - 1 and
    -1, two point keys) and with given words; and the MC channel's, which
    shares the kernel's tiling, in both noise modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import channel_kernel, frame_channel_kernel

    rng = np.random.default_rng(N)
    x = torch.as_tensor(rng.integers(0, 2, (B, N)), dtype=torch.float32,
                        device="cuda")
    fidx = torch.as_tensor(np.concatenate([[-1], _frames(B - 1)]),
                           device="cuda")
    words = torch.as_tensor(rng.integers(0, 2 ** 32, (B, N)), device="cuda")
    launches = frame_channel_kernel.LAUNCHES
    for key in (tch.prng_key(0, "cuda"), tch.fold_in(tch.prng_key(7, "cuda"), 200)):
        for sigma in (0.3, 1.2):
            got = tch.frame_llr(x, key, fidx, sigma)
            want = tch.frame_llr(x, key, fidx, sigma, engine="plain")
            torch.cuda.synchronize()
            assert (got.view(torch.int32) == want.view(torch.int32)).all()
    got = frame_llr_cuda(x, None, None, 0.8, bits=words)
    want = tch.awgn_llr_from_words(x, words, 0.8)
    torch.cuda.synchronize()
    assert (got.view(torch.int32) == want.view(torch.int32)).all()
    assert frame_channel_kernel.LAUNCHES == launches + 5
    xtab = torch.as_tensor(rng.integers(0, 2, (128, N)), dtype=torch.float32,
                           device="cuda")
    m = torch.as_tensor(rng.integers(0, 63, B), device="cuda")
    for bits in (None, words):
        args = (m, xtab, 0.8, (1, 2, 3, 2 ** 32 - 5), bits)
        got = channel_kernel.mc_channel(*args, gen_bits=bits is None)
        want = channel_kernel.mc_channel(*args, gen_bits=bits is None,
                                         engine="plain")
        torch.cuda.synchronize()
        assert (got.view(torch.int32) == want.view(torch.int32)).all()
