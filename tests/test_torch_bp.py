"""The port's BP decoder against the JAX package's on the CPU: u_hat bit-equal
on every frame (converged or not) for both min-sum flavors, fixed-iteration
and early-stop; SPA and float64 held to the rules stated in each test."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu.analysis.construction import code_frozen_mask
from polardecoding_tpu.configs import preset
from polardecoding_tpu.models.bp import bp_decode as jax_bp_decode
from polardecoding_tpu.ops.pallas.bp_kernel import bp_decode_pallas
from polardecoding_tpu.utils.gf2 import dense_generator
from polardecoding_tpu.utils.sequences import frozen_mask
from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.ops import bp_kernel


def _frames(N, B, seed, frozen=None):
    """Channel LLRs (float32) of B random codewords, the first half of the
    frames at 1.0 dB and the rest at 2.0 dB, and the true u."""
    rng = np.random.default_rng(seed)
    frozen = frozen_mask(N, N // 2) if frozen is None else frozen
    u = np.zeros((B, N), np.int8)
    u[:, ~frozen] = rng.integers(0, 2, (B, int((~frozen).sum())))
    x = (u.astype(np.int64) @ dense_generator(N)) % 2
    snr = np.where(np.arange(B) < B // 2, 1.0, 2.0)[:, None]
    sigma = 10.0 ** (-snr / 20.0)
    y = (1.0 - 2.0 * x) + sigma * rng.normal(size=(B, N))
    return (2.0 * y / sigma ** 2).astype(np.float32), u, frozen


def _port(llr, frozen, **kw):
    return tbp.bp_decode_auto(torch.as_tensor(llr), torch.as_tensor(frozen),
                              **kw).numpy()


# every flavor x early-stop pair at N=128; two of them at N=64 and N=1024,
# where each case costs more CPU time
CASES = ([(128, 32, f, e) for f in ("minsum_lut", "minsum_lut_fast")
          for e in (0, 4)]
         + [(64, 32, "minsum_lut", 0), (64, 32, "minsum_lut_fast", 4),
            (1024, 16, "minsum_lut", 4), (1024, 16, "minsum_lut_fast", 0)])


@pytest.mark.parametrize("N,B,flavor,early_stop_every", CASES)
def test_bp_bit_equal_to_jax_on_every_frame(N, B, flavor, early_stop_every):
    llr, u, frozen = _frames(N, B, seed=N)
    want = np.asarray(jax_bp_decode(jnp.asarray(llr), jnp.asarray(frozen),
                                    iters=100, flavor=flavor,
                                    early_stop_every=early_stop_every))
    launches = bp_kernel.LAUNCHES
    got = _port(llr, frozen, iters=100, flavor=flavor,
                early_stop_every=early_stop_every)
    assert bp_kernel.LAUNCHES == launches  # a CPU tensor takes the plain path
    assert got.dtype == np.int8 and got.shape == (B, N)
    assert (got == want).all()
    # the batch holds converged and non-converged frames alike
    ok = (want == u).all(axis=1)
    assert 0 < ok.sum() < B


@pytest.mark.parametrize("name", ["BP_128", "BP_128_fag"])
def test_bp_presets_lee_and_kao(name):
    """Lee and Kao presets decode through the one engine with the preset's
    frozen mask and flavor: bit-equal to JAX on every frame."""
    p = preset(name)
    frozen = code_frozen_mask(p.code)
    llr, _, _ = _frames(p.code.N, 24, seed=3, frozen=frozen)
    kw = dict(iters=p.decoder.bp_iters, flavor=p.decoder.bp_flavor)
    want = np.asarray(jax_bp_decode(jnp.asarray(llr), jnp.asarray(frozen), **kw))
    assert (_port(llr, frozen, **kw) == want).all()


def test_bp_bit_equal_to_pallas_kernel_interpret():
    """The TPU kernel itself (interpret mode, N=64) against the port."""
    llr, _, frozen = _frames(64, 8, seed=5)
    for es in (0, 4):
        want = np.asarray(bp_decode_pallas(jnp.asarray(llr), jnp.asarray(frozen),
                                           iters=100, tile=8, interpret=True,
                                           early_stop_every=es))
        assert (_port(llr, frozen, iters=100, early_stop_every=es) == want).all()


def test_bp_spa_rule():
    """SPA goes through exp and log1p, which each framework takes from its
    own math library; XLA's float32 exp is a fast approximation, so the two
    float32 decoders differ in their correction terms.  The rule: in
    float64, u_hat equals JAX's on every frame JAX decoded correctly
    (chaotic, non-converged frames may go their own way on a last-ulp
    difference), and the float32 run gives int8 decisions of the same
    shape."""
    N, B = 128, 32
    llr, u, frozen = _frames(N, B, seed=N)
    with jax.enable_x64(True):
        want = np.asarray(jax_bp_decode(jnp.asarray(llr.astype(np.float64)),
                                        jnp.asarray(frozen), iters=100,
                                        flavor="spa"))
    got64 = _port(llr.astype(np.float64), frozen, iters=100, flavor="spa")
    ok = (want == u).all(axis=1)
    assert ok.sum() >= B // 2
    assert (got64[ok] == want[ok]).all()
    got32 = _port(llr, frozen, iters=100, flavor="spa")
    assert got32.dtype == np.int8 and got32.shape == (B, N)


def _load_golden(path):
    frames = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts[0] != "FRAME":
                continue
            run, kind, vals = int(parts[1]), parts[2], parts[3:]
            frames.setdefault(run, {})[kind] = (
                np.array([float(v) for v in vals]) if kind == "Y"
                else np.array([int(v) for v in vals], dtype=np.int8))
    return frames


def test_bp_float64_golden_frames_all_equal_c_reference():
    """BP_128 frames dumped by the C reference (seed 1024, 1.0 dB): the
    port's plain BP in float64 reproduces the C decisions on ALL frames,
    converged or not (torch forms every a*b+c as the C does, without
    contraction), which is more than the JAX engine's converged-frames-only
    parity in tests/test_golden_parity.py."""
    frames = _load_golden(os.path.join(os.path.dirname(__file__), "golden",
                                       "bp_128_frames.txt"))
    sigma = 10.0 ** (-1.0 / 20.0)
    llr = np.stack([2.0 * frames[r]["Y"] / sigma / sigma for r in sorted(frames)])
    want = np.stack([frames[r]["H"] for r in sorted(frames)])
    u_true = np.stack([frames[r]["U"] for r in sorted(frames)])
    got = _port(llr, frozen_mask(128, 64), iters=100)
    converged = (want == u_true).all(axis=1)
    assert converged.any() and not converged.all()
    assert (got == want).all()


def test_bp_decode_auto_routes():
    """A CPU tensor runs the plain version; the kernel's wrapper refuses a
    CPU tensor rather than falling back; unknown engines raise."""
    llr, _, frozen = _frames(8, 2, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        bp_kernel.bp_decode_cuda(torch.as_tensor(llr), torch.as_tensor(frozen))
    with pytest.raises(ValueError):
        _port(llr, frozen, engine="jnp")
    a = _port(llr, frozen, iters=10, engine="plain")
    b = _port(llr, frozen, iters=10)
    assert (a == b).all()
