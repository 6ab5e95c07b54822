"""The port stands alone: it imports without JAX and without nvcc, its build
helper raises when it cannot build, and on a card each kernel equals its
plain version.  This file imports no JAX, so its card tests also run where JAX
is absent:

  python -m pytest --noconftest -q -m cuda tests/test_torch_import.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from polardecoding_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Removes any JAX already loaded, refuses JAX and the JAX package from then
# on, imports every module of the port and reports what it imported.
_IMPORT_ALL = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "polardecoding_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("the port imported " + name)
        return None

for m in [m for m in sys.modules if blocked(m)]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import polardecoding_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in sys.modules if blocked(m)))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.split(maxsplit=1)
    assert int(count) >= 20  # the package and its modules, harness included
    assert loaded.strip() == "[]"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc on PATH or under CUDA_HOME, finding, building and loading
    a kernel raise BuildError rather than returning."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.sources() == ["bp_decode", "bp_wave", "bp_wave_mc",
                                "mc_channel", "scl_decode"]
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build_all()
    for name in _build.sources():
        with pytest.raises(_build.BuildError, match="nvcc"):
            _build.load(name)


def test_build_flags():
    """The flags the kernel's bit-equality rests on: Hopper's sm_90a target,
    no contraction of a*b + c, and no fast math."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags


@pytest.mark.cuda
@pytest.mark.parametrize("N,flavor,early_stop_every",
                         [(128, "minsum_lut", 0), (128, "minsum_lut_fast", 4),
                          (1024, "minsum_lut", 4), (1024, "minsum_lut_fast", 0)])
def test_kernel_equals_plain_on_card(N, flavor, early_stop_every):
    """On a card: the CUDA kernel's u_hat bit-equal to the plain version's on
    every frame, and the launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import bp_decode, bp_decode_auto
    from polardecoding_tpu_torch.ops import bp_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    rng = np.random.default_rng(N)
    sigma = 10.0 ** (-1.5 / 20.0)
    # all-zero codeword: LLRs of +1 symbols through AWGN at 1.5 dB
    y = 1.0 + sigma * rng.normal(size=(64, N))
    llr = torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32), device="cuda")
    frozen = torch.as_tensor(frozen_mask(N, N // 2), device="cuda")
    launches = bp_kernel.LAUNCHES
    got = bp_decode_auto(llr, frozen, iters=100, flavor=flavor,
                         early_stop_every=early_stop_every)
    want = bp_decode(llr, frozen, iters=100, flavor=flavor,
                     early_stop_every=early_stop_every)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == launches + 1
    assert got.dtype == torch.int8 and (got == want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,L", [(128, 1), (128, 8), (128, 32),
                                 (1024, 1), (1024, 8), (1024, 32)])
def test_scl_kernel_equals_plain_on_card(N, L):
    """On a card: the CUDA list-decode kernel's u_all, PM and tie counter
    bit-equal to the plain version's on every frame, and the launch counted
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.scl import scl_decode, scl_decode_auto
    from polardecoding_tpu_torch.ops import scl_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    rng = np.random.default_rng(N + L)
    llr = torch.as_tensor((rng.normal(size=(32, N)) * 3).astype(np.float32),
                          device="cuda")
    frozen = torch.as_tensor(frozen_mask(N, N // 2), device="cuda")
    launches = scl_kernel.LAUNCHES
    got = scl_decode_auto(llr, frozen, list_size=L, return_all=True,
                          return_ties=True)
    want = scl_decode(llr, frozen, list_size=L, return_all=True,
                      return_ties=True)
    torch.cuda.synchronize()
    assert scl_kernel.LAUNCHES == launches + 1
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g == w).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,L,r1,mask", [(32, 4, 2, "all-info"),
                                         (128, 8, 4, "5g"), (1024, 1, 4, "5g"),
                                         (1024, 8, 4, "5g"), (1024, 16, 4, "5g"),
                                         (1024, 32, 2, "5g")])
def test_scl_r1_kernel_equals_plain_on_card(N, L, r1, mask):
    """On a card: the list-decode kernel's rate-1 flavor bit-equal to the
    plain flavor (u_all, PM, ties) on every frame, counted once as a flavor
    launch and not as an exact one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.scl import scl_decode, scl_decode_auto
    from polardecoding_tpu_torch.ops import scl_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    rng = np.random.default_rng(N + L + r1)
    llr = torch.as_tensor((rng.normal(size=(32, N)) * 3).astype(np.float32),
                          device="cuda")
    fr = np.zeros(N, bool) if mask == "all-info" else frozen_mask(N, N // 2)
    frozen = torch.as_tensor(fr, device="cuda")
    launches = (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1)
    got = scl_decode_auto(llr, frozen, list_size=L, return_all=True,
                          return_ties=True, r1=r1)
    want = scl_decode(llr, frozen, list_size=L, return_all=True,
                      return_ties=True, r1=r1)
    torch.cuda.synchronize()
    assert (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1) == (launches[0],
                                                            launches[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()


def _wave_inputs(N, B, seed):
    """A wave state on the card after 8 iterations of random LLRs, fresh
    LLRs and a random retire mask."""
    from polardecoding_tpu_torch.models.bp import bp_wave_plain, wave_init_state
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    rng = np.random.default_rng(seed)
    frozen = torch.as_tensor(frozen_mask(N, N // 2), device="cuda")

    def llr():
        return torch.as_tensor((rng.normal(size=(B, N)) * 2.5 + 2.0)
                               .astype(np.float32), device="cuda")

    state = bp_wave_plain(wave_init_state(llr(), frozen), 8)
    return state, llr(), torch.as_tensor(rng.random(B) < 0.5, device="cuda")


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(torch.int32) == b.view(torch.int32)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,check_every", [(128, 0), (128, 4), (1024, 0),
                                           (1024, 1)])
def test_wave_kernels_equal_plain_on_card(N, check_every):
    """On a card: the fused wave kernel's state, u_hat and done, and the
    unfused kernel's state, bit-equal to the plain versions, each launch
    counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import bp_wave, bp_wave_fused
    from polardecoding_tpu_torch.ops import bp_wave_kernel

    state, llr, retire = _wave_inputs(N, 64, N + check_every)
    launches = dict(bp_wave_kernel.LAUNCHES)
    got = bp_wave_fused(state.clone(), llr, retire, 8, check_every=check_every)
    want = bp_wave_fused(state.clone(), llr, retire, 8, check_every=check_every,
                         engine="plain")
    got_w = bp_wave(state.clone(), 8)
    want_w = bp_wave(state.clone(), 8, engine="plain")
    torch.cuda.synchronize()
    assert bp_wave_kernel.LAUNCHES == {k: v + 1 for k, v in launches.items()}
    assert _same_bits(got[0], want[0]) and _same_bits(got_w, want_w)
    assert got[1].dtype == torch.int8 and (got[1] == want[1]).all()
    assert got[2].dtype == torch.bool and (got[2] == want[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,cadence,noise", [(128, 1, "kernel"),
                                             (128, 2, "bits"),
                                             (1024, 2, "kernel")])
def test_wave_mc_kernel_equals_plain_on_card(N, cadence, noise):
    """On a card: four MC waves and a drain, state, meta and stats bit-equal
    to the plain version's, with counter noise or given words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import (bp_wave_mc, mc_delta,
                                                   mc_meta_init, mc_tables,
                                                   wave_init_state)
    from polardecoding_tpu_torch.ops import bp_wave_mc_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

    B, K = 64, N // 2
    rng = np.random.default_rng(N)
    tabs = mc_tables(info_set(N, K), K, N, "cuda")
    s1 = wave_init_state(torch.zeros(B, N, device="cuda"),
                         torch.as_tensor(frozen_mask(N, K), device="cuda"))
    m1 = mc_meta_init(B, N, K, "cuda")
    s2, m2 = s1.clone(), m1.clone()
    launches = bp_wave_mc_kernel.LAUNCHES
    for step in range(5):
        bits = None if noise == "kernel" else torch.as_tensor(
            rng.integers(0, 2 ** 32, (2, B, N)), device="cuda")
        kw = dict(iters=8, iter_max=24, delta=mc_delta(B, K), drain=step == 4,
                  cadence=cadence, gen_bits=bits is None)
        seeds = (0x13198A2E, 0x03707344, 0x13198A2E ^ 0x03707344, step)
        s1, m1, x1 = bp_wave_mc(s1, m1, *tabs, 0.8, seeds, bits, **kw)
        s2, m2, x2 = bp_wave_mc(s2, m2, *tabs, 0.8, seeds, bits, engine="plain",
                                **kw)
        torch.cuda.synchronize()
        assert _same_bits(s1, s2) and _same_bits(m1, m2) and _same_bits(x1, x2)
    assert bp_wave_mc_kernel.LAUNCHES == launches + 5


@pytest.mark.cuda
def test_mc_channel_kernel_equals_plain_on_card():
    """On a card: the MC channel's LLRs bit-equal to the plain version's,
    with counter noise and with given words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import mc_tables
    from polardecoding_tpu_torch.ops import channel_kernel
    from polardecoding_tpu_torch.utils.sequences import info_set

    B, N = 256, 1024
    _, xtab = mc_tables(info_set(N, 512), 512, N, "cuda")
    m = (torch.arange(B, device="cuda") * 8) % 63
    seeds = (1, 2, 3, 4096)
    given = torch.as_tensor(np.random.default_rng(1).integers(0, 2 ** 32, (B, N)),
                            device="cuda")
    launches = channel_kernel.LAUNCHES
    for bits in (None, given):
        got = channel_kernel.mc_channel(m, xtab, 0.8, seeds, bits,
                                        gen_bits=bits is None)
        want = channel_kernel.mc_channel(m, xtab, 0.8, seeds, bits,
                                         gen_bits=bits is None, engine="plain")
        torch.cuda.synchronize()
        assert _same_bits(got, want)
    assert channel_kernel.LAUNCHES == launches + 2
