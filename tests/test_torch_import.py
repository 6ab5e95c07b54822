"""The port stands alone: it imports without JAX and without nvcc, its build
helper raises when it cannot build, and on a card the kernel equals its plain
version.  This file imports no JAX, so its card test also runs where JAX is
absent:

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
    assert _build.sources() == ["bp_decode"]
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build_all()
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.load("bp_decode")


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
