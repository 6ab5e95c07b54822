"""The port stands alone: it imports without JAX, without matplotlib (which
only plotting.plot_results imports, when called) and without nvcc, its build
helper raises when it cannot build, its C engine wrapper builds into the
port's own _build/, and on a card each kernel equals its plain version.  This file imports no JAX, so its card tests also run where JAX
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

# Removes any JAX already loaded, refuses JAX, the JAX package and matplotlib
# from then on, imports every module of the port and reports what it
# imported.
_IMPORT_ALL = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "polardecoding_tpu", "matplotlib")

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
    # the package and its modules, harness, DE-GA, rng, native and
    # plotting included
    assert int(count) >= 25
    assert loaded.strip() == "[]"


# the C engine's wrapper with JAX, the JAX package and matplotlib refused:
# where it builds, and one call through it
_NATIVE = _IMPORT_ALL.split("import polardecoding_tpu_torch as pkg")[0] + """
from polardecoding_tpu_torch import native
try:
    native.golden_noise(1, 1, 8, 1.0)
except native.NativeUnavailable:
    print("unavailable")
    raise SystemExit(0)
print(native._LIB, sorted(m for m in sys.modules if blocked(m)))
"""


def test_native_builds_into_the_port_build_dir():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _NATIVE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if out.stdout.strip() == "unavailable":
        pytest.skip("no C compiler")
    lib, loaded = out.stdout.split(maxsplit=1)
    assert lib == os.path.join(REPO, "polardecoding_tpu_torch", "_build",
                               "libgolden_ref.so")
    assert os.path.exists(lib)
    assert loaded.strip() == "[]"


# the hardware studies' modules with JAX, the JAX package and matplotlib
# refused: each imported, and the command line at its default device
_STUDIES = _IMPORT_ALL.split("import polardecoding_tpu_torch as pkg")[0] + """
import pkgutil, torch
import polardecoding_tpu_torch.studies as st
names = sorted(m.name for m in pkgutil.walk_packages(st.__path__, st.__name__ + "."))
for name in names:
    importlib.import_module(name)
rc = None if torch.cuda.is_available() else st.main(["--out", sys.argv[1]])
print(names, rc, sorted(m for m in sys.modules if blocked(m)))
"""


def test_studies_import_without_jax(tmp_path):
    """Every module of polardecoding_tpu_torch.studies imports with JAX and
    the JAX package refused (its __main__ without running); without a card
    the command line at its default device exits 2 and writes nothing."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _STUDIES, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = [f"polardecoding_tpu_torch.studies.{m}" for m in (
        "__main__", "_common", "ab_chkfast", "bf16_study", "bler_r1",
        "bler_wavemc", "es_sanity_hw", "queue_a", "scl_parity_hw",
        "tie_impact_study")]
    rc = "None" if torch.cuda.is_available() else "2"
    assert out.stdout.strip() == f"{names} {rc} []"
    if rc == "2":
        assert "--device cpu" in out.stderr and not os.listdir(tmp_path)


# the probe drivers, imported (not run) with JAX and the JAX package refused
_IMPORT_SCRIPTS = _IMPORT_ALL.split("import polardecoding_tpu_torch as pkg")[0] + """
import importlib.util, os
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(
        name, os.path.join("scripts", name + ".py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules if blocked(m)))
"""
PROBE_SCRIPTS = ("torch_probe_floor", "torch_probe_floor2", "torch_probe_floor3",
                 "torch_microbench_rolls", "torch_scl_parts", "torch_bp_parts",
                 "torch_bp_saturation")


def test_probe_scripts_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPTS, *PROBE_SCRIPTS],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("script", PROBE_SCRIPTS)
def test_probe_scripts_exit_nonzero_without_a_card(script):
    """Each probe driver measures the card: without one it exits 2 and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join("scripts", script + ".py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


# ROADMAP queue A's drivers
QUEUE_A_SCRIPTS = ("torch_verify_drive", "torch_bench_scl", "torch_ab_r1",
                   "torch_bench_wave", "torch_ab_wavecheck")


def test_queue_a_scripts_import_without_jax():
    """Queue A's drivers import (not run) with JAX, the JAX package and
    matplotlib refused, and without nvcc: nothing is built on import."""
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPTS, *QUEUE_A_SCRIPTS],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("script", QUEUE_A_SCRIPTS)
def test_queue_a_scripts_exit_2_without_a_card(script, tmp_path):
    """Each queue A driver measures the card: without one, and without
    --device cpu, it exits 2, prints no result and writes no record."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join("scripts", script + ".py"),
                          "--out", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device (--device cpu runs the plain versions)" in out.stderr
    assert not os.listdir(tmp_path)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc on PATH or under CUDA_HOME, finding, building and loading
    a kernel raise BuildError rather than returning."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.sources() == ["bp_decode", "bp_wave", "bp_wave_mc",
                                "frame_channel", "mc_channel",
                                "microbench_rolls", "probe_floor",
                                "scl_decode"]
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


CARD_NS = (8, 16, 64, 128, 256, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("N,flavor,early_stop_every",
                         [(N, f, es) for N in CARD_NS
                          for f, es in (("minsum_lut", 0), ("minsum_lut_fast", 4),
                                        ("minsum_lut", 4), ("minsum_lut_fast", 0))]
                         + [(N, "spa", es) for N in (64, 1024) for es in (0, 4)])
def test_kernel_equals_plain_on_card(N, flavor, early_stop_every):
    """On a card: the CUDA kernel's u_hat, written over a buffer filled with
    90 (a store left out shows), bit-equal to the plain version's on every
    frame (SPA: on every frame the plain version decodes correctly), and
    the launch counted once; bp_decode_auto routes the CUDA tensor to the
    kernel (one more launch) with the same result.  At N <= 64 a frame is
    one warp."""
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
    out = torch.full((64, N), 90, dtype=torch.int8, device="cuda")
    launches = bp_kernel.LAUNCHES
    got = bp_kernel.bp_decode_cuda(llr, frozen, iters=100, flavor=flavor,
                                   early_stop_every=early_stop_every, out=out)
    want = bp_decode(llr, frozen, iters=100, flavor=flavor,
                     early_stop_every=early_stop_every)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == launches + 1
    assert got is out and got.dtype == torch.int8
    routed = bp_decode_auto(llr, frozen, iters=100, flavor=flavor,
                            early_stop_every=early_stop_every)
    torch.cuda.synchronize()
    assert bp_kernel.LAUNCHES == launches + 2
    for res in (got, routed):
        equal = (res == want).all(dim=1)
        if flavor == "spa":
            equal = equal[(want == 0).all(dim=1)]
        assert equal.all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bp_decode", "bp_wave_mc", "bp_wave",
                                    "bp_wave_fused"])
def test_live_row_kernels_hold_three_frames_per_sm_on_card(kernel):
    """On a card: at N=1024 each live-row kernel takes at most 74,752 bytes
    of shared memory a frame and the occupancy query puts 3 frames on an
    SM; at N=1024 and at N=128 (the instance for n at run time) no register
    spills to local memory; in every flavor (the fused wave kernel with
    check_every 0 and 4, two instances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops.bp_kernel import FLAVORS, bp_decode_shape
    from polardecoding_tpu_torch.ops.bp_wave_kernel import bp_wave_shape
    from polardecoding_tpu_torch.ops.bp_wave_mc_kernel import bp_wave_mc_shape

    for flavor, N in [(f, N) for f in FLAVORS for N in (1024, 128)]:
        if kernel == "bp_decode":
            shapes = [bp_decode_shape(N, flavor, early_stop_every=4)]
        elif kernel == "bp_wave_mc":
            shapes = [bp_wave_mc_shape(N, flavor)]
        elif kernel == "bp_wave":
            shapes = [bp_wave_shape(N, flavor)]
        else:
            shapes = [bp_wave_shape(N, flavor, fused=True, check_every=ce)
                      for ce in (0, 4)]
        for shape in shapes:
            assert shape["local_bytes"] == 0, (N, shape)
            if N == 1024:
                assert shape["smem_bytes"] <= 74752, shape
                assert shape["frames_per_sm"] == 3, shape


def _node_mask(name, N):
    """A frozen mask of the list-decode kernel's card tests: the 5G mask at
    rate 1/2, or one that exercises a node kind (at N=1024 unless random):
    one R0 node of width N, one REP node of width N, all info, two ladders
    with an R0 and a REP node of every width from 512 to 2 between them,
    a second half that is one R0 or REP node, a seeded random mask."""
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    j = np.arange(N)
    if name == "5g":
        return frozen_mask(N, N // 2)
    if name == "random":
        return np.random.default_rng(N).random(N) < 0.5
    if name.startswith("ladder"):
        kind, m = name[7:], []
        for s in range(9, 0, -1):
            m += [True] * ((1 << s) - 1) + [kind == "r0"]
            kind = "r0" if kind == "rep" else "rep"
        return np.array(m + [False, False])
    half = (np.random.default_rng(1).random(N) < 0.5) | (j >= N // 2)
    return {"all-frozen": j >= 0, "last-info": j < N - 1, "all-info": j < 0,
            "half_r0": half, "half_rep": half & (j < N - 1)}[name]


NODE_MASKS = ("all-frozen", "last-info", "all-info", "ladder_r0",
              "ladder_rep", "half_r0", "half_rep")
NODE_LISTS = (1, 2, 8, 16, 32)


def _scl_card_case(N, L, r1, mask):
    """The list-decode kernel in one mode against the plain version on the
    card, through out= buffers filled with 90 (a store left out shows), and
    the launch counted once in that mode's counter, and in
    LAUNCHES_TOP_REGS where exact mode at N=1024, L in {8, 16, 32} holds
    the stage n-1 row in registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops import scl_kernel

    rng = np.random.default_rng(N + L + r1)
    llr = torch.as_tensor((rng.normal(size=(32, N)) * 3).astype(np.float32),
                          device="cuda")
    frozen = torch.as_tensor(_node_mask(mask, N), device="cuda")
    out = (torch.full((32, L, N), 90, dtype=torch.int8, device="cuda"),
           torch.full((32, L), 90.0, device="cuda"),
           torch.full((32,), 90, dtype=torch.int32, device="cuda"))
    launches = (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1,
                scl_kernel.LAUNCHES_TOP_REGS)
    got = scl_kernel.scl_decode_cuda(llr, frozen, L, r1=r1, out=out)
    want = scl_decode(llr, frozen, list_size=L, return_all=True,
                      return_ties=True, r1=r1)
    torch.cuda.synchronize()
    top_regs = r1 == 0 and N == 1024 and L in (8, 16, 32)
    assert (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1,
            scl_kernel.LAUNCHES_TOP_REGS) == (
        launches[0] + (r1 == 0), launches[1] + (r1 > 0),
        launches[2] + top_regs)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,L,mask", [(128, 1, "5g"), (128, 8, "5g"), (128, 32, "5g"),
                 (1024, 1, "5g"), (1024, 8, "5g"), (1024, 32, "5g")]
    + [(1024, L, m) for m in NODE_MASKS for L in NODE_LISTS]
    + [(N, L, "random") for N in (2, 4, 16) for L in NODE_LISTS])
def test_scl_kernel_equals_plain_on_card(N, L, mask):
    """On a card: the CUDA list-decode kernel's u_all, PM and tie counter
    bit-equal to the plain version's on every frame, for the 5G masks and
    every node kind at every width, and the launch counted once."""
    _scl_card_case(N, L, 0, mask)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,L,r1,mask", [(32, 4, 2, "all-info"), (128, 8, 4, "5g"),
                    (1024, 1, 4, "5g"), (1024, 8, 4, "5g"),
                    (1024, 16, 4, "5g"), (1024, 32, 2, "5g")]
    + [(1024, L, 4, m) for m in NODE_MASKS for L in NODE_LISTS]
    + [(N, L, 2, "random") for N in (2, 4, 16) for L in NODE_LISTS])
def test_scl_r1_kernel_equals_plain_on_card(N, L, r1, mask):
    """On a card: the list-decode kernel's rate-1 flavor bit-equal to the
    plain flavor (u_all, PM, ties) on every frame, for the same masks,
    counted once as a flavor launch and not as an exact one."""
    _scl_card_case(N, L, r1, mask)


def _layout_with_top(N, L, tm, xw):
    """One frame's bytes in csrc/scl_decode.cu's layout with the stage n-1
    row in shared memory (the R1 flavor's and the generic instantiation's)."""
    def up16(x):
        return (x + 15) // 16 * 16

    W = max(1, N // 32)
    llr = max(4 * L * (N // 2 - 1), N * L)
    bits = up16(up16(llr) + 4 * N)
    cand = up16(up16(bits + 4 * (L + 1) * W) + 16 * L)
    mins = up16(cand + 8 * L + 4 * L)
    fl = mins + 4 * L * tm
    pos = fl + (4 * L if xw else 0) + 4 * L * xw
    return up16(pos + 2 * L * tm + L)


@pytest.mark.cuda
def test_scl_exact_kernel_residency_on_card():
    """On a card: exact mode at N=1024 keeps the stage n-1 row in registers,
    so a frame takes at most 17,744 bytes at L=8 and the occupancy query
    puts 13, 6 and 3 frames on an SM at L=8, 16 and 32; the R1 flavor and
    the instantiation for n and L at run time (N=128) keep the row in
    shared memory, with today's frame bytes; no SCL instantiation spills
    registers to local memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops.probe_kernel import scl_shape

    for L, frames in ((8, 13), (16, 6), (32, 3)):
        shape = scl_shape(16384, 1024, L)
        assert shape["top_regs"] and shape["frames_per_sm"] == frames, shape
        assert shape["frame_bytes"] == _layout_with_top(1024, L, 0, 0) - 4096
        assert shape["local_bytes"] == 0, shape
    assert scl_shape(16384, 1024, 8)["frame_bytes"] <= 17744
    for N, L in ((1024, 8), (1024, 16), (1024, 32), (128, 8), (128, 2)):
        r1 = scl_shape(4096, N, L, L - 1, max(1, N // 32))
        assert not r1["top_regs"] and r1["local_bytes"] == 0, (N, L, r1)
        assert r1["frame_bytes"] == _layout_with_top(N, L, L - 1, N // 32)
    for N, L in ((128, 8), (128, 2), (1024, 4)):
        shape = scl_shape(4096, N, L)
        assert not shape["top_regs"] and shape["local_bytes"] == 0, shape
        assert shape["frame_bytes"] == _layout_with_top(N, L, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 16])
def test_scl_register_row_kernel_decodes_more_frames_than_slots(L):
    """On a card: with more frames than resident warps (2 x SMs x 13 + 7),
    each warp decodes several frames in turn and the register-row kernel
    stays bit-equal to the plain version (5G mask); the launch counts in
    LAUNCHES_TOP_REGS, which an L=2, an N=128 and an R1 launch leave as it
    is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.scl import scl_decode
    from polardecoding_tpu_torch.ops import scl_kernel
    from polardecoding_tpu_torch.utils.sequences import frozen_mask

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = 2 * sms * 13 + 7
    rng = np.random.default_rng(B + L)
    sigma = 10.0 ** (-2.0 / 20.0)
    y = 1.0 + sigma * rng.normal(size=(B, 1024))
    llr = torch.as_tensor((2.0 * y / sigma ** 2).astype(np.float32),
                          device="cuda")
    frozen = torch.as_tensor(frozen_mask(1024, 512), device="cuda")
    out = (torch.full((B, L, 1024), 90, dtype=torch.int8, device="cuda"),
           torch.full((B, L), 90.0, device="cuda"),
           torch.full((B,), 90, dtype=torch.int32, device="cuda"))
    before = scl_kernel.LAUNCHES_TOP_REGS
    got = scl_kernel.scl_decode_cuda(llr, frozen, L, out=out)
    want = scl_decode(llr, frozen, list_size=L, return_all=True,
                      return_ties=True)
    torch.cuda.synchronize()
    assert scl_kernel.LAUNCHES_TOP_REGS == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all()
    small = llr[:64]
    scl_kernel.scl_decode_cuda(small, frozen, 2)
    scl_kernel.scl_decode_cuda(small[:, :128].contiguous(),
                               torch.as_tensor(frozen_mask(128, 64),
                                               device="cuda"), L)
    scl_kernel.scl_decode_cuda(small, frozen, L, r1=4)
    torch.cuda.synchronize()
    assert scl_kernel.LAUNCHES_TOP_REGS == before + 1


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
@pytest.mark.parametrize(
    "N,check_every,iters,dead",
    [pytest.param(N, ce, 8, False, id=f"{N}-{ce}")
     for N, ce in ((128, 0), (128, 4), (1024, 0), (1024, 1))]
    + [pytest.param(N, ce, i, True, id=f"{N}-{ce}-{i}-dead")
       for N in CARD_NS for i in (0, 1, 8) for ce in (0, 1, 4, 8)])
def test_wave_kernels_equal_plain_on_card(N, check_every, iters, dead):
    """On a card: the fused wave kernel's state, u_hat and done, and the
    unfused kernel's state, bit-equal to the plain versions, each launch
    counted once.  With `dead`, in both min-sum flavors, on every odd slot
    retired, at `iters` iterations, with NaN in L[0] and R[1..n] (the
    planes an iteration writes before it reads them) when iters >= 1; at
    N <= 64 a slot is one warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import bp_wave, bp_wave_fused
    from polardecoding_tpu_torch.ops import bp_wave_kernel

    state, llr, retire = _wave_inputs(N, 64, N + check_every + 100 * dead
                                      + iters)
    flavors = ["minsum_lut"]
    if dead:
        flavors.append("minsum_lut_fast")
        retire = torch.arange(64, device="cuda") % 2 == 1
        if iters:
            n = N.bit_length() - 1
            state[[0] + list(range(n + 2, 2 * n + 2))] = float("nan")
    for flavor in flavors:
        launches = dict(bp_wave_kernel.LAUNCHES)
        kw = dict(flavor=flavor, check_every=check_every)
        got = bp_wave_fused(state.clone(), llr, retire, iters, **kw)
        want = bp_wave_fused(state.clone(), llr, retire, iters, engine="plain",
                             **kw)
        got_w = bp_wave(state.clone(), iters, flavor)
        want_w = bp_wave(state.clone(), iters, flavor, engine="plain")
        torch.cuda.synchronize()
        assert bp_wave_kernel.LAUNCHES == {k: v + 1 for k, v in launches.items()}
        assert _same_bits(got[0], want[0]) and _same_bits(got_w, want_w), flavor
        assert got[1].dtype == torch.int8 and (got[1] == want[1]).all()
        assert got[2].dtype == torch.bool and (got[2] == want[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bp_wave", "bp_wave_fused"])
def test_wave_kernels_route_through_auto_on_card(kernel):
    """On a card: one call of models/bp.bp_wave or bp_wave_fused with
    engine="auto" on CUDA tensors launches its kernel once, and no other,
    and equals the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import bp_wave, bp_wave_fused
    from polardecoding_tpu_torch.ops import bp_wave_kernel

    state, llr, retire = _wave_inputs(1024, 64, 5)
    launches = dict(bp_wave_kernel.LAUNCHES)
    if kernel == "bp_wave":
        got = (bp_wave(state.clone(), 8, engine="auto"),)
        want = (bp_wave(state.clone(), 8, engine="plain"),)
    else:
        got = bp_wave_fused(state.clone(), llr, retire, 8, engine="auto")
        want = bp_wave_fused(state.clone(), llr, retire, 8, engine="plain")
    torch.cuda.synchronize()
    assert bp_wave_kernel.LAUNCHES == {k: v + (k == kernel)
                                       for k, v in launches.items()}
    assert _same_bits(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and (g == w).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,cadence,noise",
                         [(N, c, nz) for N in CARD_NS
                          for c, nz in ((1, "kernel"), (2, "bits"))]
                         + [(1024, 2, "kernel")])
def test_wave_mc_kernel_equals_plain_on_card(N, cadence, noise):
    """On a card: four MC waves (the second of no iterations) and a drain,
    state, meta and stats bit-equal to the plain version's, with counter
    noise or given words, the stats written over a buffer filled with 90;
    and a third chain through bp_wave_mc (engine "auto"), which routes the
    CUDA tensors to the kernel (one more launch a wave), equal too.  At
    N <= 64 a slot is one warp."""
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
    s3, m3 = s1.clone(), m1.clone()
    launches = bp_wave_mc_kernel.LAUNCHES
    for step in range(5):
        bits = None if noise == "kernel" else torch.as_tensor(
            rng.integers(0, 2 ** 32, (2, B, N)), device="cuda")
        kw = dict(iters=0 if step == 1 else 8, iter_max=24,
                  delta=mc_delta(B, K), drain=step == 4, cadence=cadence)
        seeds = (0x13198A2E, 0x03707344, 0x13198A2E ^ 0x03707344, step)
        x1 = torch.full((B, 3), 90.0, device="cuda")
        got = bp_wave_mc_kernel.bp_wave_mc_cuda(s1, m1, *tabs, 0.8, seeds, bits,
                                                out=x1, **kw)
        s2, m2, x2 = bp_wave_mc(s2, m2, *tabs, 0.8, seeds, bits, engine="plain",
                                gen_bits=bits is None, **kw)
        s3, m3, x3 = bp_wave_mc(s3, m3, *tabs, 0.8, seeds, bits,
                                gen_bits=bits is None, **kw)
        torch.cuda.synchronize()
        assert got[0] is s1 and got[1] is m1 and got[2] is x1
        assert _same_bits(s1, s2) and _same_bits(m1, m2) and _same_bits(x1, x2)
        assert _same_bits(s3, s2) and _same_bits(m3, m2) and _same_bits(x3, x2)
    assert bp_wave_mc_kernel.LAUNCHES == launches + 10


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


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"init": True}, {"scratch": False},
                                {"u_rows": 1}, {"u_dtype": torch.int32},
                                {"dma_in": False}, {"ties": False}])
def test_floor_kernel_equals_plain_on_card(kw):
    """On a card: each floor variant's outputs, written over buffers filled
    with 90 so that a store left out shows, bit-equal to the plain version's
    zeros, each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import probe_kernel

    B, N, L = 256, 1024, 8
    ch = torch.randn(B, N, device="cuda")
    leaf = torch.ones(N, dtype=torch.uint8, device="cuda")
    want = probe_kernel.floor_plain(ch, leaf, L, **kw)
    out = tuple(None if w is None else torch.full_like(w, 90) for w in want)
    launches = probe_kernel.LAUNCHES
    got = probe_kernel.floor_cuda(ch, leaf, L, out=out, **kw)
    torch.cuda.synchronize()
    assert probe_kernel.LAUNCHES == launches + 1
    for g, o, w in zip(got, out, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g is o and g.dtype == w.dtype and g.shape == w.shape
            assert (g == w).all()


@pytest.mark.cuda
def test_floor_burst_and_graph_count_their_launches_on_card():
    """k back-to-back launches count k; a graph of k launches counts
    nothing when captured and k per replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import probe_kernel

    ch = torch.randn(128, 1024, device="cuda")
    kw = dict(scratch=False, ties=False)
    launches = probe_kernel.LAUNCHES
    probe_kernel.floor_burst(10, ch, None, 8, **kw)
    assert probe_kernel.LAUNCHES == launches + 10
    replay = probe_kernel.floor_graph(20, ch, None, 8, **kw)
    assert probe_kernel.LAUNCHES == launches + 11  # the warm-up launch
    u, pm, _ = replay()
    replay()
    torch.cuda.synchronize()
    assert probe_kernel.LAUNCHES == launches + 51
    assert not u.any() and not pm.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L,rows", [
    ("gather", 8, 1), ("gather", 32, 1), ("gather_rows", 8, 8),
    ("gather_rows", 8, 32), ("gather_rows", 8, 128), ("lut", 8, 8),
    ("lut", 8, 32), ("rank", 8, 1), ("rank", 32, 1), ("chk", 8, 8),
    ("chk", 8, 64)])
def test_microbench_kernel_equals_plain_on_card(kind, L, rows):
    """On a card: each pattern's tiles after 7 iterations bit-equal to the
    plain version's, with one tile and with 40, each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import microbench_kernel as mk

    for copies in (1, 40):
        x = torch.as_tensor(np.random.default_rng(copies).normal(
            size=(copies, rows, 8, 128)).astype(np.float32), device="cuda")
        launches = mk.LAUNCHES
        got = mk.microbench_cuda(kind, x, 7, L)
        want = mk.microbench_plain(kind, x, 7, L)
        torch.cuda.synchronize()
        assert mk.LAUNCHES == launches + 1
        assert _same_bits(got, want)


_IMPORT_MESH = _IMPORT_ALL.split("import polardecoding_tpu_torch as pkg")[0] + """
import polardecoding_tpu_torch.parallel.mesh
import polardecoding_tpu_torch.parallel.distributed
print(sorted(m for m in sys.modules if blocked(m)))
"""


def test_mesh_and_distributed_import_without_jax():
    """The multi-process modules (torch.distributed) import no JAX."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_MESH], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_one_nccl_rank_equals_no_mesh_on_card(tmp_path):
    """On a card: a one-rank nccl group's mesh runs every collective
    through NCCL, and BP_128's frame-step counters equal those without a
    mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the collectives run through NCCL")
    import datetime

    import torch.distributed as dist

    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import prng_key
    from polardecoding_tpu_torch.parallel.harness import make_frame_step
    from polardecoding_tpu_torch.parallel.mesh import data_mesh

    p, key, sigma = preset("BP_128"), prng_key(7, "cuda"), 0.8
    want = [[int(v) for v in make_frame_step(p, 256, "cuda")(key, s, sigma)]
            for s in (0, 256)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = data_mesh()
        assert mesh.group is not None and mesh.device.type == "cuda"
        step = make_frame_step(p, 256, mesh=mesh)
        got = [[int(v) for v in step(key.to(mesh.device), s, sigma)]
               for s in (0, 256)]
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    assert got == want and want[0][1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("N,row0", [(1024, 128), (1024, (1 << 22) - 100),
                                    (64, 3)])
def test_mc_channel_first_row_equals_plain_on_card(N, row0):
    """On a card: the MC channel at a first row other than 0 (a rank's slice
    of a global batch; at N=1024 also one whose counters pass 2^32)
    bit-equal to the plain version's, and equal to the rows of a launch
    from row 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.models.bp import mc_tables
    from polardecoding_tpu_torch.ops import channel_kernel
    from polardecoding_tpu_torch.utils.sequences import info_set

    B = 256
    _, xtab = mc_tables(info_set(N, N // 2), N // 2, N, "cuda")
    m = (torch.arange(B, device="cuda") * 8) % 63
    seeds = (1, 2, 3, 4096)
    got = channel_kernel.mc_channel(m, xtab, 0.8, seeds, row0=row0)
    want = channel_kernel.mc_channel(m, xtab, 0.8, seeds, row0=row0,
                                     engine="plain")
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    if row0 < B:
        whole = channel_kernel.mc_channel(torch.cat([m[:row0], m]), xtab, 0.8,
                                          seeds)
        assert _same_bits(got, whole[row0:])
