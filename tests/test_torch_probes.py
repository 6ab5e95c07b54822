"""The port's probe kernels' plain versions against the TPU probes on the CPU.

Row 12 (scripts/microbench_rolls.py): each plain pattern of
ops/microbench_kernel bit-equal (tolerance 0) to the JAX body it ports, run
through pallas_call(interpret=True) on the CPU, at a few iterations where
the values are still far from 0.  The TPU script is imported by path (it has
a main guard).  Rows 9 and 10 (scripts/probe_floor.py, probe_floor2.py, which
run at import): floor_plain's types and byte counts against the TPU probes'
out shapes, written here from the scripts' out_shape lines."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from polardecoding_tpu.ops.pallas.scl_fast_kernel import LANES, frames_per_tile
from polardecoding_tpu_torch.ops import microbench_kernel as mk
from polardecoding_tpu_torch.ops.probe_kernel import floor_cuda, floor_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_bench():
    """scripts/microbench_rolls.py as a module, the environment it sets on
    import put back."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "microbench_rolls", os.path.join(REPO, "scripts", "microbench_rolls.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def _interpret(kernel, x):
    """One tile [rows, 8, 128] through the TPU body in interpret mode."""
    shape = x.shape
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        scratch_shapes=(pltpu.VMEM(shape, jnp.float32),),
        interpret=True)(jnp.asarray(x)))


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool((a.view(np.int32) == b.view(np.int32)).all())


CASES = ([("gather", dict(L=L), 1, it) for L in (8, 32) for it in (1, 5)]
         + [("gather_rows", dict(L=L, rows=r), r, 3) for L in (8, 32)
            for r in (1, 8)]
         + [("lut", dict(rows=r), r, it) for r in (1, 8) for it in (1, 5)]
         + [("rank", dict(L=L), 1, it) for L in (8, 32) for it in (1, 5)]
         + [("chk", dict(rows=r), r, it) for r in (2, 8) for it in (1, 5)])


@pytest.mark.parametrize("kind,kw,rows,iters", CASES)
def test_pattern_plain_equals_tpu_body(tpu_bench, kind, kw, rows, iters):
    """The plain pattern on [1, rows, 8, 128] bit-equal to the JAX body."""
    body = {"gather": tpu_bench._gather_kernel,
            "gather_rows": tpu_bench._gather_rows_kernel,
            "lut": tpu_bench._lut_kernel, "rank": tpu_bench._rank_kernel,
            "chk": tpu_bench._chk_kernel}[kind]
    x = np.random.default_rng(len(CASES) * rows + iters).normal(
        size=(rows, 8, LANES)).astype(np.float32)
    want = _interpret(functools.partial(body, iters=iters, **kw), x)
    got = mk.microbench_plain(kind, torch.as_tensor(x)[None], iters, kw.get("L", 8))
    assert got.dtype == torch.float32 and _same_bits(got[0], want)
    # still far from 0 (gather halves its values each iteration)
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("kind", mk.KINDS)
def test_pattern_copies_are_independent(kind):
    """Tiles of x [copies, ...] run apart: three at once equal each alone."""
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 2, 8, LANES))
                        .astype(np.float32))
    got = mk.microbench_plain(kind, x, 2)
    for c in range(3):
        assert _same_bits(got[c], mk.microbench_plain(kind, x[c:c + 1], 2)[0])


def test_pattern_op_counts_are_the_tpu_scripts():
    """ops_per_iter is the TPU script's count per iteration and tile."""
    vreg = 8 * LANES
    assert mk.ops_per_iter("gather", 8, 1) == 8 * 4 * vreg
    assert mk.ops_per_iter("gather_rows", 8, 32) == 8 * 4 * 32 * vreg
    assert mk.ops_per_iter("lut", rows=8) == 18 * 8 * vreg
    assert mk.ops_per_iter("rank", 8, 1) == (8 * 12 + 5) * vreg
    assert mk.ops_per_iter("chk", rows=64) == 50 * 32 * vreg


def test_pattern_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 3, 8, LANES)
    with pytest.raises(ValueError, match="even"):
        mk.microbench_plain("chk", x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        mk.microbench_cuda("lut", x, 1)
    with pytest.raises(ValueError, match="unknown"):
        mk.microbench_plain("roll", x, 1)


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("B", [512, 8192])
def test_floor_outputs_match_probe_floor(B):
    """probe_floor.py:98-102 at N=1024, L=8: u (C, 1, N, fs, 128) int8, pm
    (C, 1, 1, fs, 128) float32, tie (C, 1, 1, fs, 128) int32.  u and pm have
    the TPU probe's types and bytes; the tie counter is per frame here (as
    the port's SCL kernel returns it), per lane there: 1/L of its bytes."""
    N, L = 1024, 8
    fpt = frames_per_tile(L, B)
    fs, C = fpt // (LANES // L), B // fpt
    tpu = {"u": ((C, 1, N, fs, LANES), np.int8),
           "pm": ((C, 1, 1, fs, LANES), np.float32),
           "ties": ((C, 1, 1, fs, LANES), np.int32)}
    ch = torch.zeros(B, N)
    leaf = torch.zeros(N, dtype=torch.uint8)
    for init in (False, True):
        u, pm, ties = floor_plain(ch, leaf, L, init=init)
        assert (tuple(u.shape), tuple(pm.shape), tuple(ties.shape)) == (
            (B, L, N), (B, L), (B,))
        for name, t in (("u", u), ("pm", pm), ("ties", ties)):
            shape, dtype = tpu[name]
            assert t.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
            want = int(np.prod(shape)) * np.dtype(dtype).itemsize
            assert _nbytes(t) == (want // L if name == "ties" else want)
            assert not t.any()


@pytest.mark.parametrize("variant,B,kw", [
    ("bare", 8192, {}), ("C16", 2048, {}), ("C4", 512, {}),
    ("noscratch", 8192, {"scratch": False}), ("no_u", 8192, {"u_rows": 1}),
    ("u_i32", 8192, {"u_dtype": torch.int32}),
    ("no_in", 8192, {"dma_in": False})])
def test_floor_outputs_match_probe_floor2(variant, B, kw):
    """probe_floor2.py:75-78 (N=1024, fs=8, C=B/128): u (C, 1, u_rows, fs,
    128) of u_dtype and pm (C, 1, 1, fs, 128) float32, with u_rows N or 1
    and u_dtype int8 or int32: the same types and bytes, two outputs."""
    N, L, fs = 1024, 8, 8
    C = B // (fs * (LANES // 8))
    u_rows = kw.get("u_rows", N)
    u_dtype = kw.get("u_dtype", torch.int8)
    u, pm, ties = floor_plain(torch.zeros(B, N), None, L, ties=False, **kw)
    assert ties is None and u.dtype == u_dtype and pm.dtype == torch.float32
    assert _nbytes(u) == C * u_rows * fs * LANES * u.element_size()
    assert _nbytes(pm) == C * fs * LANES * 4
    assert tuple(u.shape) == (B, L, u_rows) and not u.any() and not pm.any()


def test_floor_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        floor_plain(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="int8 or int32"):
        floor_plain(torch.zeros(4, 8), u_dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        floor_cuda(torch.zeros(4, 8))
