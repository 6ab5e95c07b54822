"""The port's approximate rate-1 SCL flavor (r1 > 0) against the JAX package
on the CPU: the node decomposition equal to JAX's, the plain flavor bit-equal
(u_all, path metrics, tie counters; tolerance 0) to the numpy twin
tests/scl_fast_ref.py and to the TPU kernel scl_decode_fast in interpret
mode, a frame where the flavor and exact SCL differ, CA-SCL's selection,
and the _FASTR1 frame step, run_point and CLI against the JAX package's own
step with the twin as its kernel."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scl_fast_ref import decode_batch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu.models import scl as jscl
from polardecoding_tpu.ops.crc import check_matrix
from polardecoding_tpu.ops.pallas import scl_fast_kernel as jfast
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.utils.sequences import frozen_mask
from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.models import scl as tscl
from polardecoding_tpu_torch.models import scl_fast as tfast
from polardecoding_tpu_torch.ops import scl_kernel
from polardecoding_tpu_torch.ops.channel import prng_key
from polardecoding_tpu_torch.parallel import harness as th

# the MIXED32 mask of tests/test_scl_fast.py: R0, REP, SPC and mixed nodes
MIXED32 = np.array(
    [1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0], bool)
FASTR1 = ("SCL_128_L8_FASTR1", "SCL_1024_L8_FASTR1", "CASCL_1024_L8_FASTR1",
          "SCL_1024_L16_FASTR1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain decoders run thousands of small tensor operations, for which
    intra-op threads cost far more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mask(name):
    return np.asarray(code_frozen_mask(jcfg.preset(name).code), bool)


def _tree(nd):
    """A node tree of either package as nested tuples."""
    if nd.kind == "branch":
        return ("branch", nd.stage, nd.off, _tree(nd.left), _tree(nd.right))
    return (nd.kind, nd.stage, nd.off, nd.has_frozen)


def _port_r1(llr, frozen, L, r1, wloop=2):
    out = tscl.scl_decode(torch.as_tensor(llr), torch.as_tensor(frozen),
                          list_size=L, return_all=True, return_ties=True,
                          r1=r1, wloop=wloop)
    return [x.numpy() for x in out]


def _assert_same(got, want):
    u, pm, ties = got
    assert u.dtype == np.int8 and pm.dtype == np.float32 and ties.dtype == np.int32
    for g, w in zip(got, want):
        assert g.shape == w.shape and (np.asarray(w) == g).all()


@pytest.mark.parametrize("mask", [*FASTR1, "MIXED32", "all-info 32",
                                  "all-info 1024"])
def test_decompose_equals_jax(mask):
    """The same tree (kinds, stages, offsets) and schedule_stats as JAX's
    for wloop in {2, 4} and r1 in {0, 2, 4}; an R1 node holds no frozen bit
    and starts where r1_stages says."""
    fr = {"MIXED32": MIXED32, "all-info 32": np.zeros(32, bool),
          "all-info 1024": np.zeros(1024, bool)}.get(mask)
    if fr is None:
        fr = _mask(mask)
    frt = tuple(bool(b) for b in fr)
    N = len(frt)
    n = N.bit_length() - 1
    for wloop in (2, 4):
        assert tfast.schedule_stats(frt, wloop) == jfast.schedule_stats(frt, wloop)
        for r1 in (0, 2, 4):
            want = jfast.decompose(frt, n, 0, wloop, r1)
            got = tfast.decompose(frt, n, 0, wloop, r1)
            assert _tree(got) == _tree(want)
            starts = {}

            def walk(nd):
                if nd.kind == "branch":
                    walk(nd.left)
                    walk(nd.right)
                elif nd.kind == "r1":
                    assert not any(frt[nd.off:nd.off + (1 << nd.stage)])
                    starts[nd.off] = nd.stage

            walk(got)
            assert bool(starts) == (r1 > 0)
            stages = tfast.r1_stages(fr, r1, wloop)
            assert {j: s for j, s in enumerate(stages) if s} == starts


# the five cases of tests/test_scl_fast.py's twin parity test, then
# SCL_128_L8_FASTR1's mask at L=8 and L=16, and MIXED32 at wloop 4, whose
# loop nodes hide the width-2 R1 nodes that wloop 2 finds
TWIN_CASES = [
    (np.zeros(32, bool), 4, 2, 32),   # root R1 (w=32, t=3)
    (np.zeros(16, bool), 8, 2, 16),   # root R1 w=16, t=7
    (np.asarray(frozen_mask(32, 20)), 4, 2, 32),
    (np.asarray(frozen_mask(32, 20)), 8, 4, 32),
    (np.asarray(frozen_mask(64, 32)), 2, 2, 64),
    ("SCL_128_L8_FASTR1", 8, 4, 16),
    ("SCL_128_L8_FASTR1", 16, 4, 16),
    (MIXED32, 4, 2, 32, 4),
]


@pytest.mark.parametrize("case", TWIN_CASES)
def test_plain_flavor_equals_twin(case):
    fr, L, r1, B, wloop = (*case, 2)[:5]
    fr = _mask(fr) if isinstance(fr, str) else fr
    rng = np.random.default_rng(3)
    llr = (rng.normal(size=(B, len(fr))) * 3).astype(np.float32)
    launches = scl_kernel.LAUNCHES_R1
    _assert_same(_port_r1(llr, fr, L, r1, wloop),
                 decode_batch(llr, fr, L, wloop=wloop, r1min=r1))
    assert scl_kernel.LAUNCHES_R1 == launches  # a CPU tensor takes the plain path
    if wloop > 2:
        assert tfast.r1_stages(fr, r1, wloop) != tfast.r1_stages(fr, r1, 2)


@pytest.mark.parametrize("L,r1", [(4, 2), (8, 4)])
def test_plain_flavor_forced_ties(L, r1):
    """Symmetric +-1 LLRs force exact PM ties inside the R1 nodes' forks."""
    fr = np.asarray(frozen_mask(32, 20))
    llr = np.tile(np.array([1.0, -1.0] * 16, np.float32), (16, 1))
    want = decode_batch(llr, fr, L, wloop=2, r1min=r1)
    assert want[2].sum() > 0
    _assert_same(_port_r1(llr, fr, L, r1), want)


@pytest.mark.parametrize("fr,L,r1,B", [TWIN_CASES[1], TWIN_CASES[2]])
def test_plain_flavor_equals_interpret_kernel(fr, L, r1, B):
    """The TPU kernel itself, run by Pallas's interpreter: its R1 nodes
    (run_r1) against the port's plain flavor."""
    rng = np.random.default_rng(5)
    llr = (rng.normal(size=(B, len(fr))) * 3).astype(np.float32)
    want = jfast.scl_decode_fast(jnp.asarray(llr), tuple(bool(b) for b in fr),
                                 list_size=L, wloop=2, r1=r1, interpret=True)
    _assert_same(_port_r1(llr, fr, L, r1), [np.asarray(x) for x in want])


def test_flavor_differs_from_exact_on_the_witness_frame():
    """The flavor is not exact SCL: on tests/test_scl_fast.py's documented
    input (seed 1024, N=32 K=20, L=4, r1=2) frame 3 decodes differently, so
    the port does not quietly decode exact."""
    fr = np.asarray(frozen_mask(32, 20))
    rng = np.random.default_rng(1024)
    llr = torch.as_tensor((rng.normal(size=(64, 32)) * 2.5 + 2.0).astype(np.float32))
    frt = torch.as_tensor(fr)
    exact = tscl.scl_decode(llr, frt, list_size=4)
    flavor = tscl.scl_decode(llr, frt, list_size=4, r1=2)
    d = (exact != flavor).any(dim=1)
    assert bool(d[3])
    assert (flavor.numpy() == tscl.scl_decode_auto(llr, frt, list_size=4,
                                                   r1=2).numpy()).all()


def test_cascl_flavor_equals_jax_select_of_twin():
    """CA-SCL with r1=4 on CASCL_128_L8's CRC-6 code: the port's
    cascl_decode equals JAX's cascl_select applied to the twin's paths."""
    code = jcfg.preset("CASCL_128_L8").code
    fr = np.asarray(code_frozen_mask(code), bool)
    info = np.asarray(code_info_set(code))
    R = check_matrix(code.crc, code.num_info)
    rng = np.random.default_rng(6)
    llr = (rng.normal(size=(24, 128)) * 2.0 + 1.0).astype(np.float32)
    u_all, PM, _ = decode_batch(llr, fr, 8, wloop=2, r1min=4)
    want, _ = jscl.cascl_select(jnp.asarray(u_all), jnp.asarray(PM), info, R)
    got = tscl.cascl_decode(torch.as_tensor(llr), torch.as_tensor(fr),
                            torch.as_tensor(info), R, list_size=8, r1=4)
    assert (got.numpy() == np.asarray(want)).all()


@pytest.fixture
def jax_twin_kernel(monkeypatch):
    """The JAX package's SCL dispatch with the numpy twin as its kernel, so
    that its own frame step (payload, CRC, encode, channel LLRs, counters)
    decodes the rate-1 flavor on the CPU, where it would decode exact."""
    def kernel(ch_llr, frozen, list_size, r1=0):
        B, N = ch_llr.shape
        fr = np.asarray(frozen, bool)
        wloop = jscl.default_wloop(N.bit_length() - 1, list_size)
        out = (jax.ShapeDtypeStruct((B, list_size, N), jnp.int8),
               jax.ShapeDtypeStruct((B, list_size), jnp.float32),
               jax.ShapeDtypeStruct((B,), jnp.int32))
        return jax.pure_callback(
            lambda llr: decode_batch(np.asarray(llr), fr, list_size,
                                     wloop=wloop, r1min=r1), out, ch_llr)

    monkeypatch.setattr(jscl, "_pallas_ok", lambda *a, **k: True)
    monkeypatch.setattr(jscl, "_scl_kernel", kernel)


@pytest.mark.parametrize("snr_db", [1.0, 2.0])
def test_fastr1_frame_step_equals_jax(jax_twin_kernel, snr_db):
    name, batch = "SCL_128_L8_FASTR1", 32
    sigma = 10.0 ** (-snr_db / 20.0)
    want = [int(v) for v in jh.make_frame_step(jcfg.preset(name), batch)(
        jax.random.PRNGKey(9), jnp.int32(batch), jnp.float32(sigma))]
    launches = (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1)
    got = [int(v) for v in th.make_frame_step(tcfg.preset(name), batch, "cpu")(
        prng_key(9), batch, sigma)]
    assert got == want
    assert (scl_kernel.LAUNCHES, scl_kernel.LAUNCHES_R1) == launches
    if snr_db == 1.0:
        assert want[1] > 0


def test_fastr1_cli_run_equals_jax_run_point(jax_twin_kernel, capsys):
    """`cli run` (run_sweep -> run_point -> the flavor's frame step) on the
    CPU: its record equals the JAX package's run_point at sync_every=1."""
    name = "SCL_128_L8_FASTR1"
    tcli.main(["run", "--preset", name, "--snr", "1.5", "--error-blocks", "3",
               "--batch", "32", "--device", "cpu"])
    (rec,) = json.loads(capsys.readouterr().out)
    want = jh.run_point(jcfg.preset(name), 1.5, batch=32, error_blocks=3,
                        sync_every=1)
    assert [rec[k] for k in ("errbit", "errblock", "frames", "pm_ties")] == [
        want.errbit, want.errblock, want.frames, want.pm_ties]
    assert rec["errblock"] >= 3
