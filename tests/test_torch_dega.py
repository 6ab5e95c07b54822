"""The port's DE-GA predictors (polardecoding_tpu_torch.analysis.dega) and
the GF(2) stage helpers they rest on, against the JAX package and against
the compiled reference programs' outputs in tests/golden/.

Both packages compute these on the host in float64 numpy, operation for
operation, so every output is held bit-equal to the JAX package's
(assert_array_equal, no tolerance) at N=128 on the golden files' SNRs.
Against the golden files the tolerances are tests/test_dega.py's: 2e-6
absolute at N=128 (the files print 6 decimals), rtol 1e-5 with atol 2e-6
for BPRGA_1024.txt, rtol 2e-5 with atol 1e-7 for bprga_1024_W.txt (whose
`-nan` entries are skipped, as there).  At N=1024 only the golden files are
compared, at one SNR each: bit-equality to JAX is shown at N=128.
"""
import filecmp
import os

import numpy as np
import pytest

from polardecoding_tpu.analysis import dega as jdega
from polardecoding_tpu.utils import gf2 as jgf2
from polardecoding_tpu_torch.analysis import dega
from polardecoding_tpu_torch.utils import gf2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")


def _lines(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return f.read().splitlines()


def _bpdega_rows():
    out = {}
    for line in _lines("BPDEGA_128.txt"):
        if line.startswith("bSNR"):
            parts = line.split()
            out[float(parts[2])] = float(parts[5])
    return out


def _e_rows(name, n_cols):
    """Per-iteration E rows in file order: [(iter, E)]."""
    out = []
    for line in _lines(name):
        parts = line.split()
        if len(parts) == n_cols + 1 and not line.startswith("iterMax"):
            try:
                it = int(parts[0])
            except ValueError:
                continue
            out.append((it, np.array([float(p) for p in parts[1:]])))
    return out


def _snr_blocks(name, n_cols):
    """{bSNR: {iter: E}} of a file whose blocks start with a bSNR line."""
    blocks, cur = {}, None
    for line in _lines(name):
        parts = line.split()
        if line.startswith("bSNR"):
            cur = float(parts[2])
            blocks[cur] = {}
        elif len(parts) == n_cols + 1:
            blocks[cur][int(parts[0])] = np.array([float(v) for v in parts[1:]])
    return blocks


def _assert_rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for it in want:
        np.testing.assert_array_equal(got[it], want[it], err_msg=f"iter {it}")


@pytest.mark.parametrize("snr", sorted(_bpdega_rows()))
def test_bpdega(snr):
    got = dega.bpdega(128, 64, snr)
    want = jdega.bpdega(128, 64, snr)
    assert isinstance(got, dega.DegaResult)
    assert (got.snr_db, got.bler, got.ber) == (want.snr_db, want.bler, want.ber)
    np.testing.assert_array_equal(got.means, want.means)
    assert abs(got.bler - _bpdega_rows()[snr]) < 2e-6


def test_bpdega_explicit_frozen_mask():
    """An explicit frozen mask (a GA-constructed code) replaces the 5G one."""
    rng = np.random.default_rng(3)
    frozen = np.ones(128, bool)
    frozen[rng.choice(128, 64, replace=False)] = False
    got = dega.bpdega(128, 64, 2.5, iters=30, frozen=frozen)
    want = jdega.bpdega(128, 64, 2.5, iters=30, frozen=frozen)
    assert (got.bler, got.ber) == (want.bler, want.ber)
    np.testing.assert_array_equal(got.means, want.means)


BPRGA_SNRS = [1.0 + 0.5 * i for i in range(7)]


@pytest.mark.parametrize("p,snr", list(enumerate(BPRGA_SNRS)))
def test_bprga(p, snr):
    got = dega.bprga(128, 64, snr, 28)
    _assert_rows_equal(got, jdega.bprga(128, 64, snr, 28))
    per_point = 14  # reported iterations per SNR in BPRGA_128.txt
    rows = _e_rows("BPRGA_128.txt", 8)[p * per_point:(p + 1) * per_point]
    assert len(rows) == per_point
    for it, want in rows:
        np.testing.assert_allclose(got[it], want, atol=2e-6,
                                   err_msg=f"snr {snr} iter {it}")


def test_bprga_allbit():
    got = dega.bprga_allbit(128, 64, 3.0, 30)  # the reference sweeps 3.0 only
    _assert_rows_equal(got, jdega.bprga_allbit(128, 64, 3.0, 30))
    rows = _e_rows("BPRGA_128_allbit.txt", 8)
    assert len(rows) == len(got)
    for it, want in rows:
        np.testing.assert_allclose(got[it], want, atol=2e-6, err_msg=f"iter {it}")


@pytest.mark.parametrize("snr", [2.0, 2.5, 3.0, 3.5, 4.0])
def test_bprga_w(snr):
    """tests/golden/bprga_128_W.txt: BPRGA_128_W.c fed write_m_dat(128,
    'kao')'s matrices; the CHK chain runs in Kao support order."""
    blocks = _snr_blocks("bprga_128_W.txt", 8)
    assert set(blocks) == {2.0, 2.5, 3.0, 3.5, 4.0}
    got = dega.bprga_w(128, 64, snr, 32)
    _assert_rows_equal(got, jdega.bprga_w(128, 64, snr, 32))
    for it, want in blocks[snr].items():
        np.testing.assert_allclose(got[it], want, atol=2e-6,
                                   err_msg=f"snr {snr} iter {it}")


@pytest.mark.parametrize("snr", [3.0, 3.5, 4.0])
def test_bprga_m(snr):
    blocks = _snr_blocks("bprga_128_M.txt", 8)
    assert set(blocks) == {3.0, 3.5, 4.0}
    got = dega.bprga_m(128, 64, snr, 32)
    _assert_rows_equal(got, jdega.bprga_m(128, 64, snr, 32))
    assert set(got) == set(blocks[snr])
    for it, want in blocks[snr].items():
        np.testing.assert_allclose(got[it], want, atol=2e-6,
                                   err_msg=f"snr {snr} iter {it}")


def test_bprga_1024():
    """BPRGA_1024.c: 30 iterations at 2.5 dB, E reported at 5..9 (0-based)."""
    got = dega.bprga(1024, 512, 2.5, 30, report=lambda it: 5 <= it <= 9)
    rows = _e_rows("BPRGA_1024.txt", 11)
    assert rows
    for it, want in rows:
        np.testing.assert_allclose(got[it], want, rtol=1e-5, atol=2e-6,
                                   err_msg=f"iter {it}")


def test_bprga_w_1024_at_4db():
    """BPRGA_1024_W.c's window int(40 / snr): 10 iterations at 4.0 dB, its
    shortest; the reference reports iterations 5.. and ours > 2."""
    rows = _snr_blocks("bprga_1024_W.txt", 11)[4.0]
    got = dega.bprga_w(1024, 512, 4.0, 40, num_iters=int(40 / 4.0))
    assert rows and set(rows) <= set(got)
    for it, want in rows.items():
        finite = np.isfinite(want)
        assert finite[0]
        np.testing.assert_allclose(got[it][finite], want[finite], rtol=2e-5,
                                   atol=1e-7, err_msg=f"iter {it}")


@pytest.mark.parametrize("N,K", [(8, 4), (128, 64), (1024, 512)])
def test_frozen_stage_masks(N, K):
    got = dega.frozen_stage_masks(N, K)
    np.testing.assert_array_equal(got, jdega.frozen_stage_masks(N, K))
    counts = got.sum(axis=1)
    assert counts[0] == N - K
    assert all(counts[i + 1] <= counts[i] for i in range(len(counts) - 1))


def test_helpers_equal_jax():
    """The union bound, the LUT CHK, the bit-reversal permutation and the
    initial messages, on the same inputs."""
    rng = np.random.default_rng(5)
    a, b = rng.normal(0, 3, 4096), rng.normal(0, 3, 4096)
    np.testing.assert_array_equal(dega._chk_lut(a, b), jdega._chk_lut(a, b))
    m = rng.normal(2, 4, 512)
    assert dega.union_bound(m) == jdega.union_bound(m)
    for N in (2, 64, 1024):
        np.testing.assert_array_equal(dega._bitrev_perm(N), jdega._bitrev_perm(N))
    for fr in (dega.FROZEN_R, dega.FROZEN_R_W):
        got = dega._init_messages(128, 7, 64, 0.8, fr)
        want = jdega._init_messages(128, 7, 64, 0.8, fr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (dega.FROZEN_R, dega.FROZEN_R_W) == (jdega.FROZEN_R, jdega.FROZEN_R_W)
    L, R, _ = dega._init_messages(128, 7, 64, 0.8, dega.FROZEN_R)
    up = dega._project_left(L[7] + R[7], 7, 7, 128)
    L, R, _ = jdega._init_messages(128, 7, 64, 0.8, jdega.FROZEN_R)
    np.testing.assert_array_equal(up, jdega._project_left(L[7] + R[7], 7, 7, 128))


@pytest.mark.parametrize("convention", ["lee", "kao"])
@pytest.mark.parametrize("N", [2, 16, 128])
def test_gf2_stage_helpers(N, convention):
    n = N.bit_length() - 1
    for i in range(n):
        np.testing.assert_array_equal(gf2._stage_matrix(N, i, convention),
                                      jgf2._stage_matrix(N, i, convention))
    got = gf2.stage_transfer_matrices(N, convention)
    want = jgf2.stage_transfer_matrices(N, convention)
    assert len(got) == len(want) == n + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = gf2.stage_projection_supports(N, convention)
    want = jgf2.stage_projection_supports(N, convention)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # stage 0 is the identity: bit b's support is b alone
    assert all(list(got[0][b]) == [b] for b in range(N))


@pytest.mark.parametrize("convention", ["lee", "kao"])
def test_write_m_dat_byte_equal(tmp_path, convention):
    ours, theirs = tmp_path / "ours.dat", tmp_path / "theirs.dat"
    gf2.write_m_dat(128, str(ours), convention)
    jgf2.write_m_dat(128, str(theirs), convention)
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert ours.stat().st_size > 0


def test_encode_dense():
    rng = np.random.default_rng(9)
    for N in (8, 128, 1024):
        u = rng.integers(0, 2, (5, N)).astype(np.int8)
        G = gf2.dense_generator(N)
        got = gf2.encode_dense(u, G)
        want = jgf2.encode_dense(u, jgf2.dense_generator(N))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
