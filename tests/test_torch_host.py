"""Port host data against the JAX package: presets, construction tables, PN
sequence, generator matrices and CRC, all equal; the CRC matrices on the
device, built once a step."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.analysis import construction as jcons
from polardecoding_tpu.ops import crc as jcrc
from polardecoding_tpu.ops import encode as jenc
from polardecoding_tpu.utils import _q_tables as jq
from polardecoding_tpu.utils import gf2 as jgf2
from polardecoding_tpu.utils import pn as jpn
from polardecoding_tpu.utils import sequences as jseq
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.analysis import construction as tcons
from polardecoding_tpu_torch.models import scl as tscl
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.ops import crc as tcrc
from polardecoding_tpu_torch.ops import encode as tenc
from polardecoding_tpu_torch.parallel import harness as th
from polardecoding_tpu_torch.utils import _q_tables as tq
from polardecoding_tpu_torch.utils import gf2 as tgf2
from polardecoding_tpu_torch.utils import pn as tpn
from polardecoding_tpu_torch.utils import sequences as tseq


def test_presets_equal_field_by_field():
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name, jp in jcfg.PRESETS.items():
        tp = tcfg.preset(name)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp), name
        assert tp.code.n == jp.code.n and tp.code.num_info == jp.code.num_info
        assert tp.sweep.snr_points() == jp.sweep.snr_points(), name
    with pytest.raises(KeyError):
        tcfg.preset("NOPE")
    with pytest.raises(ValueError):
        tcfg.CodeConfig(100, 50)


def test_q_tables_info_sets_and_frozen_masks():
    assert tq.Q128 == jq.Q128 and tq.Q1024 == jq.Q1024
    for N in (8, 16, 64, 128, 256, 1024):
        assert (tseq.reliability_sequence(N)
                == jseq.reliability_sequence(N)).all()
        for num_info in (1, N // 4, N // 2, N // 2 + 6, N - 1):
            assert (tseq.info_set(N, num_info) == jseq.info_set(N, num_info)).all()
            assert (tseq.frozen_mask(N, num_info)
                    == jseq.frozen_mask(N, num_info)).all()


@pytest.mark.parametrize("name", sorted(
    {p.name for p in jcfg.PRESETS.values()
     if p.code.construction != "5g" or p.code.N == 1024}
    | {"BP_128", "BP_128_fag", "CASCL_128_L8"}))
def test_code_info_set_and_frozen_mask_per_preset(name):
    jc, tc = jcfg.preset(name).code, tcfg.preset(name).code
    assert (tcons.code_info_set(tc) == jcons.code_info_set(jc)).all()
    assert (tcons.code_frozen_mask(tc) == jcons.code_frozen_mask(jc)).all()


@pytest.mark.parametrize("construction", ["ga_sc", "bp_dega"])
def test_reliability_order_constructions(construction):
    for N, snr in ((64, 1.5), (256, 2.0)):
        assert (tcons.reliability_order(N, construction, snr)
                == jcons.reliability_order(N, construction, snr)).all()


def test_pn_dense_generator_and_info_rows():
    assert (tpn.pn_sequence() == jpn.pn_sequence()).all()
    assert tpn.PN_PERIOD == jpn.PN_PERIOD
    for N in (8, 128, 1024):
        assert (tgf2.dense_generator(N) == jgf2.dense_generator(N)).all()
        I = jseq.info_set(N, N // 2)
        assert (tenc.info_sub_generator(I, N)
                == jenc.info_sub_generator(I, N)).all()


@pytest.mark.parametrize("exps", [jcrc.CRC6_EXPONENTS, jcrc.CRC24_EXPONENTS])
def test_crc_matrices_and_encoders(exps):
    assert tcrc.CRC6_EXPONENTS == jcrc.CRC6_EXPONENTS
    assert tcrc.CRC24_EXPONENTS == jcrc.CRC24_EXPONENTS
    k = 64 if max(exps) == 6 else 512
    assert (tcrc.check_matrix(exps, k + max(exps))
            == jcrc.check_matrix(exps, k + max(exps))).all()
    assert (tcrc.multiplicative_encode_matrix(exps, k)
            == jcrc.multiplicative_encode_matrix(exps, k)).all()
    assert (tcrc.systematic_parity_matrix(exps, k)
            == jcrc.systematic_parity_matrix(exps, k)).all()
    m = np.random.default_rng(3).integers(0, 2, (9, k)).astype(np.int8)
    for tf, jf in ((tcrc.crc_encode_multiplicative, jcrc.crc_encode_multiplicative),
                   (tcrc.crc_encode_systematic, jcrc.crc_encode_systematic)):
        got = tf(torch.as_tensor(m), exps)
        assert got.dtype == torch.int8
        assert (got.numpy() == np.asarray(jf(jnp.asarray(m), exps))).all()


# a CA-SCL preset of each CRC the presets use: (preset, exponents, style)
CRC_CASES = {
    "crc6_multiplicative": ("CASCL_128_L8", tcrc.CRC6_EXPONENTS, "multiplicative"),
    "crc24_multiplicative": ("CASCL_1024_L8", tcrc.CRC24_EXPONENTS, "multiplicative"),
    "crc24_systematic": ("CASCL_1024_sys_L8", tcrc.CRC24_EXPONENTS, "systematic"),
}


@pytest.mark.parametrize("case", sorted(CRC_CASES))
def test_crc_ops_give_the_same_bits_with_a_prebuilt_matrix(case):
    name, exps, style = CRC_CASES[case]
    code = tcfg.preset(name).code
    assert code.crc == exps and code.crc_style == style
    k = code.K
    rng = np.random.default_rng(5)
    m = torch.as_tensor(rng.integers(0, 2, (9, k)).astype(np.int8))
    E = tcrc.multiplicative_encode_matrix(exps, k)
    Gc = tcrc.systematic_parity_matrix(exps, k)
    R = tcrc.check_matrix(exps, code.num_info)
    for M in (E, Gc):
        want = tcrc.gf2_matmul(m, M)
        got = tcrc.gf2_matmul(m, tcrc.device_matrix(M, "cpu"))
        assert got.dtype == torch.int8 and torch.equal(got, want)
    with pytest.raises(ValueError):
        tcrc.gf2_matmul(m, torch.as_tensor(E))  # uint8: not the prebuilt form
    mult = tcrc.crc_encode_multiplicative(m, exps)
    assert torch.equal(tcrc.crc_encode_multiplicative(
        m, exps, tcrc.device_matrix(E, "cpu")), mult)
    syst = tcrc.crc_encode_systematic(m, exps)
    assert torch.equal(tcrc.crc_encode_systematic(
        m, exps, tcrc.device_matrix(Gc, "cpu")), syst)
    # paths 0 and 2 of the first 5 frames carry codewords: some frames pass
    # on one path or two, the rest on none
    L = 4
    info = torch.as_tensor(tcons.code_info_set(code), dtype=torch.int64)
    u_all = torch.as_tensor(rng.integers(0, 2, (9, L, code.N)).astype(np.int8))
    words = syst if style == "systematic" else mult
    u_all[:5, 0, info] = words[:5]
    u_all[:3, 2, info] = words[5:8]
    PM = torch.as_tensor(rng.random((9, L)).astype(np.float32))
    want_u, want_ok = tscl.cascl_select(u_all, PM, info, R)
    got_u, got_ok = tscl.cascl_select(u_all, PM, info, tcrc.device_matrix(R, "cpu"))
    assert want_ok.tolist() == [True] * 5 + [False] * 4
    assert torch.equal(got_u, want_u) and torch.equal(got_ok, want_ok)


@pytest.mark.parametrize("case", sorted(CRC_CASES))
def test_a_ca_scl_step_copies_its_crc_matrices_only_when_built(case):
    before = tcrc.COPIES
    step = th.make_frame_step(tcfg.preset(CRC_CASES[case][0]), 2, device="cpu")
    built = tcrc.COPIES
    assert built == before + 2  # the encode matrix and the check matrix
    key = tch.prng_key(7, "cpu")
    for i in range(3):
        step(key, 2 * i, 0.8)
    assert tcrc.COPIES == built
