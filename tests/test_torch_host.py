"""Port host data against the JAX package: presets, construction tables, PN
sequence, generator matrices and CRC, all equal."""
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
from polardecoding_tpu_torch.ops import crc as tcrc
from polardecoding_tpu_torch.ops import encode as tenc
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
