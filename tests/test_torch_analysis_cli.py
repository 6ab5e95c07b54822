"""The port's host tools against the JAX package: `cli analyze` (each of the
five DE-GA tools, N=128 at few iterations, and bprga_w's N >= 1024 window),
`cli plot` over `cli run --device cpu` records, the plotting module's
reference tables, and the small helpers golden mode and the analysis use:
crc_syndrome / crc_passes, payload_offsets / payload_bits_host,
bit_reversal, encode_dense and llr_from_y.  Every comparison is exact: the
printed JSON equal, arrays bit-equal.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import cli as jcli
from polardecoding_tpu import plotting as jplot
from polardecoding_tpu.ops import channel as jchannel
from polardecoding_tpu.ops import crc as jcrc
from polardecoding_tpu.utils import gf2 as jgf2
from polardecoding_tpu.utils import pn as jpn
from polardecoding_tpu.utils import sequences as jseq
from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import plotting as tplot
from polardecoding_tpu_torch.ops import channel as tchannel
from polardecoding_tpu_torch.ops import crc as tcrc
from polardecoding_tpu_torch.utils import gf2, pn, sequences


def _printed(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("argv", [
    ["--tool", "bpdega", "--iters", "20", "--snr", "1.0", "2.0"],
    ["--tool", "bpdega", "--N", "64", "--K", "32", "--iters", "10"],
    ["--tool", "bprga", "--iters", "6", "--snr", "2.0", "3.0"],
    ["--tool", "bprga_allbit", "--iters", "20", "--snr", "3.0"],
    ["--tool", "bprga_w", "--iters", "24", "--snr", "3.0"],
    ["--tool", "bprga_w", "--N", "1024", "--K", "512", "--iters", "12",
     "--snr", "4.0"],
    ["--tool", "bprga_m", "--iters", "24", "--snr", "3.0", "3.5"],
], ids=lambda a: "-".join(a[1::2][:2]))
def test_cli_analyze_equals_jax(argv, capsys):
    got = _printed(tcli.main, ["analyze"] + argv, capsys)
    want = _printed(jcli.main, ["analyze"] + argv, capsys)
    assert got == want
    assert got and all(got.values())


def test_cli_analyze_refuses_an_unknown_tool(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["analyze", "--tool", "bprga_x"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_plot_writes_a_png(tmp_path, capsys):
    """`cli run --device cpu` records (a list, and one record alone) through
    `cli plot`: a PNG, and load_records equal to the JAX package's."""
    rec = tmp_path / "bp128.json"
    tcli.main(["run", "--preset", "BP_128", "--snr", "2.0", "3.0", "1.0",
               "--batch", "32", "--max-frames", "64", "--device", "cpu",
               "--out", str(rec)])
    capsys.readouterr()
    one = tmp_path / "one.json"
    one.write_text(json.dumps(json.loads(rec.read_text())[0]))
    paths = [str(rec), str(one)]
    records = tplot.load_records(paths)
    assert records == jplot.load_records(paths)
    assert len(records) == 3 and {r["preset"] for r in records} == {"BP_128"}
    png = tmp_path / "bler.png"
    tcli.main(["plot", *paths, "--out", str(png), "--title", "BP_128"])
    assert capsys.readouterr().out.strip() == f"wrote {png}"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_reference_tables_equal_jax():
    assert tplot.REFERENCE_BLER == jplot.REFERENCE_BLER
    assert tplot.PO_CHUNG == jplot.PO_CHUNG
    assert tplot.REFERENCE_SCL_BY_L == jplot.REFERENCE_SCL_BY_L


@pytest.mark.parametrize("exps", [tcrc.CRC6_EXPONENTS, tcrc.CRC24_EXPONENTS],
                         ids=["crc6", "crc24"])
def test_crc_syndrome_and_passes_equal_jax(exps):
    """Random bits [B, L, K + r] and CRC-encoded words, which must pass."""
    K, r = 64, max(exps)
    R = tcrc.check_matrix(exps, K + r)
    rng = np.random.default_rng(r)
    bits = rng.integers(0, 2, (16, 8, K + r)).astype(np.int8)
    words = tcrc.crc_encode_multiplicative(
        torch.as_tensor(rng.integers(0, 2, (16, 8, K)).astype(np.int8)), exps)
    for b in (bits, words.numpy()):
        got = tcrc.crc_syndrome(torch.as_tensor(b), R)
        want = np.asarray(jcrc.crc_syndrome(jnp.asarray(b), R))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcrc.crc_passes(torch.as_tensor(b), R).numpy(),
            np.asarray(jcrc.crc_passes(jnp.asarray(b), R)))
    assert bool(tcrc.crc_passes(words, R).all())
    assert not bool(tcrc.crc_passes(torch.as_tensor(bits), R).all())


def test_payload_helpers_equal_jax():
    idx = np.arange(0, 5000, 7)
    for k in (1, 64, 512, 1000):
        got, want = pn.payload_offsets(idx, k), jpn.payload_offsets(idx, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for f in (0, 1, 62, 63, 100, 2**20 + 3):
            a, b = pn.payload_bits_host(f, k), jpn.payload_bits_host(f, k)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bit_reversal_and_encode_dense_equal_jax():
    rng = np.random.default_rng(11)
    for N in (1, 2, 8, 128, 1024):
        got = sequences.bit_reversal(N)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jseq.bit_reversal(N))
        np.testing.assert_array_equal(got[got], np.arange(N))
        u = rng.integers(0, 2, (3, N)).astype(np.uint8)
        np.testing.assert_array_equal(
            gf2.encode_dense(u, gf2.dense_generator(N)),
            jgf2.encode_dense(u, jgf2.dense_generator(N)))
    with pytest.raises(ValueError):
        sequences.bit_reversal(12)


def test_llr_from_y_equals_jax():
    rng = np.random.default_rng(13)
    y = (1.0 + rng.normal(0, 0.9, (64, 128))).astype(np.float32)
    for snr in (-2.0, 1.0, 2.0, 6.0):
        sigma = 10.0 ** (-snr / 20.0)
        got = tchannel.llr_from_y(torch.as_tensor(y), sigma)
        want = np.asarray(jchannel.llr_from_y(jnp.asarray(y), sigma))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
