"""The port's Monte-Carlo harness against the JAX package's on the CPU: frame
step counters, run_point results, checkpoint resume, the entry point and the
CLI."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.analysis.construction import code_frozen_mask, code_info_set
from polardecoding_tpu.models.bp import bp_decode as jax_bp_decode
from polardecoding_tpu.ops.channel import awgn_llr as jax_awgn_llr
from polardecoding_tpu.ops.encode import info_sub_generator
from polardecoding_tpu.parallel import harness as jh
from polardecoding_tpu.utils.pn import pn_sequence
from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.convert import code_tables_from_numpy
from polardecoding_tpu_torch.entry import entry
from polardecoding_tpu_torch.models.bp import bp_decode_auto
from polardecoding_tpu_torch.ops import bp_kernel
from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
from polardecoding_tpu_torch.parallel import harness as th

SIGMA_2DB = 10.0 ** (-2.0 / 20.0)


def _jax_tables(name):
    """The JAX package's construction arrays for a preset, through convert."""
    code = jcfg.preset(name).code
    I = code_info_set(code)
    return code_tables_from_numpy(code_frozen_mask(code), I, pn_sequence(),
                                  info_sub_generator(I, code.N), "cpu")


# (preset, batch, seed, frame_start): N=1024 only at a small batch, where
# each plain CPU decode is cheap enough for tier-1
STEP_CASES = [("BP_128", 64, 1024, 0), ("BP_128", 64, 7, 4096),
              ("BP_1024", 16, 1024, 0)]


@pytest.mark.parametrize("name,batch,seed,frame_start", STEP_CASES)
def test_frame_step_counters_equal_jax(name, batch, seed, frame_start):
    """Same (seed, frame_start, sigma), same counters, for both encoders of
    the port (the JAX step uses its default MXU encoder).  Equality needs
    the channel LLRs bit-equal, since a frame BP does not converge on moves
    with any ulp of its input: the port's channel reproduces the float32
    arithmetic XLA compiles for an x86 CPU with FMA (ops/noise.py)."""
    key = jax.random.PRNGKey(seed)
    want = [int(v) for v in jh.make_frame_step(jcfg.preset(name), batch)(
        key, jnp.int32(frame_start), jnp.float32(SIGMA_2DB))]
    assert want[1] > 0  # some frames fail, so the counters are informative
    tables = _jax_tables(name)
    for encoder in ("mxu", "butterfly"):
        step = th.make_frame_step(tcfg.preset(name), batch, "cpu",
                                  encoder=encoder, tables=tables)
        got = [int(v) for v in step(prng_key(seed), frame_start, SIGMA_2DB)]
        assert got == want, encoder


def test_decode_of_jax_llrs_gives_jax_counters():
    """JAX's own channel LLRs through the port's decoder: u_hat and the
    counters equal JAX's decoder's exactly, with the channel taken out of
    the comparison."""
    p = jcfg.preset("BP_128")
    N, K, B = p.code.N, p.code.K, 64
    I = code_info_set(p.code)
    frozen = code_frozen_mask(p.code)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 200)
    fidx = jnp.arange(B, dtype=jnp.int32)
    w = jh.payload_from_index(fidx, jnp.asarray(pn_sequence()), K)
    x = jh._make_encoder("mxu", I, N)(w)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
    llr = np.array(jax_awgn_llr(x, keys, jnp.float32(SIGMA_2DB)))
    want = np.asarray(jax_bp_decode(jnp.asarray(llr), jnp.asarray(frozen)))
    got = bp_decode_auto(torch.as_tensor(llr), torch.as_tensor(frozen)).numpy()
    assert (got == want).all()
    w = np.asarray(w)
    bad_j, bad_t = want[:, I] != w, got[:, I] != w
    assert bad_j.any(axis=1).sum() > 0
    assert [bad_t.sum(), bad_t.any(axis=1).sum()] == [bad_j.sum(),
                                                      bad_j.any(axis=1).sum()]


def _fields(res):
    d = dict(vars(res))
    d.pop("elapsed_s")
    return d


@pytest.mark.parametrize("error_blocks,max_frames", [(6, 1 << 20), (10 ** 6, 128)])
def test_run_point_equals_jax(error_blocks, max_frames):
    """run_point stops on the error-block target or the frame cap after the
    same frames as JAX's sync_every=1 path: equal PointResults."""
    kw = dict(batch=64, error_blocks=error_blocks, max_frames=max_frames)
    want = jh.run_point(jcfg.preset("BP_128"), 2.5, sync_every=1, **kw)
    got = th.run_point(tcfg.preset("BP_128"), 2.5, device="cpu", **kw)
    assert _fields(got) == _fields(want)
    assert got.frames % 64 == 0


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A run_sweep checkpoint written by the JAX package resumes in the
    port's run_sweep and continues with the frames after it: the result is
    the JAX package's uninterrupted run."""
    ck = str(tmp_path / "ck.json")
    kw = dict(batch=64, snr_points=[2.5], max_frames=1 << 20)
    jh.run_sweep(jcfg.preset("BP_128"), error_blocks=3, checkpoint_path=ck, **kw)
    with open(ck) as f:
        first = json.load(f)[0]
    got = th.run_sweep(tcfg.preset("BP_128"), device="cpu", error_blocks=8,
                       checkpoint_path=ck, **kw)
    want = jh.run_point(jcfg.preset("BP_128"), 2.5, batch=64, error_blocks=8,
                        max_frames=1 << 20, sync_every=1)
    assert first["frames"] < got[0].frames
    assert _fields(got[0]) == _fields(want)
    with open(ck) as f:
        rec = json.load(f)[0]
    assert rec["frames"] == got[0].frames and rec["errblock"] >= 8


def test_out_of_slice_paths_raise():
    """The approximate rate-1 SCL presets build their frame steps; a BPr
    preset has no frame step (it runs on make_bpr_step, as in the JAX
    package, whose frame step refuses it); an unknown channel or noise
    source raises."""
    for name in ("SCL_1024_L8_FASTR1", "SCL_1024_L16_FASTR1"):
        assert callable(th.make_frame_step(tcfg.preset(name), 8, "cpu"))
    with pytest.raises(ValueError, match="make_bpr_step"):
        th.make_frame_step(tcfg.preset("BPr_128"), 8, "cpu")
    with pytest.raises(ValueError, match="make_bpr_step"):
        th.run_sweep(tcfg.preset("BPr_128"), device="cpu")
    with pytest.raises(ValueError, match="channel"):
        th.make_frame_step(tcfg.preset("BP_128"), 8, "cpu", channel="awgn")
    with pytest.raises(ValueError, match="noise"):
        th.make_frame_step(tcfg.preset("BP_128"), 8, "cpu", channel="mc",
                           noise="hw")


def test_early_stop_preset_frame_step_equals_jax():
    """make_frame_step takes an early-stop preset through the decoder's
    latched early stop (the kernel's early-stop mode on the card)."""
    key = jax.random.PRNGKey(3)
    p = "BP_1024_ES"
    want = [int(v) for v in jh.make_frame_step(jcfg.preset(p), 8)(
        key, jnp.int32(0), jnp.float32(SIGMA_2DB))]
    got = [int(v) for v in th.make_frame_step(tcfg.preset(p), 8, "cpu")(
        prng_key(3), 0, SIGMA_2DB)]
    assert got == want


@pytest.fixture
def one_thread():
    """One torch thread: the plain decoder's tensors are [256, 1024], and
    test workers side by side, each with a thread a core, oversubscribe the
    CPU (six workers of eight threads on eight cores ran this test about
    18 times slower than one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_runs(one_thread):
    """The counterpart of __graft_entry__.entry: the BP_1024 step at batch
    256 with its arguments (key from the preset's seed, frame 0, 2.0 dB),
    run on the CPU through the plain decoder."""
    step, (key, frame_start, sigma) = entry("cpu")
    assert (key == prng_key(1024)).all() and frame_start == 0
    assert sigma == pytest.approx(SIGMA_2DB)
    launches = bp_kernel.LAUNCHES
    eb, ebl, ties = (int(v) for v in step(key, frame_start, sigma))
    assert 0 < ebl < 256 and eb >= ebl and ties == 0
    assert bp_kernel.LAUNCHES == launches


def test_cli_presets_and_run(capsys, tmp_path):
    tcli.main(["presets"])
    out = capsys.readouterr().out
    assert "BP_1024" in out and "SCL_1024_L8" in out
    dest = tmp_path / "r.json"
    tcli.main(["run", "--preset", "BP_128", "--snr", "3.0", "--error-blocks",
               "5", "--batch", "64", "--device", "cpu", "--out", str(dest)])
    recs = json.loads(capsys.readouterr().out)
    assert recs == json.loads(dest.read_text())
    (rec,) = recs
    assert rec["preset"] == "BP_128" and rec["snr_db"] == 3.0
    assert rec["errblock"] >= 5 and rec["frames"] % 64 == 0
    assert rec["seed"] == 1024 and 0 < rec["bler"] < 1


def test_point_key_is_jax_point_key():
    key = jax.random.fold_in(jax.random.PRNGKey(1024), 250)
    assert (fold_in(prng_key(1024), 250).numpy()
            == np.asarray(key).astype(np.int64)).all()
