"""The port's other sweeps against the JAX package on the CPU: the frame
channel with a per-frame sigma (the plain version of csrc/frame_channel.cu's
sigma table) against JAX's awgn_llr with a sigma vector under jit; the
fused SNR sweep (make_multisnr_step, run_fused_sweep, with llr_dtype
bfloat16 on the plain decoders); run_multiseed and `cli run --seeds`; and
run_point's chunked counter reads (sync_every).  Counters are bit-equal.
The cuda-marked test holds the kernel's sigma table against its plain
version on a card and skips here; on a GPU machine, which has no jax:

  python -m pytest --noconftest -q -m cuda tests/test_torch_sweeps.py
"""
import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from polardecoding_tpu import cli as jcli
    from polardecoding_tpu import configs as jcfg
    from polardecoding_tpu.ops.channel import awgn_llr as jax_awgn_llr
    from polardecoding_tpu.parallel import harness as jh
except ImportError:  # a GPU machine: only the cuda-marked test runs there
    jax = None

from polardecoding_tpu_torch import cli as tcli
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.parallel import harness as th


def _sigmas(snrs):
    return [10.0 ** (-s / 20.0) for s in snrs]


def _fields(r):
    return (r.preset, r.snr_db, r.errbit, r.errblock, r.frames, r.seed,
            r.pm_ties)


@pytest.mark.parametrize("S,B,N", [(1, 8, 64), (3, 31, 128), (7, 20, 16)])
def test_per_frame_sigma_channel_equals_jax(S, B, N):
    """frame_llr with a sigma table: frame i at sigmas[fidx[i] % S], equal
    on every element to the JAX package's jitted awgn_llr of the frames'
    keys with the per-frame sigma vector (the fused sweep's channel), and
    to the scalar channel frame by frame."""
    rng = np.random.default_rng(S * B)
    x = rng.integers(0, 2, (B, N)).astype(np.int8)
    fidx = np.arange(B, dtype=np.int64) + 5
    sigmas = np.asarray(_sigmas(np.linspace(-2.0, 10.0, S)), np.float32)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def want_fn(x, fidx, sig):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(fidx)
        return jax_awgn_llr(x, keys, sig[fidx % S])

    want = np.asarray(want_fn(jnp.asarray(x), jnp.asarray(fidx, jnp.int32),
                              jnp.asarray(sigmas)))
    table = torch.as_tensor(sigmas)
    got = tch.frame_llr(torch.as_tensor(x), tch.prng_key(3),
                        torch.as_tensor(fidx), table)
    assert (got.numpy().view(np.int32) == want.view(np.int32)).all()
    for b in range(B):
        row = tch.frame_llr(torch.as_tensor(x[b:b + 1]), tch.prng_key(3),
                            torch.as_tensor(fidx[b:b + 1]),
                            float(sigmas[fidx[b] % S]))
        assert (row.numpy().view(np.int32) == want[b:b + 1].view(np.int32)).all()


# (preset, batch, snrs): batches that the SNR count does not divide
MULTISNR_CASES = [("BP_128", 31, (1.0, 2.0)), ("SC_128", 31, (1.0, 1.5, 2.0)),
                  ("SCL_128_L8", 20, (0.5, 1.0, 1.5)),
                  ("CASCL_128_L8", 21, (0.5, 1.0))]


@pytest.mark.parametrize("name,batch,snrs", MULTISNR_CASES)
def test_multisnr_step_equals_jax(name, batch, snrs):
    """Per-SNR (errbit, errblock, frames, pm_ties) [num_snr] int64 equal to
    JAX's make_multisnr_step; frames count each SNR's frames of the batch
    (frame_start 7: the batch's first frame is not at SNR 0)."""
    S = len(snrs)
    want = jh.make_multisnr_step(jcfg.preset(name), batch, S)(
        jax.random.PRNGKey(5), jnp.int32(7),
        jnp.asarray(_sigmas(snrs), jnp.float32))
    step = th.make_multisnr_step(tcfg.preset(name), batch, S, "cpu")
    got = step(tch.prng_key(5), 7, torch.tensor(_sigmas(snrs)))
    assert all(g.dtype == torch.int64 and g.shape == (S,) for g in got)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert got[2].tolist() == np.bincount((7 + np.arange(batch)) % S).tolist()
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("encoder", ["mxu", "butterfly"])
def test_fused_sweep_equals_jax(encoder):
    snrs = [1.0, 2.0, 3.0]
    want = jh.run_fused_sweep(jcfg.preset("BP_128"), snrs, 100, batch=50,
                              encoder=encoder)
    got = th.run_fused_sweep(tcfg.preset("BP_128"), snrs, 100, batch=50,
                             device="cpu", encoder=encoder)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert sum(r.frames for r in got) == 100


def test_fused_sweep_bf16_equals_jax():
    """llr_dtype=bfloat16 on the plain BP decoder against JAX's
    llr_dtype=jnp.bfloat16, bp_engine="jnp" (the precision study's
    combination): the counters bit-equal, and not those of float32."""
    snrs = [1.0, 2.0, 3.0]
    want = jh.run_fused_sweep(jcfg.preset("BP_128"), snrs, 100, batch=50,
                              llr_dtype=jnp.bfloat16, bp_engine="jnp")
    got = th.run_fused_sweep(tcfg.preset("BP_128"), snrs, 100, batch=50,
                             device="cpu", llr_dtype=torch.bfloat16,
                             engine="plain")
    f32 = th.run_fused_sweep(tcfg.preset("BP_128"), snrs, 100, batch=50,
                             device="cpu")
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [r.errbit for r in got] != [r.errbit for r in f32]


def test_kernel_decoders_refuse_another_llr_dtype():
    """On a CUDA device with engine="auto" a non-float32 llr_dtype raises
    before anything is built: the decode kernels are float32-only."""
    for make in (lambda **kw: th.make_frame_step(tcfg.preset("SCL_128_L8"), 8,
                                                 "cuda", **kw),
                 lambda **kw: th.make_multisnr_step(tcfg.preset("BP_128"), 8,
                                                    2, "cuda", **kw)):
        with pytest.raises(ValueError, match="float32-only"):
            make(llr_dtype=torch.bfloat16)


def test_multiseed_equals_jax():
    kw = dict(snr_points=[1.5, 2.5], error_blocks=4, batch=32)
    want_seeds, want_avg = jh.run_multiseed(jcfg.preset("BP_128"), [1, 2], **kw)
    got_seeds, got_avg = th.run_multiseed(tcfg.preset("BP_128"), [1, 2],
                                          device="cpu", **kw)
    assert got_avg == want_avg
    assert list(got_seeds) == list(want_seeds) == [1, 2]
    for seed in (1, 2):
        assert ([_fields(r) for r in got_seeds[seed]]
                == [_fields(r) for r in want_seeds[seed]])


def _without_elapsed(obj):
    if isinstance(obj, dict):
        return {k: _without_elapsed(v) for k, v in obj.items() if k != "elapsed_s"}
    if isinstance(obj, list):
        return [_without_elapsed(v) for v in obj]
    return obj


def test_cli_run_seeds_equals_jax(capsys):
    argv = ["run", "--preset", "SC_128", "--snr", "2.0", "--seeds", "3", "4",
            "--error-blocks", "3", "--batch", "32"]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert set(got) == {"averaged", "per_seed"} and list(got["per_seed"]) == ["3", "4"]
    assert _without_elapsed(got) == _without_elapsed(want)


@pytest.mark.parametrize("k", [1, 3])
def test_run_point_sync_every_equals_jax(k):
    """sync_every=k: chunks of k steps read one chunk behind, every chunk
    counted (the last pending one too), as the JAX package's run_point."""
    want = jh.run_point(jcfg.preset("BP_128"), 2.0, batch=32, error_blocks=10,
                        sync_every=k)
    got = th.run_point(tcfg.preset("BP_128"), 2.0, batch=32, device="cpu",
                       error_blocks=10, sync_every=k)
    assert _fields(got) == _fields(want)
    assert got.frames % (32 * k) == 0
    with pytest.raises(ValueError, match="sync_every"):
        th.run_point(tcfg.preset("BP_128"), 2.0, batch=32, device="cpu",
                     sync_every=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B,N", [(1, 33, 128), (3, 33, 1024), (7, 16384, 128),
                                   (3, 4096, 1024)])
def test_sigma_table_kernel_equals_plain_on_card(S, B, N):
    """On a card: the frame channel's kernel with a sigma table bit-equal to
    its plain version on every element, one launch; with S = 1 also to the
    scalar launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import frame_channel_kernel

    rng = np.random.default_rng(N + S)
    x = torch.as_tensor(rng.integers(0, 2, (B, N)), dtype=torch.float32,
                        device="cuda")
    fidx = torch.arange(B, device="cuda") + 3
    table = torch.tensor(_sigmas(np.linspace(-2.0, 10.0, S)),
                         dtype=torch.float32, device="cuda")
    key = tch.fold_in(tch.prng_key(7, "cuda"), 200)
    launches = frame_channel_kernel.LAUNCHES
    got = tch.frame_llr(x, key, fidx, table)
    want = tch.frame_llr(x, key, fidx, table, engine="plain")
    torch.cuda.synchronize()
    assert frame_channel_kernel.LAUNCHES == launches + 1
    assert (got.view(torch.int32) == want.view(torch.int32)).all()
    if S == 1:
        scalar = tch.frame_llr(x, key, fidx, float(table[0]))
        torch.cuda.synchronize()
        assert (got.view(torch.int32) == scalar.view(torch.int32)).all()
