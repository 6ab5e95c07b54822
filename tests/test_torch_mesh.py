"""The port's data mesh in one process: round_up_batch against the JAX
package's, the ranks' lane ranges, the one-rank data_mesh() equal to no
mesh, a rank's slice of each step counting exactly its frames of the global
batch, and the MC wave engine's refusal of a mesh of several ranks (it has
no mesh path in the JAX package either)."""
import jax
import numpy as np
import pytest
import torch

from polardecoding_tpu.parallel import mesh as jmesh
from polardecoding_tpu_torch import bench as tbench
from polardecoding_tpu_torch import configs as tcfg
from polardecoding_tpu_torch.ops.channel import fold_in, prng_key
from polardecoding_tpu_torch.parallel import harness as th
from polardecoding_tpu_torch.parallel.mesh import (
    DataMesh,
    data_mesh,
    one_rank,
    round_up_batch,
)

CPU = torch.device("cpu")
SIGMA = float(np.float32(10.0 ** (-2.0 / 20.0)))


def _mesh(rank, size):
    """A rank of `size` with no group: its steps count only its own slice
    (no collective), which is what these tests add up by hand."""
    return DataMesh(rank, size, None, CPU)


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_round_up_batch_equals_jax(size):
    jm = jmesh.data_mesh(jax.devices()[:size])
    for batch in (1, 7, 8, 9, 1024, 1025):
        assert round_up_batch(batch, _mesh(0, size)) == \
            jmesh.round_up_batch(batch, jm)


def test_lanes_cover_the_batch_in_rank_order():
    for size, batch in ((1, 5), (2, 32), (4, 8192), (8, 64)):
        seen = []
        for rank in range(size):
            first, b = _mesh(rank, size).lanes(batch)
            assert b == batch // size
            seen.extend(range(first, first + b))
        assert seen == list(range(batch))
    with pytest.raises(ValueError, match="round_up_batch"):
        _mesh(0, 3).lanes(32)


def test_one_rank_data_mesh_is_no_mesh():
    """Without torch.distributed, data_mesh() is one rank with no group on
    the given device, and steps on it count what steps without a mesh do."""
    m = data_mesh(device="cpu")
    assert m == one_rank("cpu") == DataMesh(0, 1, None, CPU)
    assert data_mesh().device == torch.device("cuda")
    with pytest.raises(ValueError, match="initialised"):
        data_mesh(group=object())
    key = prng_key(7)
    p = tcfg.preset("SC_128")
    want = [int(v) for v in th.make_frame_step(p, 16, "cpu")(key, 16, SIGMA)]
    got = [int(v) for v in th.make_frame_step(p, 16, "cpu", mesh=m)(key, 16, SIGMA)]
    assert got == want
    bp = tcfg.preset("BP_128")
    rows = []
    for mesh in (None, m):
        init, step, _ = th.make_wave_step(bp, 16, 8, "cpu", mesh=mesh)
        carry = init(key, 0, SIGMA)
        for _ in range(3):
            carry, out = step(key, SIGMA, carry)
        rows.append([int(v) for v in out])
    assert rows[0] == rows[1]
    kw = dict(batch=16, error_blocks=3)
    a = th.run_point(p, 3.0, device="cpu", **kw)
    b = th.run_point(p, 3.0, mesh=m, **kw)
    assert (a.errbit, a.errblock, a.frames) == (b.errbit, b.errblock, b.frames)
    m.barrier()  # no group: nothing to wait for


@pytest.mark.parametrize("channel,noise", [("threefry", "kernel"),
                                           ("mc", "kernel"), ("mc", "threefry")])
def test_rank_slices_add_up_to_the_batch(channel, noise):
    """Each rank's slice of a frame step counts its own frames: the slices'
    counters add up to the whole batch's, the MC channel's counter noise
    (the first-row argument) and jax.random.bits noise included."""
    p = tcfg.preset("BP_128")
    key = prng_key(4)
    kw = dict(channel=channel, noise=noise)
    want = [int(v) for v in th.make_frame_step(p, 24, "cpu", **kw)(key, 48, SIGMA)]
    got = np.zeros(3, dtype=np.int64)
    for rank in range(3):
        step = th.make_frame_step(p, 24, "cpu", mesh=_mesh(rank, 3), **kw)
        got += [int(v) for v in step(key, 48, SIGMA)]
    assert got.tolist() == want and want[1] > 0


def test_rank_slices_add_up_multisnr_and_bpr():
    sigmas = torch.tensor([0.9, 0.8, 0.7], dtype=torch.float32)
    p = tcfg.preset("SC_128")
    whole = th.make_multisnr_step(p, 20, 3, "cpu")(prng_key(3), 0, sigmas)
    parts = [th.make_multisnr_step(p, 20, 3, "cpu", mesh=_mesh(r, 2))(
        prng_key(3), 0, sigmas) for r in range(2)]
    for i, w in enumerate(whole):
        assert torch.equal(parts[0][i] + parts[1][i], w)
    pr = tcfg.preset("BPr_128")
    key = fold_in(prng_key(pr.sweep.seed), 200)
    whole = th.make_bpr_step(pr, 16, "cpu")(key, 0, SIGMA)
    parts = [th.make_bpr_step(pr, 16, "cpu", mesh=_mesh(r, 2))(key, 0, SIGMA)
             for r in range(2)]
    for i, w in enumerate(whole):
        assert torch.equal(parts[0][i] + parts[1][i], w)


def test_mc_wave_engine_refuses_a_mesh_of_two():
    """The JAX package's MC engine has no mesh path: the port's refuses a
    mesh of several ranks (a fake one; no group needed) and runs on one."""
    p = tcfg.preset("BP_128_FASTCHK")
    two = _mesh(0, 2)
    with pytest.raises(ValueError, match="no mesh path"):
        th.make_wave_step_mc(p, 32, 8, "cpu", mesh=two)
    with pytest.raises(ValueError, match="no mesh path"):
        th.run_point_waves(p, 2.0, batch=32, engine="mc", mesh=two)
    with pytest.raises(ValueError, match="no mesh path"):
        tbench.bench_waves("BP_128_FASTCHK", 32, engine="mc", mesh=two)
    th.make_wave_step_mc(p, 32, 8, "cpu", mesh=one_rank("cpu"))


def test_bench_step_on_the_one_rank_mesh():
    rate = tbench.bench_step("SC_128", 8, iters=1, warmup=1,
                             mesh=data_mesh(device="cpu"))
    assert rate > 0


def test_first_row_draws_the_rows_of_the_global_batch():
    """counter_bits, random_bits and the MC channel at a first row r give
    rows r.. of the whole draw: a rank's slice draws the global batch's
    noise (counters past 2^32 wrap as the kernel's 32-bit word does)."""
    from polardecoding_tpu_torch.ops.channel import random_bits
    from polardecoding_tpu_torch.ops.channel_kernel import mc_channel
    from polardecoding_tpu_torch.ops.noise import counter_bits

    whole = counter_bits(5, 6, 9, 12, 16)
    assert torch.equal(counter_bits(5, 6, 9, 5, 16, row0=7), whole[7:])
    wrap = (1 << 28) - 2  # rows (2^28 - 2) * 16 .. pass 2^32
    lo = counter_bits(5, 6, 9, 2, 16, row0=wrap)
    hi = counter_bits(5, 6, 9, 2, 16, row0=0)
    assert torch.equal(counter_bits(5, 6, 9, 4, 16, row0=wrap),
                       torch.cat([lo, hi]))
    key = prng_key(11)
    assert torch.equal(random_bits(key, 40, start=24), random_bits(key, 64)[24:])
    m = torch.arange(12) % 63
    xtab = (torch.arange(128 * 16).reshape(128, 16) % 3 == 0).to(torch.float32)
    seeds = (5, 6, 5 ^ 6, 9)
    full = mc_channel(m, xtab, SIGMA, seeds)
    assert torch.equal(mc_channel(m[7:], xtab, SIGMA, seeds, row0=7), full[7:])
