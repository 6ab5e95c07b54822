"""Frame-index widths of the port against the JAX package and the C rule.

The PN offset is computed in int64 as in C (SC_128.c:179-181), where the
JAX package's int32 product wraps from frame 2^28 on at K=512; a frame's key
folds its index in as one 32-bit word, as jax.random.fold_in does (JAX
refuses an index of 2^32 or more, and so does the port, where the mask would
wrap it silently); the MC channel's counter word takes frame_start as the
JAX kernel's int32 -> uint32 cast does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardecoding_tpu.ops.noise import threefry2x32 as jthreefry
from polardecoding_tpu_torch.configs import preset
from polardecoding_tpu_torch.ops.channel import frame_keys, prng_key
from polardecoding_tpu_torch.ops.noise import counter_bits
from polardecoding_tpu_torch.parallel import harness as th
from polardecoding_tpu_torch.utils.pn import pn_sequence

START = (1 << 28) - 2


def test_pn_offsets_past_2_28_follow_the_c_rule():
    """Frames 2^28 - 2 .. 2^28 + 1 at K=512 (K % 63 = 8) start their PN
    window at offsets 49, 57, 2, 10, as (frame * 8) % 63 in exact
    arithmetic; the JAX package's int32 product gives 49, 57, 61, 6."""
    pn = torch.as_tensor(pn_sequence())
    fidx = torch.arange(START, START + 4, dtype=torch.int64)
    got = th.payload_from_index(fidx, pn, 512)
    offsets = [(f * 8) % 63 for f in range(START, START + 4)]
    assert offsets == [49, 57, 2, 10]
    for row, m in zip(got.tolist(), offsets):
        assert row == [int(pn[(m + i) % 63]) for i in range(512)]
    wrapped = ((np.arange(START, START + 4, dtype=np.int64) * 8)
               .astype(np.int32) % 63)
    assert wrapped.tolist() == [49, 57, 61, 6]


@pytest.mark.parametrize("frame", [(1 << 31) - 1, 1 << 31, (1 << 32) - 1])
def test_frame_keys_equal_jax_fold_in_up_to_2_32(frame):
    """Frame keys for indices up to 2^32 - 1 equal jax.random.fold_in's,
    which takes the index as a uint32."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(1024), 200)
    tkey = th.fold_in(prng_key(1024), 200)
    want = np.asarray(jax.random.fold_in(jkey, frame))
    got = frame_keys(tkey, torch.tensor([frame], dtype=torch.int64))[0]
    assert got.tolist() == want.astype(np.int64).tolist()


def test_mc_channel_counter_word_is_jax_int32_cast():
    """The MC channel's counter word frame_start & 0xFFFFFFFF equals the JAX
    kernel's int32 seed word cast to uint32, past 2^31 too."""
    frame_start = (1 << 31) + 5
    jword = jnp.int32(frame_start - (1 << 32)).astype(jnp.uint32)
    lanes = jnp.arange(2 * 16, dtype=jnp.uint32)
    want, _ = jthreefry(jnp.uint32(7), jnp.uint32(9), jword, lanes)
    got = counter_bits(7, 9, frame_start, 2, 16)
    assert got.reshape(-1).tolist() == np.asarray(want).astype(np.int64).tolist()


@pytest.mark.parametrize("channel", ["threefry", "mc"])
def test_frame_step_raises_before_index_2_32(channel):
    """The step whose frames would reach index 2^32 raises; the one that
    ends at 2^32 - 1 runs."""
    p = preset("BP_128")
    step = th.make_frame_step(p, 4, "cpu", channel=channel)
    key = prng_key(p.sweep.seed)
    ok = step(key, (1 << 32) - 4, 0.8)
    assert all(int(c) >= 0 for c in ok)
    with pytest.raises(OverflowError, match="2\\^32"):
        step(key, (1 << 32) - 3, 0.8)


def test_wave_points_raise_before_index_2_32():
    """run_point_waves refuses a point whose fused engine could issue frame
    2^32 in the chunks in flight, and the MC engine a start at 2^32."""
    p = preset("BP_128")
    batch = 4
    near = th.PointResult(p.name, 2.0, 0, 0,
                          (1 << 32) - batch * (2 * th.SYNC_EVERY + 1) + 1,
                          p.sweep.seed)
    with pytest.raises(OverflowError, match="2\\^32"):
        th.run_point_waves(p, 2.0, batch=batch, device="cpu", start_state=near,
                           error_blocks=1)
    init, _, _ = th.make_wave_step_mc(p, batch, 8, "cpu")
    with pytest.raises(OverflowError, match="2\\^32"):
        init(prng_key(p.sweep.seed), 1 << 32, 0.8)
