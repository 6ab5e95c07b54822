"""The premises of the wave kernels' live rows (csrc/bp_wave.cu), held
against both packages on the CPU:

- with at least one iteration, the unfused and the fused wave
  (models/bp.bp_wave_plain, bp_wave_fused_plain) give the same state,
  u_hat and done whatever the incoming L[0] and R[1..n] planes hold, so the
  kernel reads only L[1..n] and R[0] of a kept slot;
- with none, the fused decide does read L[0] and R[n] (in both packages
  alike), which is why the kernel loads those planes then;
- the fused merge is a select: a kept slot's -0.0 survives in every plane,
  a retired slot takes its LLRs' -0.0, and the fused wave on a mixed retire
  mask equals JAX's bp_wave_fused_jnp;
- chip_smoke.wave_work charges a wave the planes it needs: L[1..n] and
  R[0] in and L[0..n-1] and R[1..n] out per kept slot, R[0] and the LLR row
  in and L[n] out besides per retired slot of the fused wave; chip_smoke
  counts the retired slots from the mask that the timed fused wave is given;
- on a card, the fused kernel given a live mask holds the slots neither
  live nor retired, as bp_wave_fused_plain does.

JAX is imported inside the tests that compare with it, so the card test
also runs where JAX is absent:

  python -m pytest --noconftest -q -m cuda tests/test_torch_wave_rows.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.utils.sequences import frozen_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FLAVORS = [(N, f) for N in (8, 64, 128)
             for f in ("minsum_lut", "minsum_lut_fast", "spa")]
B = 8


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _same(a, b):
    """Bit-equal tensors or arrays (-0.0 is not +0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = _bits(a), _bits(b)
    return a.shape == b.shape and (a == b).all()


def _dead(n):
    """The planes an iteration writes before it reads them: L[0], R[1..n]."""
    return [0] + list(range(n + 2, 2 * n + 2))


def _jax_fused(state, llr, retire, **kw):
    """JAX's bp_wave_fused_jnp on the port's CPU tensors."""
    import jax.numpy as jnp

    from polardecoding_tpu.models import bp as jbp

    return jbp.bp_wave_fused_jnp(jnp.asarray(state.numpy()),
                                 jnp.asarray(llr.numpy()),
                                 jnp.asarray(retire.numpy()), **kw)


def _inputs(N, flavor, seed, b=B):
    """A state three iterations in from random LLRs (a -0.0 planted in every
    plane of slot 0), fresh LLRs (-0.0 in slot 1) and every odd slot
    retired, for b slots."""
    rng = np.random.default_rng(seed)
    frozen = torch.as_tensor(frozen_mask(N, N // 2))

    def llr():
        return torch.as_tensor((rng.normal(size=(b, N)) * 2.5 + 2.0)
                               .astype(np.float32))

    state = tbp.bp_wave_plain(tbp.wave_init_state(llr(), frozen), 3, flavor)
    state[:, 0, 1] = -0.0
    fresh = llr()
    fresh[1, :2] = -0.0
    return state, fresh, torch.arange(b) % 2 == 1


def _garbage(state, seed):
    """state with L[0] and R[1..n] overwritten: NaN, infinities and large
    values of either sign."""
    n = state.shape[0] // 2 - 1
    rng = np.random.default_rng(seed)
    out = state.clone()
    junk = rng.choice(np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, -0.0],
                               np.float32), size=(len(_dead(n)),) + state.shape[1:])
    out[_dead(n)] = torch.as_tensor(junk)
    return out


@pytest.mark.parametrize("N,flavor", N_FLAVORS)
def test_wave_ignores_dead_planes(N, flavor):
    """At 1 and 5 iterations: the unfused wave's state, and the fused
    wave's state, u_hat and done at check_every 0, 1 and 4, are bit for bit
    the same with garbage in L[0] and R[1..n]."""
    state, llr, retire = _inputs(N, flavor, seed=N)
    noisy = _garbage(state, seed=N + 1)
    for iters in (1, 5):
        assert _same(tbp.bp_wave_plain(state, iters, flavor),
                     tbp.bp_wave_plain(noisy, iters, flavor))
        for ce in (0, 1, 4):
            clean = tbp.bp_wave_fused_plain(state, llr, retire, iters, flavor, ce)
            dirty = tbp.bp_wave_fused_plain(noisy, llr, retire, iters, flavor, ce)
            for a, b in zip(clean, dirty):
                assert _same(a, b), (iters, ce)


@pytest.mark.parametrize("N,flavor", N_FLAVORS)
def test_fused_decide_reads_dead_planes_at_zero_iterations(N, flavor):
    """At 0 iterations the fused wave decides from the incoming L[0] (and
    checks with R[n]): a kept slot's u_hat follows them, a retired slot's
    does not (the merge zeroes them); JAX's bp_wave_fused_jnp agrees on the
    garbage state."""
    state, llr, retire = _inputs(N, flavor, seed=2 * N)
    n = N.bit_length() - 1
    noisy = state.clone()
    noisy[0] = -50.0  # L[0]: every info bit decides 1
    noisy[2 * n + 1] = 50.0
    kept = ~retire
    for ce in (0, 4):
        clean = tbp.bp_wave_fused_plain(state, llr, retire, 0, flavor, ce)
        dirty = tbp.bp_wave_fused_plain(noisy, llr, retire, 0, flavor, ce)
        assert not _same(clean[1][kept], dirty[1][kept])
        assert _same(clean[1][retire], dirty[1][retire])
        assert _same(clean[0][:, retire], dirty[0][:, retire])
        want = _jax_fused(noisy, llr, retire, iters=0, flavor=flavor,
                          check_every=ce)
        for a, b in zip(dirty, want):
            assert _same(a, b), ce


@pytest.mark.parametrize("N,flavor", N_FLAVORS)
def test_fused_merge_keeps_negative_zero_and_equals_jax(N, flavor):
    """The merge is a select: at 0 iterations a kept slot's planes come out
    as they went in (-0.0 included), a retired slot's are +0.0 but L[n],
    its LLRs (-0.0 included), and R[0]; at 0 and 1 iterations (check_every
    0 and 1) state, u_hat and done equal JAX's bp_wave_fused_jnp on the
    mixed retire mask (SPA at 0 iterations only: its exp and log1p round
    apart in the two packages)."""
    state, llr, retire = _inputs(N, flavor, seed=3 * N)
    n = N.bit_length() - 1
    out = tbp.bp_wave_fused_plain(state, llr, retire, 0, flavor)[0]
    kept = ~retire
    assert _same(out[:, kept], state[:, kept])
    assert (_bits(out[:, 0, 1].numpy()) == _bits(np.float32(-0.0))).all()
    others = [s for s in range(2 * n + 2) if s not in (n, n + 1)]
    assert (_bits(out[others][:, retire].numpy()) == 0).all()
    assert _same(out[n, retire], llr[retire])
    assert _same(out[n + 1], state[n + 1])
    assert _bits(out[n, 1, 0].numpy()) == _bits(np.float32(-0.0))
    for iters in ((0,) if flavor == "spa" else (0, 1)):
        for ce in (0, 1):
            got = tbp.bp_wave_fused_plain(state, llr, retire, iters, flavor, ce)
            want = _jax_fused(state, llr, retire, iters=iters,
                              flavor=flavor, check_every=ce)
            for a, b in zip(got, want):
                assert _same(a, b), (iters, ce)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("N", [8, 1024])
def test_chip_smoke_wave_work_counts_the_planes_a_wave_needs(N):
    """wave_work's bytes: per kept slot the planes an iteration reads
    (L[1..n], R[0]) and writes (L[0..n-1], R[1..n]), per retired slot of
    the fused wave R[0] and the LLR row in and the 2n planes and L[n] out,
    the retire mask, u_hat and done; its operations bp_sweep_ops's."""
    smoke = _chip_smoke()
    n = N.bit_length() - 1
    Bw, retired, row = 16384, 1000, N * 4
    # plane indices of the state: L[i] is plane i, R[i] plane n + 1 + i
    reads = set(range(1, n + 1)) | {n + 1}
    writes = set(range(n)) | {n + 1 + i for i in range(1, n + 1)}
    assert len(reads) == n + 1 and len(writes) == 2 * n
    assert reads | writes == set(range(2 * n + 2))
    chks = {"flavor": "minsum_lut", "chks": 1000, "zero": 400}
    ops = smoke.bp_sweep_ops(chks)
    kept = (len(reads) + len(writes)) * row
    assert smoke.wave_work(Bw, N, False, chks) == (Bw * kept, ops)
    fresh = (2 + len(writes) + 1) * row  # R[0] and llr in; 2n planes and L[n] out
    want = (Bw - retired) * kept + retired * fresh + Bw + Bw * N + Bw
    retire = torch.arange(Bw) < retired
    assert smoke.wave_work(Bw, N, True, chks, retire) == (want, ops)
    if N == 1024:  # 31 of the 44 plane-trips of a whole state in and out
        assert kept == 31 * 4096


@pytest.mark.parametrize("fused,retire", [
    (True, None), (True, 1000), (True, torch.zeros(8, dtype=torch.bool)),
    (False, torch.zeros(16, dtype=torch.bool))])
def test_chip_smoke_wave_work_takes_the_kernels_retire_mask(fused, retire):
    """wave_work counts the merged slots from the fused wave's own [B]
    retire mask: a count, a mask of another length, no mask for the fused
    wave or one for the unfused wave is refused."""
    smoke = _chip_smoke()
    chks = {"flavor": "minsum_lut", "chks": 10, "zero": 4}
    with pytest.raises(ValueError):
        smoke.wave_work(16, 1024, fused, chks, retire)


def test_chip_smoke_bounds_the_timed_fused_wave(monkeypatch):
    """phase_k8_wave_timing, run on the CPU at a small batch with its timer
    and hold_and_time stood in for: the fused wave's wave_work is that of
    the retire mask the timed call gave the fused wave (some slots merged,
    not all), and the unfused wave's that of no merge, each with the CHKs
    counted on its own inputs."""
    import polardecoding_tpu_torch.models.bp as bp_models

    smoke = _chip_smoke()
    given = {}
    fused = bp_models.bp_wave_fused

    def recording(state, llr, retire, *args, **kw):
        given["retire"] = retire.clone()
        return fused(state, llr, retire, *args, **kw)

    def hold(card, name, B, run, axes, flavor=None, **info):
        with smoke.counted_chks(flavor) as chks:
            run("plain", False)
        return 1.0, 2.0, 0, chks

    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    monkeypatch.setattr(smoke, "WAVE_BATCH", 64)
    monkeypatch.setattr(smoke, "hold_and_time", hold)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (1.0, fn()))
    monkeypatch.setattr(bp_models, "bp_wave_fused", recording)
    out, work = smoke.phase_k8_wave_timing("cpu")
    retire = given["retire"]
    assert retire.shape == (64,) and 0 < int(retire.sum()) < 64
    assert work["bp_wave_fused"] == smoke.wave_work(
        64, 1024, True, out["bp_wave_fused"][3], retire)
    assert work["bp_wave"] == smoke.wave_work(64, 1024, False,
                                              out["bp_wave"][3])
    kept = 31 * 4096
    assert (64 - int(retire.sum())) * kept < work["bp_wave_fused"][0]
    assert work["bp_wave"][0] == 64 * kept


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 1024])
def test_fused_kernel_holds_the_dead_slots_on_card(N):
    """On a card: bp_wave_fused_cuda with random live and retire masks (both
    min-sum flavors, check_every 0 and 4; at N = 64 a slot is one warp)
    equals bp_wave_fused_plain with the same masks bit for bit: state, u_hat
    and done.  A held slot's planes are unchanged byte for byte, and its
    done and u_hat are written 0 over freed memory of their sizes filled
    with 0x5A.  MASKED counts a masked launch once and an unmasked one not
    at all; LAUNCHES counts both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from polardecoding_tpu_torch.ops import bp_wave_kernel

    slots = 96
    rng = np.random.default_rng(N)
    for flavor in ("minsum_lut", "minsum_lut_fast"):
        state, llr, _ = (x.cuda() for x in _inputs(N, flavor, N, slots))
        retire = torch.as_tensor(rng.random(slots) < 0.3, device="cuda")
        live = torch.as_tensor(rng.random(slots) < 0.4, device="cuda")
        held = ~live & ~retire
        assert 0 < int(held.sum()) < slots and bool((retire & ~live).any())
        for ce, mask in ((0, live), (4, live), (4, None)):
            want = tbp.bp_wave_fused_plain(state, llr, retire, 8, flavor, ce,
                                           mask)
            got_state = state.clone()
            # the wrapper's u_hat and done, allocated in its order, reuse
            # these blocks
            junk = [torch.full(shape, 0x5A, dtype=torch.uint8, device="cuda")
                    for shape in ((slots, N), (slots,))]
            del junk
            counts = (bp_wave_kernel.LAUNCHES["bp_wave_fused"],
                      bp_wave_kernel.MASKED["bp_wave_fused"])
            got = bp_wave_kernel.bp_wave_fused_cuda(
                got_state, llr, retire, 8, flavor, check_every=ce, live=mask)
            torch.cuda.synchronize()
            assert (bp_wave_kernel.LAUNCHES["bp_wave_fused"],
                    bp_wave_kernel.MASKED["bp_wave_fused"]) == (
                        counts[0] + 1, counts[1] + (mask is not None))
            assert got[0].data_ptr() == got_state.data_ptr()
            assert _same(got[0].cpu(), want[0].cpu()), (flavor, ce)
            assert got[1].dtype == torch.int8 and (got[1] == want[1]).all()
            assert got[2].dtype == torch.bool and (got[2] == want[2]).all()
            if mask is not None:
                assert _same(got_state[:, held].cpu(), state[:, held].cpu())
                assert (got[1][held] == 0).all() and not got[2][held].any()
