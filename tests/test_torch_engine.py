"""The port's one kernel-or-plain choice (ops/_build.use_kernel): every
dispatcher refuses an unknown engine, and off the card (a CPU tensor, with
engine "auto" or "plain") runs its plain version, bit for bit, without
building or launching a kernel."""
import pytest
import torch

from polardecoding_tpu_torch.models import bp as tbp
from polardecoding_tpu_torch.models import scl as tscl
from polardecoding_tpu_torch.models.sc import sc_decode
from polardecoding_tpu_torch.ops import _build
from polardecoding_tpu_torch.ops import channel as tch
from polardecoding_tpu_torch.ops import channel_kernel as tck
from polardecoding_tpu_torch.ops.noise import counter_bits
from polardecoding_tpu_torch.utils.sequences import frozen_mask, info_set

N, K, B = 32, 16, 4
SIGMA = 0.7943


def _inputs():
    g = torch.Generator().manual_seed(5)
    frozen = torch.as_tensor(frozen_mask(N, K))
    x = torch.randint(0, 2, (B, N), generator=g).to(torch.float32)
    llr = (2 * (1 - 2 * x) + torch.randn(B, N, generator=g)) / SIGMA ** 2
    return frozen, x, llr


def _bp_decode_auto():
    frozen, _, llr = _inputs()
    return (lambda engine: tbp.bp_decode_auto(llr, frozen, iters=6,
                                              early_stop_every=2,
                                              engine=engine),
            lambda: tbp.bp_decode(llr, frozen, iters=6, early_stop_every=2))


def _bp_wave():
    frozen, _, llr = _inputs()
    state = tbp.wave_init_state(llr, frozen)
    return (lambda engine: tbp.bp_wave(state.clone(), 3, engine=engine),
            lambda: tbp.bp_wave_plain(state.clone(), 3))


def _bp_wave_fused():
    frozen, _, llr = _inputs()
    state = tbp.wave_init_state(llr.flip(0), frozen)
    retire = torch.tensor([True, False, True, False])
    live = torch.tensor([True, True, False, True])
    return (lambda engine: tbp.bp_wave_fused(
                state.clone(), llr, retire, 4, check_every=2, engine=engine,
                live=live),
            lambda: tbp.bp_wave_fused_plain(state.clone(), llr, retire, 4,
                                            check_every=2, live=live))


def _bp_wave_mc():
    frozen, _, _ = _inputs()
    utab, xtab = tbp.mc_tables(info_set(N, K), K, N)
    state = tbp.wave_init_state(torch.zeros(B, N), frozen)
    meta = tbp.mc_meta_init(B, N, K)
    seeds = (0x13198A2E, 0x03707344, 0x13198A2E ^ 0x03707344, 3)
    kw = dict(iters=4, iter_max=12, delta=tbp.mc_delta(B, K), spares=2)
    return (lambda engine: tbp.bp_wave_mc(
                state.clone(), meta.clone(), utab, xtab, SIGMA, seeds,
                engine=engine, **kw),
            lambda: tbp.bp_wave_mc_plain(
                state.clone(), meta.clone(), utab, xtab, SIGMA,
                tbp.mc_bits(seeds, 2, B, N), **kw))


def _scl_decode_auto():
    frozen, _, llr = _inputs()
    return (lambda engine: tscl.scl_decode_auto(llr, frozen, list_size=4,
                                                return_ties=True,
                                                engine=engine),
            lambda: tscl.scl_decode(llr, frozen, list_size=4,
                                    return_ties=True))


def _sc_decode_auto():
    frozen, _, llr = _inputs()
    return (lambda engine: tscl.sc_decode_auto(llr, frozen, engine=engine),
            lambda: sc_decode(llr, frozen))


def _frame_llr():
    _, x, _ = _inputs()
    key, fidx = tch.prng_key(11), torch.arange(7, 7 + B)
    return (lambda engine: tch.frame_llr(x, key, fidx, SIGMA, engine=engine),
            lambda: tch.awgn_llr(x, tch.frame_keys(key, fidx), SIGMA))


def _mc_channel():
    _, xtab = tbp.mc_tables(info_set(N, K), K, N)
    m = torch.tensor([0, 5, 62, 17])
    seeds = (9, 4, 9 ^ 4, 2)
    return (lambda engine: tck.mc_channel(m, xtab, SIGMA, seeds, row0=3,
                                          engine=engine),
            lambda: tck.mc_channel_plain(
                m, xtab, SIGMA, counter_bits(9, 4, 2, B, N, "cpu", row0=3)))


DISPATCHERS = {f.__name__[1:]: f for f in (
    _bp_decode_auto, _bp_wave, _bp_wave_fused, _bp_wave_mc, _scl_decode_auto,
    _sc_decode_auto, _frame_llr, _mc_channel)}
INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(out):
    """out's tensors, floats as their bit patterns."""
    if isinstance(out, (tuple, list)):
        return [_bits(t) for t in out]
    return out.view(INT_OF.get(out.dtype, out.dtype))


def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(DISPATCHERS))
def test_a_dispatcher_refuses_an_unknown_engine_and_runs_plain_off_the_card(
        monkeypatch, name):
    def refuse(*args, **kw):
        raise AssertionError("built or launched a kernel off the card")

    for fn in ("load", "launch", "build_all"):
        monkeypatch.setattr(_build, fn, refuse)
    call, plain = DISPATCHERS[name]()
    with pytest.raises(ValueError, match=f"{name}: unknown engine 'jnp'"):
        call("jnp")
    want = _bits(plain())
    for engine in ("auto", "plain"):
        assert _same(_bits(call(engine)), want), engine
