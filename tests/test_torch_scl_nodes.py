"""The CUDA list-decode kernel's node schedule against the JAX package on the
CPU: the port's leaf nodes (models/scl_fast.nodes) are the leaves of the
JAX package's decompose (ops/pallas/scl_fast_kernel.py), kind, stage and
offset, and the kernel's per-leaf table (ops/scl_kernel.leaf_codes) encodes
exactly those nodes, for the presets' masks and seeded random masks at
r1 in {0, 4} and wloop in {2, 4}."""
import numpy as np
import pytest

from polardecoding_tpu import configs as jcfg
from polardecoding_tpu.analysis.construction import code_frozen_mask
from polardecoding_tpu.ops.pallas import scl_fast_kernel as jfast
from polardecoding_tpu_torch.models import scl_fast as tfast
from polardecoding_tpu_torch.ops import scl_kernel

PRESETS = ("SCL_128_L8", "SCL_1024_L8", "CASCL_1024_L8", "SCL_1024_L8_FASTR1",
           "CASCL_1024_L8_FASTR1", "SCL_1024_L16_FASTR1", "SCL_128_L8_FASTR1")
# 20 seeded random masks, N from 2 to 1024 and frozen shares from 0.1 to 0.9
RANDOM = [(2 ** (1 + i % 10), 0.1 + 0.8 * ((7 * i) % 20) / 19, i)
          for i in range(20)]
KINDS = {1: "r0", 2: "rep", 3: "r1"}


def _jax_leaves(frozen, r1, wloop):
    """(kind, stage, offset) of the JAX tree's leaves in leaf order."""
    n = len(frozen).bit_length() - 1
    out = []

    def walk(nd):
        if nd.kind == "branch":
            walk(nd.left)
            walk(nd.right)
        else:
            out.append((nd.kind, nd.stage, nd.off))

    walk(jfast.decompose(frozen, n, 0, wloop, r1))
    return out


def _kernel_nodes(leaves, N):
    """What the kernel's table must hold for these leaves: every R0, REP and
    R1 node of stage >= 1, an R0 or REP node of width N/2 at leaf N/2 as its
    two halves (R0, then the node's kind)."""
    n = N.bit_length() - 1
    out = []
    for kind, s, off in leaves:
        if kind == "loop":
            continue
        if kind != "r1" and s == n - 1 and off == N // 2:
            parts = [("r0", s - 1, off), (kind, s - 1, off + N // 4)]
        else:
            parts = [(kind, s, off)]
        out += [p for p in parts if p[1] >= 1]
    return out


def _check(frozen, r1, wloop):
    frozen = tuple(bool(b) for b in frozen)
    N = len(frozen)
    want = _jax_leaves(frozen, r1, wloop)
    got = [(nd.kind, nd.stage, nd.off) for nd in tfast.nodes(frozen, r1, wloop)]
    assert got == want
    # the leaves tile the code
    assert sum(1 << s for _, s, _ in got) == N
    assert [off for _, _, off in got] == sorted(off for _, _, off in got)
    codes = scl_kernel.leaf_codes(frozen, r1, wloop)
    assert len(codes) == N and all(0 <= c < 128 for c in codes)
    assert [c & 1 for c in codes] == [int(f) for f in frozen]
    table = [(KINDS[c >> 5], (c >> 1) & 15, j) for j, c in enumerate(codes)
             if c >> 5]
    assert table == _kernel_nodes(want, N)
    assert all(c >> 5 or not (c >> 1) for c in codes)
    if not r1:
        assert all(kind != "r1" for kind, _, _ in table)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("r1,wloop", [(0, 2), (0, 4), (4, 2), (4, 4)])
def test_node_table_of_presets_equals_jax(name, r1, wloop):
    """The presets' masks: the port's leaf nodes are JAX's, and the kernel's
    table encodes them."""
    _check(np.asarray(code_frozen_mask(jcfg.preset(name).code), bool), r1,
           wloop)


@pytest.mark.parametrize("r1,wloop", [(0, 2), (0, 4), (4, 2), (4, 4)])
def test_node_table_of_random_masks_equals_jax(r1, wloop):
    """20 seeded random masks, N from 2 to 1024, and the masks that the card
    compares use (one node of width N, ladders of R0 and REP nodes of every
    width, a second half of width N/2)."""
    for N, share, seed in RANDOM:
        _check(np.random.default_rng(seed).random(N) < share, r1, wloop)
    ladder = []
    for s in range(9, 0, -1):
        ladder += [True] * ((1 << s) - 1) + [s % 2 == 0]
    for mask in (np.ones(1024, bool), np.arange(1024) < 1023,
                 np.zeros(1024, bool), np.array(ladder + [False, False]),
                 np.arange(1024) >= 512, (np.arange(1024) >= 512)
                 & (np.arange(1024) < 1023)):
        _check(mask, r1, wloop)


def test_r1_stages_mark_the_tables_r1_nodes():
    """r1_stages, which the plain flavor reads, marks exactly the R1 nodes of
    the kernel's table, and exact mode's table has none."""
    fr = np.asarray(code_frozen_mask(jcfg.preset("SCL_1024_L8").code), bool)
    codes = scl_kernel.leaf_codes(fr, 4, 2)
    stages = tfast.r1_stages(fr, 4, 2)
    assert stages == [(c >> 1) & 15 if c >> 5 == 3 else 0 for c in codes]
    assert all(c >> 5 in (0, 1, 2) for c in scl_kernel.leaf_codes(fr))
    assert tfast.r1_stages(fr, 0, 2) == [0] * len(fr)
