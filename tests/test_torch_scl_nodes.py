"""The CUDA list-decode kernel's node schedule against the JAX package on the
CPU: the port's leaf nodes (models/scl_fast.nodes) are the leaves of the
JAX package's decompose (ops/pallas/scl_fast_kernel.py), kind, stage and
offset, and the kernel's per-leaf table (ops/scl_kernel.leaf_codes) encodes
exactly those nodes, for the presets' masks and seeded random masks at
r1 in {0, 4} and wloop in {2, 4}; and the premises of the exact kernel's
stage n-1 row in registers at N=1024: its table starts no node of stage
>= n-1 after leaf 0, and the row's accesses are lane-local."""
import os
import re

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


# the masks of the list-decode kernel's card tests at N=1024 (test_torch_import
# _node_mask): one R0 node of width N, one REP node of width N, all info, two
# ladders of R0 and REP nodes of every width from 512 to 2, a second half
# that is one R0 or REP node
def _card_node_masks():
    j = np.arange(1024)
    masks = {"all-frozen": j >= 0, "last-info": j < 1023, "all-info": j < 0}
    for first in ("r0", "rep"):
        kind, m = first, []
        for s in range(9, 0, -1):
            m += [True] * ((1 << s) - 1) + [kind == "r0"]
            kind = "r0" if kind == "rep" else "rep"
        masks[f"ladder_{first}"] = np.array(m + [False, False])
    half = (np.random.default_rng(1).random(1024) < 0.5) | (j >= 512)
    masks["half_r0"] = half
    masks["half_rep"] = half & (j < 1023)
    return masks


TOP_MASKS = ([("preset", p) for p in PRESETS]
             + [("node", m) for m in _card_node_masks()]
             + [("random", s) for s in range(20)])


def _top_mask(kind, what):
    if kind == "preset":
        return np.asarray(code_frozen_mask(jcfg.preset(what).code), bool)
    if kind == "node":
        return _card_node_masks()[what]
    rng = np.random.default_rng(1000 + what)
    return rng.random(1024) < rng.uniform(0.1, 0.9)


@pytest.mark.parametrize("kind,what", TOP_MASKS)
def test_exact_table_starts_wide_nodes_only_at_leaf_0(kind, what):
    """Exact mode's table (r1 = 0) never starts a node of stage >= n-1 at a
    leaf other than 0: the list-decode kernel that holds the stage n-1 row
    in registers runs such a node, and the f-node that feeds it, in the
    frame's llr region, which only leaf 0 leaves empty."""
    frozen = _top_mask(kind, what)
    N = len(frozen)
    n = N.bit_length() - 1
    codes = scl_kernel.leaf_codes(frozen)
    wide = [j for j, c in enumerate(codes) if c >> 5 and (c >> 1) & 15 >= n - 1]
    assert wide in ([], [0])
    # a width-N/2 node at leaf N/2 is there, split in two, where the mask has one
    if kind == "node" and what.startswith("half"):
        assert (codes[N // 2] >> 1) & 15 == n - 2
        assert (codes[3 * N // 4] >> 1) & 15 == n - 2


SCL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "polardecoding_tpu_torch", "csrc", "scl_decode.cu")


def _generic_top_elements(L, stage, lane, second_bits):
    """The stage n-1 row's elements that lane `lane` touches in the kernel's
    generic loops at N=1024 (idx = lane + 32 it), in order: the stage n-1
    g-node (writes g+ at e and g- at N/2 + e) and f-node (writes e), and
    stage n-2's g- and f-nodes (path k = idx >> 8, e = idx & 255, reads
    src_at(.., n-1, e) and (.., e + 256), g- where the path's partial-sum
    bit is set after bit N/2)."""
    half = 512
    out = []
    if stage == 9:
        for e in range(lane, half, 32):
            out.append(("g", e, half + e))
    else:
        for idx in range(lane, L << 8, 32):
            k, e = idx >> 8, idx & 255
            up = half + e if second_bits(k, e) else e
            lo = half + e + 256 if second_bits(k, e + 256) else e + 256
            out.append((k, up, lo))
    return out


def _register_top_elements(L, stage, lane, second_bits):
    """The same accesses as the register-row loops make them (k rolled, the
    chunk q unrolled): lane l's register m is element l + 32 m."""
    out = []

    def el(m):
        return lane + 32 * m

    if stage == 9:
        for q in range(16):
            out.append(("g", el(q), el(16 + q)))
    else:
        for k in range(L):
            for q in range(8):
                e = lane + 32 * q
                up = el(16 + q) if second_bits(k, e) else el(q)
                lo = el(24 + q) if second_bits(k, e + 256) else el(8 + q)
                out.append((k, up, lo))
    return out


@pytest.mark.parametrize("L", [8, 16, 32])
@pytest.mark.parametrize("stage", [9, 8])
@pytest.mark.parametrize("second", [False, True])
def test_register_row_is_lane_local(L, stage, second):
    """The index rule of the register row at N=1024: every element of the
    stage n-1 row that a stage n-1 or n-2 node reads or writes has the
    lane's e mod 32, and the unrolled loops' registers (tr[q], tr[8 + q],
    tr[16 + q], tr[24 + q]) name the elements the generic loops touch, in
    the same order, for every pattern of partial-sum bits; the source
    indexes tr with exactly those."""
    rng = np.random.default_rng(L * 10 + stage + second)
    bits = rng.random((L, 512)) < 0.5

    def second_bits(k, e):
        return second and bool(bits[k, e])

    for lane in range(32):
        want = _generic_top_elements(L, stage, lane, second_bits)
        got = _register_top_elements(L, stage, lane, second_bits)
        assert got == want
        for _, *elements in want:
            assert all(e % 32 == lane and 0 <= e < 1024 for e in elements)
    with open(SCL_SOURCE) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    assert set(re.findall(r"\btr\[([^\]]+)\]", src)) == {
        "q", "8 + q", "16 + q", "24 + q", "32"}
