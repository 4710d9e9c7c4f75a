"""The splits of the tree order that the wide coordinate-descent kernels use.

``csrc/cd_wide.cu`` adds every sum of K > 32 terms in the order of
``ops/cd.py:_tree_sum``: zero-padded to W (the least power of two >=
max(K, 32)), then k with k + W/2, k + W/4, .. k + 1. The kernels split that
tree over threads; each split is emulated here literally, in Python floats
(IEEE doubles), and must give ``_tree_sum``'s bits:

- P threads a sum: thread r holds the terms k = r + P j and adds them as
  the same halving tree over j, streamed in bit-reversed j through a stack
  of partial sums; then log2 P xor levels (P, 1 .. 64; cd_fista's rows take
  P = 4).
- cd_fista's dots over its row slots: slot s = ((lane / 4) NW + warp) NC +
  cta owns the terms k = s + S u (S = 8 NW NC), adds them over u, then the
  lane levels xor 16, 8, 4, then the NW NC partial sums by warp and CTA (m =
  warp NC + cta) as 32 lanes' leaves m = lane + 32 j and a butterfly; at
  every warp and cluster shape the kernel launches.
- cd_cyclic_wide's completion of a dot from one held-out leaf: lane l holds
  k = l + 32 t; the lane holding the held leaf keeps the sibling sums on its
  path through its own tree and its partner groups' sums from the
  butterfly; the leaf's value then finishes the sum with log2 W adds.

Plus the layout that keeps a warp's 8 rows of XtX on distinct shared-memory
banks (the xor swizzle of a row's 4-double groups by (row / NW) mod 4).

Terms span 1e-10 .. 1e10 in magnitude (random signs), so a wrong order
shows in the low bits. No tolerance: every comparison is ==.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from polars_ols_tpu_torch.ops import cd  # noqa: E402

WIDTHS = [33, 40, 64, 100, 129, 1_000]
# (warps a CTA, CTAs a group) of every cd_fista instantiation
FISTA_SHAPES = [(2, 1), (4, 1), (8, 1), (16, 1), (16, 8)]


def _terms(K, seed=0):
    rng = np.random.default_rng(1_000 * K + seed)
    mag = 10.0 ** rng.uniform(-10, 10, size=K)
    return [float(v) for v in np.where(rng.random(K) < 0.5, -mag, mag)]


def _tree(terms):
    """ops/cd.py:_tree_sum of ``terms`` (zero-padded), a Python float."""
    return float(cd._tree_sum(cd._padded(torch.tensor([terms], dtype=torch.float64)))[0])


def _bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _stream(leaves):
    """A halving tree over 2^b leaves, pushed in bit-reversed order through
    a binary-counter stack (csrc/cd_wide.cu:Tree)."""
    n = len(leaves)
    bits = n.bit_length() - 1
    stack = [None] * (bits + 1)
    for idx in range(n):
        v = leaves[_bit_reverse(idx, bits)]
        lev = 0
        while lev < bits and (idx >> lev) & 1:
            v = stack[lev] + v
            lev += 1
        stack[lev] = v
    return stack[bits]


def _butterfly(vals, offsets):
    """xor levels over a list of per-thread values; every thread's result."""
    for off in offsets:
        vals = [vals[i] + vals[i ^ off] for i in range(len(vals))]
    return vals


def _split(terms, P):
    """The sum split over P threads (thread r: k = r + P j), every thread's
    result."""
    K = len(terms)
    W = max(cd.tree_width(K), P)
    per = [_stream([terms[k] if k < K else 0.0 for k in range(r, W, P)]) for r in range(P)]
    return _butterfly(per, [P >> (i + 1) for i in range(P.bit_length() - 1)])


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("K", WIDTHS)
def test_a_split_over_P_threads_is_the_tree_order(K, P):
    terms = _terms(K)
    got = _split(terms, P)
    assert len(set(got)) == 1  # every thread the same bits
    assert got[0] == _tree(terms)


def _fista_dot(terms, NW, NC):
    """cd_fista's dot over its row slots (see the module docstring), every
    lane of every warp and CTA."""
    K = len(terms)
    S = 8 * NW * NC
    rounds = max(1, cd.tree_width(K) // S)
    N = NW * NC
    part = [None] * N
    for cta in range(NC):
        for warp in range(NW):
            lanes = []
            for lane in range(32):
                s = ((lane // 4) * NW + warp) * NC + cta
                rows = [terms[s + S * u] if s + S * u < K else 0.0 for u in range(rounds)]
                lanes.append(_stream(rows))
            lanes = _butterfly(lanes, [16, 8, 4])
            assert len(set(lanes)) == 1
            part[warp * NC + cta] = lanes[0]
    J = max(1, N // 32)
    lanes = [_stream([part[lane + 32 * j] if lane + 32 * j < N else 0.0 for j in range(J)]) for lane in range(32)]
    return _butterfly(lanes, [16, 8, 4, 2, 1])


@pytest.mark.parametrize("shape", FISTA_SHAPES, ids=[f"{w}w{c}c" for w, c in FISTA_SHAPES])
@pytest.mark.parametrize("K", WIDTHS)
def test_fista_dots_over_row_slots_are_the_tree_order(K, shape):
    terms = _terms(K, seed=1)
    got = _fista_dot(terms, *shape)
    assert len(set(got)) == 1
    assert got[0] == _tree(terms)


def _held_sum(terms, held):
    """cd_cyclic_wide's sum with leaf ``held`` held out (csrc/cd_wide.cu:
    pending, HeldTree): every lane's leaves k = lane + 32 t in their tree,
    the held leaf pushed as 0.0; the lane holding it keeps the sibling sums
    on its path and its partner groups' sums from the butterfly; the leaf's
    value then finishes the sum with log2 W adds."""
    K = len(terms)
    M = cd.tree_width(K) // 32
    bits = M.bit_length() - 1
    lane_sums, sibs = [], {}
    for lane in range(32):
        stack, has, sib = [None] * (bits + 1), [False] * (bits + 1), [None] * bits
        for idx in range(M):
            k = lane + 32 * _bit_reverse(idx, bits)
            hold = k == held
            v = 0.0 if hold or k >= K else terms[k]
            lev = 0
            while lev < bits and (idx >> lev) & 1:
                if hold:
                    sib[lev] = stack[lev]
                if has[lev]:
                    sib[lev] = v
                v = stack[lev] + v
                hold = hold or has[lev]
                lev += 1
            stack[lev], has[lev] = v, hold
        lane_sums.append(stack[bits])
        sibs[lane] = sib
    hl = held % 32
    partners, vals = [], lane_sums
    for off in (16, 8, 4, 2, 1):
        partners.append(vals[hl ^ off])
        vals = [vals[i] + vals[i ^ off] for i in range(32)]
    acc = terms[held]
    for v in sibs[hl] + partners:
        acc = acc + v
    return acc


@pytest.mark.parametrize("K", WIDTHS)
def test_a_held_leaf_completes_the_tree_order(K):
    # the leaf of the coordinate changed last, at the first and last lanes,
    # the tree's edges and sampled positions
    terms = _terms(K, seed=2)
    want = _tree(terms)
    rng = np.random.default_rng(K)
    for held in sorted({0, 1, 31, 32, K - 2, K - 1, *rng.integers(0, K, size=6).tolist()}):
        assert _held_sum(terms, held) == want, held


@pytest.mark.parametrize("NW", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("K", [33, 40, 100, 161])
def test_the_swizzle_keeps_a_warps_rows_on_distinct_banks(K, NW):
    # XtX's row l sits at stride ld = K rounded up to 16 doubles, its
    # 4-double group q at q ^ ((l / NW) mod 4); a half-warp (4 row slots x 4
    # lanes) loads leaf j of its 4 rows: 16 doubles that must fall on 16
    # distinct 8-byte bank pairs (32 banks of 4 bytes), for every j and
    # warp; and the swizzle keeps each row inside its own stride
    ld = -(-K // 16) * 16
    for warp in range(NW):
        for u in range(2):
            for half in range(2):
                for j in range(-(-K // 4)):
                    pairs = set()
                    for lane in range(16 * half, 16 * half + 16):
                        l = (lane // 4) * NW + warp + 8 * NW * u  # local row (NC = 1)
                        k = (lane % 4) + 4 * j
                        pairs.add((l * ld + (k ^ (4 * ((l // NW) % 4)))) % 16)
                    assert len(pairs) == 16
    for l in range(3 * NW):
        assert sorted(k ^ (4 * ((l // NW) % 4)) for k in range(ld)) == list(range(ld))
