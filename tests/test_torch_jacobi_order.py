"""The pair order and the column layout of the Jacobi kernel's wide form.

Above K = 32 ``csrc/jacobi_svd.cu`` takes a sweep's pairs in the rounds of
the circle method (``ops/jacobi.py:sweep_rounds(K, wide=True)``), the order
its plain version ``factor_lstsq_ref`` takes too. Where the groups are
fewer than the SMs a group runs on a cluster of CTAs that hold its columns
by position on the circle: at round r column c sits at position (c - r) mod
P (P = m - 1, m = K rounded up to even; column m - 1 is the center), CTA q
takes pairs [q ppc, (q + 1) ppc) and the positions they pair, an arc of L
positions is a ring of L + 1 slots (position x of round rr in slot (x + rr)
mod (L + 1)), and only the column at an arc's lowest position moves to
another arc a round. ``Ring`` below restates the kernel's ``Ring`` and its
pair step in Python; the tests run it for several sweeps and check that
every pair of every round finds its two columns in the slots the kernel
reads, that a moving column lands in a free slot, and that the pairs are
``sweep_rounds``' in order. The plain version is then held to the JAX
package's ``svd_lstsq`` (``polars_ols_tpu/ops/linalg.py:539``) and to numpy
``lstsq`` at K = 33, 40 and 100, rank-deficient, with alpha and rcond, at
the tolerances of ``tests/test_torch_wide_svd.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402

from polars_ols_tpu_torch.ops import jacobi  # noqa: E402

NUMPY_TOL = dict(rtol=1e-9, atol=1e-10)
SOLVER_TOL = dict(rtol=1e-12, atol=1e-12)


class Ring:
    """The kernel's Ring (csrc/jacobi_svd.cu) over ``cols`` columns and
    ``ctas`` CTAs."""

    def __init__(self, cols, ctas):
        self.m = cols + (cols & 1)
        self.P = self.m - 1
        self.ppc = -(-(self.m // 2) // ctas)
        self.ctas = ctas

    def k_lo(self, q):
        return q * self.ppc

    def k_hi(self, q):
        return min(q * self.ppc + self.ppc, self.m // 2)

    def la(self, q):
        return self.k_hi(q) - self.k_lo(q)

    def lb(self, q):
        return max(self.k_hi(q) - max(self.k_lo(q), 1), 0)

    def center_slot(self):
        return self.la(0) + 1 + self.lb(0) + 1

    def locate(self, c, rr):
        if c == self.m - 1:
            return 0, self.center_slot()
        x = (c - rr) % self.P
        if x < self.m // 2:
            q = x // self.ppc
            return q, (x + rr) % (self.la(q) + 1)
        q = (self.P - x) // self.ppc
        return q, self.la(q) + 1 + (x + rr) % (self.lb(q) + 1)

    def arc_of(self, x):
        if x < self.m // 2:
            q = x // self.ppc
            return q, 0, self.la(q) + 1
        q = (self.P - x) // self.ppc
        return q, self.la(q) + 1, self.lb(q) + 1

    def exits(self, q, rr):
        """The kernel's exit counters: where the columns at this CTA's lowest
        A and B positions go, position x - 1 in round rr + 1."""
        xa = self.k_lo(q) - 1 if self.k_lo(q) > 0 else self.P - 1
        xb = self.P - self.k_hi(q)
        (qa, oa, na), (qb, ob, nb) = self.arc_of(xa), self.arc_of(xb)
        return (qa, oa + (xa + 1 + rr) % na), (qb, ob + (xb + 1 + rr) % nb)

    def pair(self, q, k, r, rr, base_a, base_b):
        """The kernel's ring_pair bookkeeping: (column, slot, destination)
        of side A and side B of pair k."""
        k_lo, k_hi = self.k_lo(q), self.k_hi(q)
        la, lb = self.la(q), self.lb(q)
        ca = r + k - self.P if r + k >= self.P else r + k
        cb = self.m - 1 if k == 0 else (r - k + self.P if r - k < 0 else r - k)
        sa = base_a + (k - k_lo)
        sa = sa - la - 1 if sa > la else sa
        sb = self.center_slot()
        if k > 0:
            u = base_b + (k_hi - 1 - k)
            sb = la + 1 + (u - lb - 1 if u > lb else u)
        exit_a, exit_b = self.exits(q, rr)
        da = exit_a if k == k_lo else (q, sa)
        db = exit_b if k > 0 and k == k_hi - 1 else (q, sb)
        return (ca, sa, da), (cb, sb, db)


def _valid_ctas(cols):
    """The cluster sizes the kernel's wide_ctas may pick at ``cols``: every
    CTA takes at least one pair of a round."""
    pairs = (cols + 1) // 2
    return [n for n in (2, 4, 8) if cols >= 4 and (n - 1) * (-(-pairs // n)) < pairs]


LAYOUTS = [(cols, n) for cols in (4, 5, 10, 33, 40, 41, 48, 100, 101, 125) for n in _valid_ctas(cols)]


@pytest.mark.parametrize("cols,ctas", LAYOUTS)
def test_ring_holds_every_pair_where_the_kernel_reads_it(cols, ctas):
    ring = Ring(cols, ctas)
    # before round 0 column c is where locate(c, 0) puts it
    slots = {}
    for c in range(cols):
        q, s = ring.locate(c, 0)
        assert (q, s) not in slots
        slots[(q, s)] = c
    rounds = jacobi.sweep_rounds(cols, True)
    rr = 0
    base = {q: [ring.k_lo(q) % (ring.la(q) + 1),
                (ring.P - ring.k_hi(q) + 1) % (ring.lb(q) + 1) if ring.lb(q) > 0 else 0] for q in range(ctas)}
    for _ in range(3):  # sweeps
        for r in range(ring.P):
            seen, moves = [], {}
            for q in range(ctas):
                for k in range(ring.k_lo(q), ring.k_hi(q)):
                    (ca, sa, da), (cb, sb, db) = ring.pair(q, k, r, rr, *base[q])
                    for c, s, d in ((ca, sa, da), (cb, sb, db)):
                        if c >= cols:  # the odd count's idle center
                            continue
                        assert slots.get((q, s)) == c, (q, k, r, c, s)
                        assert ring.locate(c, rr) == (q, s)
                        assert d == ring.locate(c, rr + 1)
                        if d != (q, s):
                            moves[(q, s)] = (d, c)
                    if ca < cols and cb < cols:
                        seen.append((min(ca, cb), max(ca, cb)))
            assert sorted(seen) == sorted(rounds[r])
            # a moving column lands in a slot that nothing else holds next round
            for src in moves:
                del slots[src]
            for d, c in moves.values():
                assert d not in slots, (r, d)
                slots[d] = c
            # two columns a CTA move on a round at most (one from each arc)
            for q in range(ctas):
                assert sum(1 for (sq, _) in moves if sq == q) <= 2
            for q in range(ctas):
                base[q][0] = 0 if base[q][0] == ring.la(q) else base[q][0] + 1
                base[q][1] = 0 if base[q][1] == ring.lb(q) else base[q][1] + 1
            rr += 1
    # after the sweeps every column is where the epilogue looks for it
    for c in range(cols):
        assert slots[ring.locate(c, rr)] == c


@pytest.mark.parametrize("cols", [33, 40, 41, 64, 100, 119, 120])
def test_circle_rounds_cover_every_pair_once_and_share_no_column(cols):
    rounds = jacobi.sweep_rounds(cols, True)
    assert len(rounds) == cols + (cols & 1) - 1
    pairs = [pq for rnd in rounds for pq in rnd]
    assert sorted(pairs) == [(p, q) for p in range(cols - 1) for q in range(p + 1, cols)]
    for rnd in rounds:
        cols_used = [c for pq in rnd for c in pq]
        assert len(cols_used) == len(set(cols_used))


PLAIN_CASES = {
    # id: (groups, K, M, alpha, rcond, kind)
    "k33": (3, 33, 2, 0.0, None, "factor"),
    "k40_rank_deficient": (3, 40, 1, 0.0, None, "deficient"),
    "k40_alpha_rcond": (2, 40, 2, 0.3, 1e-6, "factor"),
    "k100": (1, 100, 1, 0.0, None, "factor"),
}


def _factors(case):
    G, K, M, alpha, rcond, kind = PLAIN_CASES[case]
    rng = np.random.default_rng(K + M)
    F = np.linalg.qr(rng.normal(size=(G, 3 * K + 2, K)) * np.exp(rng.normal(size=(G, 1, K))), mode="r")
    if kind == "deficient":
        F[0::3, :, K - 1] = F[0::3, :, 0]
        F[1::3, :, K // 2] = 0.0
    Y = rng.normal(size=(G, K, M))
    return F, Y, np.full(G, 3.0 * K + 2), alpha, rcond


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_wide_order_matches_jax_and_numpy(case):
    F, Y, nv, alpha, rcond = _factors(case)
    t = jacobi.factor_lstsq(torch.as_tensor(F), torch.as_tensor(Y), torch.as_tensor(nv), alpha, rcond).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(F), jnp.asarray(Y), alpha=alpha, rcond=rcond,
                                     n_valid=jnp.asarray(nv)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    if alpha == 0.0:
        for g in range(len(F)):
            rc = 2.0 ** -52 * max(nv[g], F.shape[-1]) if rcond is None else rcond
            np.testing.assert_allclose(t[g], np.linalg.lstsq(F[g], Y[g], rcond=rc)[0], **NUMPY_TOL)
    if case == "k40_rank_deficient":  # the zero column's coefficient is exactly zero
        assert (t[1::3, F.shape[-1] // 2] == 0).all()
