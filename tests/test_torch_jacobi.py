"""The one-sided Jacobi SVD least squares under the shared SVD.

``ops/jacobi.py:factor_lstsq`` takes the K x K factors of a Householder
reduction and their targets ``Q^T Y`` and returns the minimum-norm
(ridge-shrunk) beta: the port of the JAX package's ``jacobi_svd_lanes``
with the shrink of ``svd_lstsq_lanes``. On the CPU the wrapper runs its
plain version, ``factor_lstsq_ref``; the kernel itself is held to it on
the card (``tests/test_torch_gpu.py``).

Tolerances: the singular values against the JAX function's and LAPACK's
at rtol 1e-10 and the reconstruction U diag(s) V^T at 1e-9, as the JAX
suite holds its own (tests/test_explicit_solvers.py:36); beta against the
JAX package's grouped solve at ``SOLVER_TOL`` (rtol = atol = 1e-12,
tests/test_torch_linalg.py), and against numpy lstsq at rtol 1e-9 / atol
1e-10. These problems are well conditioned apart from the exact zero and
duplicate columns, which both packages and numpy cut.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402

from polars_ols_tpu_torch.ops import jacobi, linalg  # noqa: E402

SOLVER_TOL = dict(rtol=1e-12, atol=1e-12)
NUMPY_TOL = dict(rtol=1e-9, atol=1e-10)


def _factors(rng, G, K):
    """Upper-triangular factors of tall random problems, columns scaled."""
    X = rng.normal(size=(G, 3 * K + 2, K)) * np.exp(rng.normal(size=(G, 1, K)))
    return np.linalg.qr(X, mode="r")


@pytest.mark.parametrize("K", [1, 2, 5, 16, 32])
def test_singular_values_match_the_jax_lanes_and_lapack(K):
    rng = np.random.default_rng(K)
    G = 6
    F = _factors(rng, G, K)
    if K >= 5:
        F[1, :, 3] = F[1, :, 2]  # a duplicate column
        F[2, :, 4] = 0.0  # a zero column
    W, V, sweeps, _ = jacobi.jacobi_ref(torch.as_tensor(F))
    W, V = W.numpy(), V.numpy()
    s = np.sqrt((W * W).sum(axis=-2))
    U = W / np.where(s == 0, 1.0, s)[:, None, :]
    _, sj, _ = jlinalg.jacobi_svd_lanes(jnp.asarray(F.transpose(1, 2, 0)))
    sj = np.asarray(sj).T
    for g in range(G):
        want = np.linalg.svd(F[g], compute_uv=False)
        got = np.sort(s[g])[::-1]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * want[0])
        np.testing.assert_allclose(got, np.sort(sj[g])[::-1], rtol=1e-10, atol=1e-10 * want[0])
        rec = U[g] @ np.diag(s[g]) @ V[g].T
        np.testing.assert_allclose(rec, F[g], rtol=1e-9, atol=1e-9 * want[0])
        np.testing.assert_allclose(V[g].T @ V[g], np.eye(K), atol=1e-12)
    assert (sweeps.numpy() <= jacobi.MAX_SWEEPS).all()
    assert (sweeps.numpy() >= (1 if K > 1 else 0)).all()


def test_sweeps_stop_when_a_sweep_rotates_nothing():
    # a factor of orthogonal columns (a scaled permutation) rotates nothing
    # in its first sweep; a converged factor is not rotated again
    rng = np.random.default_rng(3)
    Q = np.stack([np.eye(5)[rng.permutation(5)] * rng.normal(size=5) for _ in range(4)])
    W, V, sweeps, rotated = jacobi.jacobi_ref(torch.as_tensor(Q))
    assert sweeps.tolist() == [1, 1, 1, 1]
    assert rotated.shape == (4, 1, 10) and not bool(rotated.any())
    np.testing.assert_array_equal(W.numpy(), Q)
    np.testing.assert_array_equal(V.numpy(), np.broadcast_to(np.eye(5), (4, 5, 5)))
    F = _factors(rng, 8, 5)
    W1, V1, s1, r1 = jacobi.jacobi_ref(torch.as_tensor(F))
    W2, V2, s2, r2 = jacobi.jacobi_ref(W1)
    assert (s1 >= 2).all() and (s2 == 1).all() and not bool(r2.any())
    # the record: every sweep a group ran rotated some pair but its last
    for g, n in enumerate(s1.tolist()):
        assert r1[g, : n - 1].any(dim=-1).all() and not bool(r1[g, n - 1 :].any())
    assert torch.equal(W2, W1)


def _problems(rng, G, n, K, M, case):
    X = rng.normal(size=(G, n, K)) * np.exp(rng.normal(size=(1, 1, K)))
    if case == "duplicate":
        X[:, :, K - 1] = X[:, :, 0]
    if case == "zero":
        X[:, :, K // 2] = 0.0
    Y = X @ rng.normal(size=(K, M)) + 0.1 * rng.normal(size=(G, n, M))
    return X, Y


@pytest.mark.parametrize(
    "K,M,alpha,rcond,case",
    [
        (1, 1, 0.0, None, "plain"),
        (5, 1, 0.0, None, "plain"),
        (5, 2, 0.3, None, "plain"),
        (5, 3, 0.0, 1e-3, "plain"),
        (5, 2, 0.0, None, "duplicate"),
        (5, 2, 0.3, None, "zero"),
        (16, 2, 0.0, None, "plain"),
        (16, 1, 0.3, None, "duplicate"),
        (32, 2, 0.0, None, "plain"),
    ],
)
def test_beta_matches_the_jax_lanes_and_numpy(K, M, alpha, rcond, case):
    rng = np.random.default_rng(100 + K + M)
    G, n = 5, 2 * K + 7
    X, Y = _problems(rng, G, n, K, M, case)
    n_valid = np.full(G, float(n))
    t = linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y), alpha, rcond,
                         torch.as_tensor(n_valid)).numpy()
    j = np.asarray(jlinalg.svd_lstsq_lanes(jnp.asarray(X), jnp.asarray(Y), alpha=alpha, rcond=rcond,
                                           n_valid=jnp.asarray(n_valid)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    if alpha == 0.0:
        for g in range(G):
            want = np.linalg.lstsq(X[g], Y[g], rcond=rcond)[0]
            np.testing.assert_allclose(t[g], want, **NUMPY_TOL)
    if case == "zero":  # the minimum-norm solution leaves the zero column out
        assert (t[:, K // 2] == 0).all()


def test_factor_lstsq_takes_the_trees_strided_views():
    # the engine hands the factor and Q^T Y as views of one [G, K, C]
    # tensor; the result equals that of contiguous copies
    rng = np.random.default_rng(8)
    F = _factors(rng, 7, 5)
    T = torch.as_tensor(np.concatenate([rng.normal(size=(7, 5, 2)), F], axis=-1))
    n_valid = torch.full((7,), 17.0, dtype=torch.float64)
    a = jacobi.factor_lstsq(T[..., 2:], T[..., :2], n_valid)
    b = jacobi.factor_lstsq(T[..., 2:].contiguous(), T[..., :2].contiguous(), n_valid)
    assert torch.equal(a, b)


def test_a_non_finite_lane_is_nan_and_stays_its_own():
    rng = np.random.default_rng(9)
    G, n, K, M = 4, 20, 5, 2
    X, Y = _problems(rng, G, n, K, M, "plain")
    X[1, 3, 2] = np.nan  # the factor: every entry of beta
    Y[2, 5, 1] = np.nan  # a target: its own column
    t = linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
    j = np.asarray(jlinalg.svd_lstsq_lanes(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[1]).all() and np.isnan(t[2][:, 1]).all()
    assert np.isfinite(t[0]).all() and np.isfinite(t[2][:, 0]).all() and np.isfinite(t[3]).all()
    ok = ~np.isnan(t)
    np.testing.assert_allclose(t[ok], j[ok], **SOLVER_TOL)
    F = torch.as_tensor(_factors(rng, 3, K))
    F[0, 1, 1] = np.inf
    beta = jacobi.factor_lstsq(F, torch.ones((3, K, 1), dtype=torch.float64),
                               torch.full((3,), 30.0, dtype=torch.float64))
    assert torch.isnan(beta[0]).all() and torch.isfinite(beta[1:]).all()


@pytest.mark.parametrize("n", [1, 3, 5])
def test_wide_and_square_problems_match_numpy(n):
    # fewer rows than features: padded with zero rows to K (the same V and
    # singular values); the cutoff keeps numpy's eps * max(n, K)
    rng = np.random.default_rng(20 + n)
    G, K = 4, 5
    X, Y = _problems(rng, G, n, K, 2, "plain")
    t = linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    for g in range(G):
        np.testing.assert_allclose(t[g], np.linalg.lstsq(X[g], Y[g], rcond=None)[0], **NUMPY_TOL)


def test_wrapper_checks_its_inputs():
    F = torch.zeros((2, 5, 5), dtype=torch.float64)
    Y = torch.zeros((2, 5, 1), dtype=torch.float64)
    n = torch.ones(2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        jacobi.factor_lstsq(F.float(), Y, n)
    with pytest.raises(TypeError, match=r"\[G, K, K\]"):
        jacobi.factor_lstsq(F[:, :4], Y, n)
    with pytest.raises(TypeError, match="QtY"):
        jacobi.factor_lstsq(F, Y[:, :4], n)
    with pytest.raises(TypeError, match="n_valid"):
        jacobi.factor_lstsq(F, Y, n.float())
    with pytest.raises(ValueError, match="K=0"):
        jacobi.factor_lstsq(F[:, :0, :0], Y[:, :0], n)
    # K = 33, refused before the wide form: the wrapper takes it and gives
    # numpy's minimum-norm beta
    F33 = _factors(np.random.default_rng(33), 1, 33)
    Y33 = np.random.default_rng(34).normal(size=(1, 33, 1))
    b33 = jacobi.factor_lstsq(torch.as_tensor(F33), torch.as_tensor(Y33), n[:1] * 101).numpy()
    np.testing.assert_allclose(b33[0], np.linalg.lstsq(F33[0], Y33[0], rcond=None)[0], **NUMPY_TOL)
    with pytest.raises(ValueError, match="no Jacobi SVD kernel"):
        jacobi.factor_lstsq(F.to("meta"), Y.to("meta"), n.to("meta"))


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(jacobi, "jacobi_kernel_launches", 0)
    rng = np.random.default_rng(1)
    X, Y = _problems(rng, 6, 30, 5, 2, "plain")
    linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y))
    assert jacobi.jacobi_kernel_launches == 0


@pytest.mark.parametrize("bad", [-1, jacobi.MAX_SWEEPS + 1, 2.0, True, None])
def test_wrapper_checks_max_sweeps(bad):
    F = torch.as_tensor(_factors(np.random.default_rng(0), 2, 3))
    Y = torch.ones((2, 3, 1), dtype=torch.float64)
    n = torch.full((2,), 11.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="max_sweeps"):
        jacobi.factor_lstsq(F, Y, n, max_sweeps=bad)
    with pytest.raises(ValueError, match="max_sweeps"):
        jacobi.factor_lstsq_ref(F, Y, n, max_sweeps=bad)


def test_launch_names_the_forms_it_has():
    # the kernel's C entry picks its form by K (tests/test_torch_gpu.py:
    # test_kernel_form_by_k); the wrapper refuses a K it has no form for
    # before it builds anything, and launches nothing on a CPU tensor
    F = torch.zeros((2, 9, 9), dtype=torch.float64)
    Y = torch.zeros((2, 9, 1), dtype=torch.float64)
    n = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="K >= 1, got K=0"):
        jacobi.kernel_form(0)
    assert jacobi.FORMS == ("thread", "segment", "wide")
    with pytest.raises(ValueError, match="no Jacobi SVD kernel"):
        jacobi._launch(F, Y, n, 0.0, None, jacobi.MAX_SWEEPS)
    # K = MAX_K + 1 takes the wide form on the card: on the CPU the plain
    # version, which agrees with the JAX package's lane-major solve
    k = jacobi.MAX_K + 1
    rng = np.random.default_rng(k)
    X, Yk = _problems(rng, 2, 2 * k + 7, k, 2, "duplicate")
    t = linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Yk)).numpy()
    j = np.asarray(jlinalg.svd_lstsq_lanes(jnp.asarray(X), jnp.asarray(Yk)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)


@pytest.mark.parametrize("ex", [-500, 500])
@pytest.mark.parametrize("K", [2, 5, 16])
def test_plain_version_scales_each_group_by_a_power_of_two(K, ex):
    # the rotation tests are taken on squares, which at entries of 2^+-500
    # would over- or underflow: each group is scaled to a largest entry in
    # [1, 2) first, so F 2^ex rotates exactly as F does and beta is beta
    # 2^-ex up to the shrink's rounding
    rng = np.random.default_rng(50 + K)
    F = torch.as_tensor(_factors(rng, 6, K))
    Y = torch.as_tensor(rng.normal(size=(6, K, 2)))
    n = torch.full((6,), 3.0 * K + 2, dtype=torch.float64)
    big = F * 2.0 ** ex
    W, V, sweeps, rotated = jacobi.jacobi_ref(F)
    Wb, Vb, sweeps_b, rotated_b = jacobi.jacobi_ref(big)
    assert torch.equal(sweeps_b, sweeps) and torch.equal(rotated_b, rotated) and int(sweeps.min()) > 1
    assert torch.equal(Vb, V) and torch.equal(Wb, W * 2.0 ** ex)
    want = jacobi.factor_lstsq_ref(F, Y, n) * 2.0 ** -ex
    np.testing.assert_allclose(jacobi.factor_lstsq_ref(big, Y, n).numpy(), want.numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("K", [3, 5, 8])
def test_plain_version_tests_on_squares_as_the_roots_would(K):
    # apq^2 > K eps^2 app aqq is |apq| > sqrt(K) eps |wp| |wq| away from its
    # threshold: on well-conditioned factors every pair of the first sweep
    # rotates and a converged sweep rotates none, as under the root-based
    # rule
    rng = np.random.default_rng(60 + K)
    F = torch.as_tensor(_factors(rng, 8, K))
    W, V, sweeps, rotated = jacobi.jacobi_ref(F)
    assert bool(rotated[:, 0].all()) and not bool(rotated[torch.arange(8), sweeps - 1].any())
    Wn = W / W.norm(dim=-2, keepdim=True)
    off = (Wn.mT @ Wn - torch.eye(K, dtype=torch.float64)).abs().amax()
    assert float(off) <= (math.sqrt(K) + 2 * K) * 2.0 ** -52  # the test's threshold and our own sums' rounding


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_capped_sweeps_match_the_jax_sweeps(n_sweeps):
    # the first sweeps of well-conditioned factors rotate every pair under
    # both rules, so the capped plain version is jacobi_svd_lanes run for as
    # many sweeps: V and the column norms at rtol 1e-12
    rng = np.random.default_rng(30 + n_sweeps)
    F = _factors(rng, 6, 5)
    W, V, sweeps, rotated = jacobi.jacobi_ref(torch.as_tensor(F), max_sweeps=n_sweeps)
    assert sweeps.tolist() == [n_sweeps] * 6 and bool(rotated.all())
    _, sj, vj = jlinalg.jacobi_svd_lanes(jnp.asarray(F.transpose(1, 2, 0)), n_sweeps=n_sweeps)
    np.testing.assert_allclose(V.numpy(), np.asarray(vj).transpose(2, 0, 1), rtol=1e-12, atol=1e-12)
    s = np.sqrt((W.numpy() ** 2).sum(axis=-2))
    np.testing.assert_allclose(s, np.asarray(sj).T, rtol=1e-12)


def test_zero_sweeps_shrink_the_unrotated_columns():
    # no rotation: W = F, V = I, and beta_j = d_j (F_j . y) / sigma_j with
    # sigma_j = |F_j| (the kernel's load-and-epilogue phase)
    rng = np.random.default_rng(12)
    F = torch.as_tensor(_factors(rng, 4, 5))
    Y = torch.as_tensor(rng.normal(size=(4, 5, 2)))
    n = torch.full((4,), 17.0, dtype=torch.float64)
    W, V, sweeps, rotated = jacobi.jacobi_ref(F, max_sweeps=0)
    assert torch.equal(W, F) and torch.equal(V, torch.eye(5, dtype=torch.float64).expand(4, 5, 5))
    assert sweeps.tolist() == [0] * 4 and rotated.shape == (4, 0, 10)
    sigma = F.square().sum(dim=-2).sqrt()
    want = torch.einsum("gij,gim->gjm", F, Y) / (sigma * sigma)[..., None]
    np.testing.assert_allclose(jacobi.factor_lstsq(F, Y, n, max_sweeps=0).numpy(), want.numpy(), rtol=1e-12)


@pytest.mark.parametrize("K", [1, 5, 16])
def test_a_cap_at_or_above_the_rotating_sweeps_changes_nothing(K):
    # the plain version: every cap from the sweeps that rotate up gives the
    # uncapped bits; one below them stops some group short
    rng = np.random.default_rng(40 + K)
    F = torch.as_tensor(_factors(rng, 5, K))
    Y = torch.as_tensor(rng.normal(size=(5, K, 2)))
    n = torch.full((5,), 3.0 * K + 2, dtype=torch.float64)
    _, _, sweeps, _ = jacobi.jacobi_ref(F)
    need = max(int(sweeps.max()) - 1, 0)
    full = jacobi.factor_lstsq(F, Y, n)
    for cap in (need, need + 1, jacobi.MAX_SWEEPS):
        assert torch.equal(jacobi.factor_lstsq(F, Y, n, max_sweeps=cap), full)
    if need:
        assert not torch.equal(jacobi.factor_lstsq(F, Y, n, max_sweeps=need - 1), full)


@pytest.mark.parametrize("K", [2, 3, 5, 33, 40, 100])
def test_sweep_rounds_of_the_wide_form_cover_each_pair_once(K):
    # the circle method: K - 1 rounds (K rounded up to even), each pairing a
    # column with at most one other, every pair (p < q) in exactly one round
    rounds = jacobi.sweep_rounds(K, True)
    assert len(rounds) == K - 1 + (K & 1)
    for pairs in rounds:
        cols = [c for pq in pairs for c in pq]
        assert len(cols) == len(set(cols)) and all(p < q < K for p, q in pairs)
        assert len(pairs) == K // 2
    flat = [pq for pairs in rounds for pq in pairs]
    assert sorted(flat) == [(p, q) for p in range(K - 1) for q in range(p + 1, K)]
    # the other forms' order: cyclic, a pair a round
    assert [pq for r in jacobi.sweep_rounds(K, False) for pq in r] == sorted(flat)


@pytest.mark.parametrize("K", [33, 40])
def test_wide_plain_version_runs_the_rounds(K):
    # above MAX_K the plain version takes the wide form's order: its record
    # has a sweep's pairs in sweep_rounds order, and beta is numpy's
    rng = np.random.default_rng(K)
    F = torch.as_tensor(_factors(rng, 3, K))
    Y = torch.as_tensor(rng.normal(size=(3, K, 1)))
    _, _, sweeps, rotated = jacobi.jacobi_ref(F)
    assert rotated.shape[1:] == (int(sweeps.max()), K * (K - 1) // 2)
    first = jacobi.sweep_rounds(K, True)[0]
    # the first round's pairs share no column, so each rotates on the
    # scaled factor as it came: all of them (a triangular factor's columns
    # are far from orthogonal)
    assert bool(rotated[:, 0, : len(first)].all())
    beta = jacobi.factor_lstsq_ref(F, Y, torch.full((3,), 3.0 * K, dtype=torch.float64)).numpy()
    for g in range(3):
        np.testing.assert_allclose(beta[g], np.linalg.lstsq(F[g].numpy(), Y[g].numpy(), rcond=None)[0], **NUMPY_TOL)
