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
    with pytest.raises(ValueError, match="K=33"):
        jacobi.factor_lstsq(torch.zeros((1, 33, 33), dtype=torch.float64),
                            torch.zeros((1, 33, 1), dtype=torch.float64), n[:1])
    with pytest.raises(ValueError, match="no Jacobi SVD kernel"):
        jacobi.factor_lstsq(F.to("meta"), Y.to("meta"), n.to("meta"))


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(jacobi, "jacobi_kernel_launches", 0)
    rng = np.random.default_rng(1)
    X, Y = _problems(rng, 6, 30, 5, 2, "plain")
    linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y))
    assert jacobi.jacobi_kernel_launches == 0
