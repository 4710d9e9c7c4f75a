"""The PyTorch port's batched solves against the JAX engine's.

Both engines run the same column-recurrence Cholesky, condition estimate
and eigh pseudo-inverse fallback, op for op. Well-conditioned lanes agree
to rounding (rtol 1e-12); lanes with cond(A) up to ~1e10 amplify the
last-bit differences of the two backends' kernels by cond(A), hence
rtol 1e-6 on their solutions; the finite-factor flags must agree exactly,
and singular / all-zero lanes must come out of the eigh fallback with
zero (minimum-norm) coefficients. The explicit solvers (partial-pivot LU,
the Householder reduction, SVD least squares) follow
tests/test_explicit_solvers.py and agree with the JAX engine at 1e-12;
the port's one SVD path is held against both of the JAX engine's (the
lane-major Householder + Jacobi of its grouped fits, and ``svd_lstsq``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402

from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import linalg as tlinalg  # noqa: E402

K = 5


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _lanes(kind: str, n_lanes: int, seed: int):
    """Normal matrices A = X'X and right-hand sides X'y of one kind."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_lanes, 60, K))
    if kind == "ill":  # cond(A) ~ 1e10: the CSNE refinement's branch
        X[..., 1] = X[..., 0] + 1e-5 * rng.normal(size=(n_lanes, 60))
    elif kind == "singular":  # an all-zero feature: the Cholesky fails
        X[..., 2] = 0.0
    elif kind == "zero":  # an empty group
        X[:] = 0.0
    y = X @ rng.normal(size=K) + 0.1 * rng.normal(size=(n_lanes, 60))
    A = np.einsum("gnk,gnl->gkl", X, X)
    b = np.einsum("gnk,gn->gk", X, y)
    return A, b


def _mixed(seed: int, kinds=("well", "ill", "singular", "zero")):
    parts = [_lanes(kind, 3, seed + i) for i, kind in enumerate(kinds)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


RTOL = {"well": 1e-12, "ill": 1e-6, "singular": 1e-12, "zero": 1e-12}


@pytest.mark.parametrize("kind", ["well", "ill", "singular", "zero"])
def test_solve_psd_cond_ok_matches_jax(kind):
    A, b = _lanes(kind, 8, seed=0)
    beta_j, cond_j, ok_j = jlinalg.solve_psd_cond_ok(jnp.asarray(A), jnp.asarray(b))
    beta_t, cond_t, ok_t = tlinalg.solve_psd_cond_ok(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=RTOL[kind], atol=1e-12)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), rtol=RTOL[kind])
    if kind == "ill":
        assert (cond_t.numpy() > 1e6).all()
    if kind in ("singular", "zero"):
        assert not ok_t.any()
        np.testing.assert_array_equal(cond_t.numpy(), 1.0)
    if kind == "singular":
        np.testing.assert_allclose(beta_t.numpy()[:, 2], 0.0, atol=1e-12)
    if kind == "zero":
        np.testing.assert_array_equal(beta_t.numpy(), 0.0)


def test_mixed_batch_takes_fallback_only_on_failed_lanes():
    A, b = _mixed(seed=10)
    beta_t, cond_t, ok_t = tlinalg.solve_psd_cond_ok(torch.as_tensor(A), torch.as_tensor(b))
    beta_j, cond_j, ok_j = jlinalg.solve_psd_cond_ok(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=1e-6, atol=1e-12)
    # solve_psd and solve_psd_cond give the same solution
    np.testing.assert_array_equal(
        tlinalg.solve_psd(torch.as_tensor(A), torch.as_tensor(b)).numpy(), beta_t.numpy()
    )
    np.testing.assert_array_equal(
        tlinalg.solve_psd_cond(torch.as_tensor(A), torch.as_tensor(b))[1].numpy(),
        cond_t.numpy(),
    )


def test_chol_factor_matches_jax():
    A, _ = _mixed(seed=20)
    L_t, ok_t = tlinalg.chol_factor_vectorized(torch.as_tensor(A))
    L_j, ok_j = jlinalg.chol_factor_vectorized(jnp.asarray(A))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = ok_t.numpy()
    np.testing.assert_allclose(L_t.numpy()[ok], np.asarray(L_j)[ok], rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(np.isnan(L_t.numpy()), np.isnan(np.asarray(L_j)))


def test_psd_solver_reuses_factor_like_jax():
    A, b = _mixed(seed=30)
    rhs = np.stack([b, 2.0 * b + 1.0], axis=-1)  # two right-hand sides
    solve_t = tlinalg.psd_solver(torch.as_tensor(A))
    solve_j = jlinalg.psd_solver(jnp.asarray(A))
    np.testing.assert_allclose(
        solve_t(torch.as_tensor(rhs)).numpy(), np.asarray(solve_j(jnp.asarray(rhs))),
        rtol=1e-6, atol=1e-12,
    )
    np.testing.assert_allclose(
        solve_t(torch.as_tensor(b)).numpy(), np.asarray(solve_j(jnp.asarray(b))),
        rtol=1e-6, atol=1e-12,
    )


def test_eigh_pinv_solve_matches_jax():
    # the fallback's lanes: singular and empty systems (on the ill lanes the
    # two LAPACK eigh paths differ by ~eps * cond(A), which the engine never
    # asks of it: those lanes factor)
    A, b = _mixed(seed=40, kinds=("well", "singular", "zero"))
    np.testing.assert_allclose(
        tlinalg.eigh_pinv_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
        np.asarray(jlinalg.eigh_pinv_solve(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-10, atol=1e-12,
    )


def test_more_than_32_features_raises():
    A = torch.eye(tlinalg.MAX_K + 1, dtype=torch.float64)[None]
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tlinalg.solve_psd(A, torch.ones((1, tlinalg.MAX_K + 1), dtype=torch.float64))


def test_eigh_fallback_gives_nan_on_a_nan_lane_like_jax():
    # an 'ignore'-policy group whose moments hold a NaN: torch's eigh
    # would raise, the JAX engine's gives NaN, and so must the port
    A, b = _mixed(seed=50, kinds=("well", "singular"))
    A[1, 0, 0] = np.nan
    b[4, 1] = np.nan  # a finite A with a NaN right-hand side
    t = tlinalg.eigh_pinv_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    j = np.asarray(jlinalg.eigh_pinv_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[1]).all() and np.isfinite(t[0]).all()
    np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-12)
    s = tlinalg.solve_psd(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(np.isnan(s), np.isnan(np.asarray(
        jlinalg.solve_psd(jnp.asarray(A), jnp.asarray(b))
    )))


# the explicit solvers: the JAX engine's arithmetic, op for op, so 1e-12
SOLVER_TOL = dict(rtol=1e-12, atol=1e-12)


def _lu_cases(case: str, seed: int):
    rng = np.random.default_rng(seed)
    if case == "general":  # nonsymmetric, indefinite
        return rng.normal(size=(50, 7, 7)), rng.normal(size=(50, 7))
    if case == "matrix_rhs":
        return rng.normal(size=(50, 7, 7)), rng.normal(size=(50, 7, 3))
    if case == "pivoting":  # zero leading pivots
        A = np.array([
            [[0.0, 2.0, 1.0], [1.0, 0.0, 3.0], [4.0, 1.0, 0.0]],
            [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 5.0]],
        ])
        return A, np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    good = rng.normal(size=(K, K))  # "singular": one lane falls back to pinv
    good = good @ good.T + K * np.eye(K)
    return np.stack([good, np.ones((K, K))]), rng.normal(size=(2, K))


@pytest.mark.parametrize("case", ["general", "matrix_rhs", "pivoting", "singular"])
def test_solve_lu_matches_jax(case):
    A, b = _lu_cases(case, seed=60)
    t = tlinalg.solve_lu(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    j = np.asarray(jlinalg.solve_lu(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    if case == "singular":
        np.testing.assert_allclose(t[1], np.linalg.pinv(A[1]) @ b[1], rtol=1e-8, atol=1e-9)
    else:
        exp = np.linalg.solve(A, b[..., None])[..., 0] if b.ndim == 2 else np.linalg.solve(A, b)
        np.testing.assert_allclose(t, exp, rtol=1e-10, atol=1e-11)


def test_householder_reduce_matches_jax():
    # the port's row-major reduction against both of the JAX engine's forms:
    # its own row-major one and the lane-major one its grouped path runs
    rng = np.random.default_rng(61)
    X = rng.normal(size=(80, 50, K))
    X[:5, 30:] = 0.0  # padding rows
    X[7, :, 2] = 0.0  # a zero column: an identity reflection
    Y = rng.normal(size=(80, 50, 1))
    Rt, Qt = (a.numpy() for a in tlinalg._householder_reduce(torch.as_tensor(X), torch.as_tensor(Y)))
    Rj, Qj = jlinalg._householder_reduce(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(Rt, np.asarray(Rj), **SOLVER_TOL)
    np.testing.assert_allclose(Qt, np.asarray(Qj), **SOLVER_TOL)
    Rl, Ql = jlinalg.householder_lanes(jnp.asarray(X.transpose(1, 2, 0)), jnp.asarray(Y.transpose(1, 2, 0)))
    np.testing.assert_allclose(Rt, np.asarray(Rl).transpose(2, 0, 1), **SOLVER_TOL)
    np.testing.assert_allclose(Qt, np.asarray(Ql).transpose(2, 0, 1), **SOLVER_TOL)
    for g in (0, 7, 79):  # and R'R is the Gram matrix
        np.testing.assert_allclose(Rt[g].T @ Rt[g], X[g].T @ X[g], rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("alpha", [0.0, 0.3])
@pytest.mark.parametrize("deficient", [False, True])
def test_grouped_svd_lstsq_matches_jax_lanes(alpha, deficient):
    # the port's one SVD path against the JAX engine's grouped one
    # (lane Householder + one-sided Jacobi)
    rng = np.random.default_rng(63)
    G, R, k = 70, 40, 4
    X = rng.normal(size=(G, R, k))
    X[:, 30:] = 0.0  # padded / masked rows
    if deficient:
        X[..., 3] = X[..., 2]  # the rank cutoff: minimum norm
    y = np.einsum("grk,k->gr", X, np.arange(1.0, k + 1)) + rng.normal(size=(G, R)) * 0.1
    n_valid = np.full(G, 30.0)
    t = tlinalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(y), alpha,
                          n_valid=torch.as_tensor(n_valid)).numpy()
    j = np.asarray(jlinalg.svd_lstsq_lanes(jnp.asarray(X), jnp.asarray(y), alpha=alpha,
                                           n_valid=jnp.asarray(n_valid)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    if alpha == 0.0:
        for g in (0, 33):
            np.testing.assert_allclose(t[g], np.linalg.lstsq(X[g], y[g], rcond=None)[0],
                                       rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("shape", ["tall", "wide", "multi_target"])
def test_svd_lstsq_matches_jax(shape):
    rng = np.random.default_rng(64)
    n = {"tall": 40, "wide": 3, "multi_target": 40}[shape]
    X = rng.normal(size=(6, n, K))
    X[2, :, 1] = 0.0  # a zero feature in one problem: cut
    y = rng.normal(size=(6, n, 2) if shape == "multi_target" else (6, n))
    n_valid = np.full(6, float(n))
    t = tlinalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(y), 0.1 if shape == "tall" else 0.0,
                          n_valid=torch.as_tensor(n_valid)).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(X), jnp.asarray(y), alpha=0.1 if shape == "tall" else 0.0,
                                     n_valid=jnp.asarray(n_valid)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)


def test_svd_lstsq_gives_nan_on_a_nan_problem_like_jax():
    rng = np.random.default_rng(65)
    X = rng.normal(size=(3, 40, K))
    y = rng.normal(size=(3, 40))
    X[1, 5, 2] = np.nan  # torch's svd would raise on this factor
    y[2, 7] = np.nan
    t = tlinalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(y)).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(X), jnp.asarray(y)))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[1:]).all()
    np.testing.assert_allclose(t[0], j[0], **SOLVER_TOL)


def test_eigh_fallback_runs_in_bounded_batches_on_the_failed_lanes_only(monkeypatch):
    # cuSOLVER's batched eigh refuses batches of 32,768 matrices and more:
    # the fallback selects the failed lanes and decomposes them a bounded
    # number a call, with the same result as one call over every lane
    rng = np.random.default_rng(11)
    X = rng.normal(size=(4, 37, 9, 3))
    A = np.einsum("abrk,abrl->abkl", X, X)
    A[1, 5] = 0.0  # a zero system: minimum-norm zero
    A[2, 7, :, 1] = A[2, 7, 1, :] = 0.0  # a dead feature: Cholesky fails
    b = rng.normal(size=(4, 37, 3))
    b[2, 7, 1] = 0.0
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    whole = tlinalg.solve_psd(At, bt)
    calls = []
    real = torch.linalg.eigh
    monkeypatch.setattr(tlinalg, "_EIGH_LANES", 1)
    monkeypatch.setattr(torch.linalg, "eigh", lambda M: calls.append(M.shape[0]) or real(M))
    chunked = tlinalg.solve_psd(At, bt)
    assert calls == [1, 1]  # two failed lanes, one a call
    assert torch.equal(whole, chunked)
    assert (chunked[1, 5] == 0).all() and chunked[2, 7, 1] == 0
    monkeypatch.setattr(tlinalg, "_EIGH_LANES", 50)
    w, v = tlinalg._eigh_chunked(At)
    w0, v0 = real(At)
    assert torch.equal(w, w0) and torch.equal(v, v0) and w.shape == (4, 37, 3)
