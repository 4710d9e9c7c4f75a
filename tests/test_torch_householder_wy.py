"""The blocked (compact WY) arithmetic of the Householder kernel's wide form.

``csrc/householder.cu``'s wide form reduces a block in panels of eight
feature columns: each panel's reflections over the panel's columns only,
then one update of the targets and the later features by the compact WY
form, ``A -= V (T^T (V^T A))``, its products on the FP64 tensor cores.
``ops/householder.py:householder_blocks_wy`` is that arithmetic in torch
ops. Here it is held, on the CPU, to the contract's plain version
(``householder_blocks_ref``, the per-reflection ``_householder_reduce``)
and to the JAX package's ``_householder_reduce``
(``polars_ols_tpu/ops/linalg.py:382``), each entry within 1e-12 of its
column's norm over the block's valid rows (the kernel's REDUCTION_RTOL,
``chip_smoke.py``): a panel width that does not divide K, fewer rows than
a panel, a zero pivot column inside a panel, NaN in masked slots, a stop
in the middle of a panel, and the shapes the card takes. On the card the
kernel is held to ``householder_blocks_ref`` (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402

from polars_ols_tpu_torch.ops import householder  # noqa: E402

REDUCTION_RTOL = 1e-12

CASES = {
    # id: (blocks, rows, columns, K, zero feature column, NaN in masked slots)
    "k33_c35_panel_not_dividing_k": (3, 90, 35, 33, None, False),
    "k41_c43_panel_not_dividing_k": (3, 90, 43, 41, None, True),
    "r5_below_a_panel": (4, 5, 41, 40, None, True),
    "r12_below_k": (3, 12, 21, 18, None, False),
    "zero_pivot_inside_a_panel": (3, 80, 42, 40, 10, False),
    "zero_pivot_at_a_panel_start": (3, 80, 42, 40, 8, True),
    "m40_k3_one_panel": (3, 120, 43, 3, None, False),
    "m2_k8_one_full_panel": (3, 60, 10, 8, None, False),
    "m1_k100_thirteen_panels": (2, 130, 101, 100, None, True),
}


def _block(case):
    B, R, C, K, zero_col, nan_masked = CASES[case]
    rng = np.random.default_rng(len(case) + C)
    Z = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    w = rng.random((B, R)) > 0.2
    if zero_col is not None:
        Z[:, :, C - K + zero_col] = 0.0
    if nan_masked:
        Z[~w] = np.nan
    return Z, w, K


def _within(T, ref, Z, w, rows=None):
    """Each entry of T within REDUCTION_RTOL of its column's norm over the
    block's valid rows from ref (the first ``rows`` rows); both finite."""
    norm = np.sqrt((np.where(w[..., None], Z, 0.0) ** 2).sum(axis=1, keepdims=True))
    T, ref = T[:, :rows], ref[:, :rows]
    assert np.isfinite(T).all() and np.isfinite(ref).all()
    err = np.abs(T - ref)
    assert (err <= REDUCTION_RTOL * norm).all(), float((err / np.maximum(norm, 1e-300)).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_wy_matches_the_plain_version(case):
    Z, w, K = _block(case)
    Zt, wt = torch.as_tensor(Z), torch.as_tensor(w)
    T = householder.householder_blocks_wy(Zt, wt, K).numpy()
    _within(T, householder.householder_blocks_ref(Zt, wt, K).numpy(), Z, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wy_matches_the_jax_reduction(case):
    Z, w, K = _block(case)
    B, R, C = Z.shape
    T = householder.householder_blocks_wy(torch.as_tensor(Z), torch.as_tensor(w), K).numpy()
    Zs = np.where(w[..., None], Z, 0.0)
    if R < K:
        Zs = np.concatenate([Zs, np.zeros((B, K - R, C))], axis=1)
        assert (T[:, R:] == 0).all()
    m = C - K
    Rj, Qj = jlinalg._householder_reduce(jnp.asarray(Zs[..., m:]), jnp.asarray(Zs[..., :m]))
    _within(T, np.concatenate([np.asarray(Qj), np.asarray(Rj)], axis=-1), Z, w)


@pytest.mark.parametrize("reflections", [0, 1, 7, 8, 9, 17, 33])
def test_wy_stops_after_its_reflections(reflections):
    # the kernel's phase entry stops after any number of reflections, in the
    # middle of a panel too: rows 0 .. r - 1 are then final (the full
    # reduction's first r rows), and after none the masked panel's first K
    # rows come back as they were
    Z, w, K = _block("k41_c43_panel_not_dividing_k")
    Zt, wt = torch.as_tensor(Z), torch.as_tensor(w)
    T = householder.householder_blocks_wy(Zt, wt, K, reflections).numpy()
    if reflections == 0:
        assert np.array_equal(T, np.where(w[:, :K, None], Z[:, :K], 0.0))
        return
    _within(T, householder.householder_blocks_ref(Zt, wt, K).numpy(), Z, w, rows=reflections)


def test_wy_reflected_columns_are_zero_below_the_diagonal_and_alpha_on_it():
    # the pivot column keeps v below the diagonal while the panel is
    # reduced; what comes out is R: zero below the diagonal, alpha = -sign(
    # c_jj) ||col|| on it, so |R_jj| is the norm of what the earlier
    # reflections left of the column
    Z, w, K = _block("zero_pivot_inside_a_panel")
    B, R, C = Z.shape
    M = C - K
    T = householder.householder_blocks_wy(torch.as_tensor(Z), torch.as_tensor(w), K).numpy()
    F = T[..., M:]
    assert (np.tril(F, k=-1) == 0).all()
    # a zero column gives a zero diagonal entry (the identity reflection)
    assert (F[:, 10, 10] == 0).all()
    Zs = np.where(w[..., None], Z, 0.0)
    Rn = np.linalg.qr(Zs[..., M:], mode="r")
    np.testing.assert_allclose(np.abs(np.diagonal(F, axis1=1, axis2=2)),
                               np.abs(np.diagonal(Rn, axis1=1, axis2=2)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("nb", [1, 3, 8, 16])
def test_wy_panel_width_does_not_change_the_reduction(nb):
    # one reflection a panel is the plain version's order; any width is the
    # same reduction up to the order of the sums
    Z, w, K = _block("k33_c35_panel_not_dividing_k")
    Zt, wt = torch.as_tensor(Z), torch.as_tensor(w)
    T = householder.householder_blocks_wy(Zt, wt, K, nb=nb).numpy()
    _within(T, householder.householder_blocks_ref(Zt, wt, K).numpy(), Z, w)
