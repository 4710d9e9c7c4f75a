"""The Householder reduction under the shared SVD, and its tree (TSQR).

``ops/householder.py`` reduces masked row blocks ``[B, R, C]`` (targets
first) to their first K rows after K reflections, ``[Q^T Y | R]``, and
reduces a group's stacked block factors again until one is left. On the
CPU the wrapper runs its plain version, ``_householder_reduce`` over the
selected blocks; the kernel itself is held to it on the card
(``tests/test_torch_gpu.py``).

Tolerances: the tree's factor against one reduction of all of a group's
rows agrees up to the signs of its rows (R is unique up to them): the
entries' magnitudes and Q^T Y's at 1e-12 of their column's norm; R^T R
against X^T X and the solutions against numpy lstsq at rtol 1e-12 (the
JAX suite's tolerance for moments is 5e-13, tests/test_ozaki.py:39, for
coefficients 1e-9, :60; these problems are well conditioned).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402

from polars_ols_tpu_torch.ops import householder, linalg  # noqa: E402

K, M = 5, 2
ROWS = 64


def _group_blocks(rng, n_rows, R=ROWS, C=M + K, masked=0.1, nan_masked=False):
    """One group's rows cut into blocks of R (the last one partly padded),
    its mask and the rows themselves."""
    Z = rng.normal(size=(n_rows, C)) * np.exp(rng.normal(size=C))
    w = rng.random(n_rows) >= masked
    S = -(-n_rows // R)
    Zb = np.zeros((S * R, C))
    wb = np.zeros(S * R, dtype=bool)
    Zb[:n_rows], wb[:n_rows] = Z, w
    if nan_masked:
        Zb[~wb] = np.nan
    return Zb.reshape(S, R, C), wb.reshape(S, R), Z[w]


def _tree(blocks):
    """The factors [G, K, C] of groups of blocks by the plan and the
    wrapper (the plain version on the CPU)."""
    Zs = np.concatenate([b[0] for b in blocks])
    ws = np.concatenate([b[1] for b in blocks])
    n_blocks = np.asarray([len(b[0]) for b in blocks])
    plan = householder.plan_reduction(n_blocks, K)
    return householder.reduce_groups(torch.as_tensor(Zs), torch.as_tensor(ws), K, plan).numpy(), plan


@pytest.mark.parametrize("sizes", [[3_000], [64, 65, 1, 3_000, 200], [20_000, 10]])
def test_tree_equals_one_reduction_of_the_group(sizes):
    rng = np.random.default_rng(len(sizes))
    blocks = [_group_blocks(rng, n) for n in sizes]
    T, plan = _tree(blocks)
    assert T.shape == (len(sizes), K, M + K)
    for g, (_, _, Zv) in enumerate(blocks):
        if len(Zv) <= K:  # rank deficient: the rows below the rank are round-off
            continue
        R1, Q1 = linalg._householder_reduce(torch.as_tensor(Zv[None, :, M:]), torch.as_tensor(Zv[None, :, :M]))
        one = torch.cat([Q1, R1], dim=-1)[0].numpy()
        # rows agree up to sign: compare with each row's sign aligned on the diagonal
        sign = np.sign(np.diagonal(T[g][:, M:]) * np.diagonal(one[:, M:]))
        norm = np.linalg.norm(Zv, axis=0)
        err = np.abs(T[g] * sign[:, None] - one)
        assert (err <= 1e-12 * norm).all(), (err / norm).max()


@pytest.mark.parametrize("case", ["plain", "zero_column", "nan_in_masked_slots", "r_below_k"])
def test_tree_factor_against_numpy(case):
    rng = np.random.default_rng(7)
    R = 3 if case == "r_below_k" else ROWS
    sizes = [2, 3, 7] if case == "r_below_k" else [1_000, 129, 40]
    blocks = [_group_blocks(rng, n, R=R, nan_masked=case == "nan_in_masked_slots") for n in sizes]
    if case == "zero_column":
        for Zb, _, Zv in blocks:
            Zb[..., M + 2] = 0.0
            Zv[:, M + 2] = 0.0
    T, _ = _tree(blocks)
    assert np.isfinite(T).all()
    n_valid = torch.as_tensor([float(len(b[2])) for b in blocks])
    beta = linalg.svd_lstsq_from_factor(
        torch.as_tensor(T[..., M:]), torch.as_tensor(T[..., :M]), n_valid
    ).numpy()
    for g, (Zb, _, Zv) in enumerate(blocks):
        X, Y = Zv[:, M:], Zv[:, :M]
        Rf = T[g][:, M:]
        scale = np.abs(X.T @ X).max()
        np.testing.assert_allclose(Rf.T @ Rf, X.T @ X, rtol=1e-12, atol=1e-12 * scale)
        if len(Zb) == 1 and R < K:  # a block of fewer rows than features: zero rows below its last
            assert (T[g][R:] == 0).all()
        want = np.linalg.lstsq(X, Y, rcond=None)[0]
        np.testing.assert_allclose(beta[g], want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        if case == "zero_column":  # the minimum-norm solution leaves it out
            assert (np.abs(beta[g][2]) <= 1e-14 * np.abs(want).max()).all()


def test_blocks_match_the_jax_reduction():
    # one level (every group one block) against the JAX package's own
    # _householder_reduce on the same selected rows: entry for entry
    rng = np.random.default_rng(11)
    Z = rng.normal(size=(40, 33, M + K))
    w = rng.random((40, 33)) > 0.3
    T = householder.householder_blocks(torch.as_tensor(Z), torch.as_tensor(w), K).numpy()
    Zs = np.where(w[..., None], Z, 0.0)
    Rj, Qj = jlinalg._householder_reduce(jnp.asarray(Zs[..., M:]), jnp.asarray(Zs[..., :M]))
    np.testing.assert_allclose(T[..., M:], np.asarray(Rj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(T[..., :M], np.asarray(Qj), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize(
    "B,R,C,k,nan_masked",
    [
        (30, 510, 7, 5, False),  # the tree's second level: 102 factors of K = 5
        (40, 37, 7, 5, True),  # rows that leave threads of the kernel without one
        (40, 200, 2, 1, False),  # C = 2: one feature, one target
        (10, 300, 33, 32, True),  # C = 33: K = 32, one target
        (20, 20, 33, 32, False),  # R < K at K = 32: zero rows below the last
        (40, 3, 8, 5, True),  # R < K at K = 5
    ],
)
def test_block_edges_match_the_jax_reduction(B, R, C, k, nan_masked):
    # the register panel's edges through the wrapper (its plain version on
    # the CPU; the kernel is held to it on the card): R and Q^T Y against
    # the JAX package's _householder_reduce of the selected rows, a block
    # of fewer than K rows padded with zero rows as the kernel pads it
    rng = np.random.default_rng(R + C)
    Z = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=C))
    w = rng.random((B, R)) > 0.2
    if nan_masked:
        Z[~w] = np.nan
    T = householder.householder_blocks(torch.as_tensor(Z), torch.as_tensor(w), k).numpy()
    assert T.shape == (B, k, C) and np.isfinite(T).all()
    Zs = np.where(w[..., None], Z, 0.0)
    if R < k:
        Zs = np.concatenate([Zs, np.zeros((B, k - R, C))], axis=1)
        assert (T[:, R:] == 0).all()
    m = C - k
    Rj, Qj = jlinalg._householder_reduce(jnp.asarray(Zs[..., m:]), jnp.asarray(Zs[..., :m]))
    norm = np.sqrt((Zs * Zs).sum(axis=1, keepdims=True))
    assert (np.abs(T[..., m:] - np.asarray(Rj)) <= 1e-12 * norm[..., m:]).all()
    assert (np.abs(T[..., :m] - np.asarray(Qj)) <= 1e-12 * norm[..., :m]).all()


def test_blocks_of_more_rows_than_the_kernel_takes_are_cut_first(monkeypatch):
    # a row cap above MAX_ROWS (CONFIG.moment_chunk_rows): each block is cut
    # into pieces of MAX_ROWS, reduced, and its pieces' factors stand in for
    # its rows; the factor equals one reduction of the group up to row signs
    monkeypatch.setattr(householder, "MAX_ROWS", 64)
    rng = np.random.default_rng(12)
    blocks = [_group_blocks(rng, n, R=150) for n in (400, 90, 150)]
    T, _ = _tree(blocks)
    for g, (_, _, Zv) in enumerate(blocks):
        R1, Q1 = linalg._householder_reduce(torch.as_tensor(Zv[None, :, M:]), torch.as_tensor(Zv[None, :, :M]))
        one = torch.cat([Q1, R1], dim=-1)[0].numpy()
        sign = np.sign(np.diagonal(T[g][:, M:]) * np.diagonal(one[:, M:]))
        assert (np.abs(T[g] * sign[:, None] - one) <= 1e-12 * np.linalg.norm(Zv, axis=0)).all()


def test_wide_blocks_of_more_rows_than_the_wide_form_takes_are_cut_first(monkeypatch):
    # the wide form (C > 33) reads its pivot column in place from its panel,
    # so it takes a block of any length whole, and reduce_groups cuts only
    # register form blocks longer than MAX_ROWS; a level of the tree stacks
    # factors up to max(MAX_ROWS, 2 K) rows a block. At K = 40 and C = 43
    # (three targets) with MAX_ROWS lowered to 128: blocks of 300 rows are
    # reduced whole, then three factors a block; the group's factor is one
    # reduction of its rows up to row signs
    monkeypatch.setattr(householder, "MAX_ROWS", 128)
    k, m = 40, 3
    rng = np.random.default_rng(14)
    blocks = [_group_blocks(rng, n, R=300, C=m + k) for n in (700, 250)]
    Zs = np.concatenate([b[0] for b in blocks])
    ws = np.concatenate([b[1] for b in blocks])
    plan = householder.plan_reduction(np.asarray([len(b[0]) for b in blocks]), k)
    T = householder.reduce_groups(torch.as_tensor(Zs), torch.as_tensor(ws), k, plan).numpy()
    for g, (_, _, Zv) in enumerate(blocks):
        R1, Q1 = linalg._householder_reduce(torch.as_tensor(Zv[None, :, m:]), torch.as_tensor(Zv[None, :, :m]))
        one = torch.cat([Q1, R1], dim=-1)[0].numpy()
        sign = np.sign(np.diagonal(T[g][:, m:]) * np.diagonal(one[:, m:]))
        assert (np.abs(T[g] * sign[:, None] - one) <= 1e-12 * np.linalg.norm(Zv, axis=0)).all()
    # the wide form itself takes a block of more rows than the limit
    assert householder.householder_blocks(torch.as_tensor(Zs), torch.as_tensor(ws), k).shape == (len(Zs), k, m + k)
    # past K = 64, half the limit, a level stacks factors of more rows than
    # the limit (they once raised "K <= 64"): the
    # tree still gives each group one reduction of its rows, held to the
    # JAX package's _householder_reduce; K = 65 on blocks of 300 rows, and
    # K = 100 on blocks of 60 rows (fewer than K: a level stacks only the
    # 60 leading rows of their factors)
    for k2, R2 in ((65, 300), (100, 60)):
        blocks2 = [_group_blocks(rng, n, R=R2, C=m + k2) for n in (700, 250)]
        Zs2 = np.concatenate([b[0] for b in blocks2])
        ws2 = np.concatenate([b[1] for b in blocks2])
        plan2 = householder.plan_reduction(np.asarray([len(b[0]) for b in blocks2]), k2, rows=R2)
        assert plan2.levels[0][1].shape[1] > householder.MAX_ROWS
        T2 = householder.reduce_groups(torch.as_tensor(Zs2), torch.as_tensor(ws2), k2, plan2).numpy()
        for g, (_, _, Zv) in enumerate(blocks2):
            Rj, Qj = jlinalg._householder_reduce(jnp.asarray(Zv[None, :, m:]), jnp.asarray(Zv[None, :, :m]))
            one = np.concatenate([np.asarray(Qj), np.asarray(Rj)], axis=-1)[0]
            sign = np.sign(np.diagonal(T2[g][:, m:]) * np.diagonal(one[:, m:]))
            assert (np.abs(T2[g] * sign[:, None] - one) <= 1e-12 * np.linalg.norm(Zv, axis=0)).all()


@pytest.mark.parametrize(
    "n_blocks,k,levels",
    [([1, 1, 1], 5, 0), ([2, 1, 3], 5, 1), ([15_625], 5, 3), ([3_907], 5, 2), ([200, 1], 32, 2)],
)
def test_plan_levels(n_blocks, k, levels):
    # one group of 8,000,000 rows (15,625 blocks of 512) takes three levels
    # after its blocks'; 2,000,000 rows two
    plan = householder.plan_reduction(np.asarray(n_blocks), k)
    assert len(plan.levels) == levels
    per = householder.MAX_ROWS // k
    for gather, mask in plan.levels:
        assert mask.shape[1] <= per * k and mask.shape[1] % k == 0
        assert int(gather.max()) >= 0 and bool(mask[:, :k].all())
    if levels == 0 or len(n_blocks) == 1:
        assert plan.final is None


def test_plan_final_index_picks_each_groups_last_factor():
    plan = householder.plan_reduction(np.asarray([2, 1, 250]), 5)
    # level 0: 253 factors; level 1: group 0 one block, group 2 three; level 2: group 2 one
    assert [tuple(m.shape) for _, m in plan.levels] == [(4, 510), (1, 15)]
    assert plan.final.tolist() == [253, 2, 257]


def test_wrapper_checks_its_inputs():
    Z = torch.zeros((2, 8, 6), dtype=torch.float64)
    w = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="float64"):
        householder.householder_blocks(Z.float(), w, 5)
    with pytest.raises(TypeError, match="bool"):
        householder.householder_blocks(Z, w.double(), 5)
    with pytest.raises(ValueError, match="K=6"):
        householder.householder_blocks(Z, w, 6)
    with pytest.raises(ValueError, match="contiguous"):
        householder.householder_blocks(Z.transpose(0, 1).contiguous().transpose(0, 1), w, 5)
    with pytest.raises(ValueError, match="at most 512 rows"):
        householder.householder_blocks(torch.zeros((1, 2_000, 33), dtype=torch.float64),
                                       torch.ones((1, 2_000), dtype=torch.bool), 5)


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(householder, "householder_kernel_launches", 0)
    rng = np.random.default_rng(1)
    blocks = [_group_blocks(rng, 500)]
    _tree(blocks)
    assert householder.householder_kernel_launches == 0
