"""Solver dispatch and grouped moments for the batched direct solvers."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .moments import grouped_moments_blocks


def grouped_moments(
    Zp: torch.Tensor,  # [S, R, 1+K] split-padded blocks, target in column 0
    wp: torch.Tensor,  # [S, R] bool fit mask
    block_offsets: torch.Tensor,  # [G+1] CSR offsets into the block axis
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-group XtX [G,K,K], Xty [G,K] and valid counts [G], sliced out of
    the full moment matrix of ``[y | X]`` (ops/moments.py)."""
    M, counts = grouped_moments_blocks(Zp, wp, block_offsets, num_groups)
    return M[:, 1:, 1:], M[:, 1:, 0], counts


def resolve_solve_method(
    solve_method: Optional[str],
    alpha: float,
    l1_ratio: Optional[float],
    positive: bool,
    n_rows: int,
    n_features: int,
) -> str:
    """Static resolution of the reference's solver dispatch table
    (src/expressions.rs:361-388): coordinate descent for L1 / positive
    fits, Cholesky for ridge, and for plain OLS the fused normal-equation
    path ('chol') when overdetermined, SVD otherwise. Explicit methods are
    honored. A negative alpha, or an L1 / positive fit without a positive
    alpha, raises ``AssertionError`` as the JAX package's asserts do."""
    if alpha < 0.0:
        raise AssertionError("regularization alpha must be non-negative")
    l1 = l1_ratio or 0.0
    if positive or l1 > 0.0:
        if alpha <= 0.0:
            raise AssertionError(
                "lasso / elastic_net / nnls require alpha > 0 "
                "(use ols/ridge for an unpenalized fit)"
            )
        m = solve_method or "cd"
        if m not in ("cd", "cd_active_set"):
            raise ValueError(f"solve_method {m!r} cannot fit an L1 / positive model")
        return m
    if alpha > 0.0:  # ridge
        return solve_method or "chol"
    if solve_method is None:
        return "chol" if n_rows > n_features else "svd"
    return solve_method
