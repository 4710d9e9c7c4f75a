"""Null policies of the static and moving fits as mask and fill transforms.

The port of the JAX engine's ``ops/masking.py`` (the semantics of the
reference's ``compute_is_valid_mask`` / ``handle_nulls``,
src/expressions.rs:201-296). Rows are never filtered out: rows excluded
from the fit are zeroed and dropped from the fit mask, which gives the
same moments and the same minimum-norm SVD objective as dropping them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

VALID_NULL_POLICIES = {"zero", "drop", "ignore", "drop_zero", "drop_y_zero_x", "drop_window"}
DROP_FAMILY = {"drop", "drop_zero", "drop_y_zero_x", "drop_window"}


@dataclass
class MaskedProblem:
    """Fit and prediction tensors of one least-squares call.

    Attributes:
        y: [N] target prepared for the fit (rows excluded from the fit are
           zeroed; 'ignore' turns nulls into NaN values).
        X: [N, K] features prepared for the fit.
        fit_mask: [N] bool, the rows that take part in the fit.
        X_predict: [N, K] features the predictions are formed from
           (zero-filled, reference src/expressions.rs:408).
        predict_valid: optional [N] bool; where given, predictions are
           null outside it (policy 'drop', and every drop-family policy
           of a moving model, src/expressions.rs:398-427, 624-701).
    """

    y: torch.Tensor
    X: torch.Tensor
    fit_mask: torch.Tensor
    X_predict: torch.Tensor
    predict_valid: Optional[torch.Tensor]


def is_valid_mask(policy: str, y_valid: torch.Tensor, x_valid: torch.Tensor) -> torch.Tensor:
    """Row validity under ``policy`` (src/expressions.rs:201-228)."""
    if policy == "drop_y_zero_x":
        return y_valid
    return y_valid & x_valid.all(dim=1)


def zero_filled(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``values`` with nulls as 0.0: the fill of policy 'zero', and the
    features the drop family predicts from (src/expressions.rs:408)."""
    return torch.where(valid, values, 0.0)


def prepare_problem(
    policy: str,
    y_values: torch.Tensor,
    y_valid: torch.Tensor,
    x_values: torch.Tensor,
    x_valid: torch.Tensor,
    moving: bool = False,
) -> MaskedProblem:
    """Apply a null policy to raw values and validity.

    Args:
        policy: one of VALID_NULL_POLICIES.
        y_values / y_valid: [N] f64 / bool; values at null slots are arbitrary.
        x_values / x_valid: [N, K] f64 / bool.
        moving: the recursive and rolling models fit on zero-filled data
            with the validity carried apart (src/expressions.rs:656,683) and
            mask their predictions under every drop-family policy.
    """
    if policy not in VALID_NULL_POLICIES:
        raise ValueError(f"invalid null policy {policy!r}")
    ones = torch.ones(x_values.shape[0], dtype=torch.bool, device=x_values.device)
    if moving:
        x_zero = zero_filled(x_values, x_valid)
        y_zero = zero_filled(y_values, y_valid)
        if policy not in DROP_FAMILY:
            return MaskedProblem(y_zero, x_zero, ones, x_zero, None)
        mask = is_valid_mask(policy, y_valid, x_valid)
        return MaskedProblem(y_zero, x_zero, mask, x_zero, mask)
    if policy == "ignore":
        y_nan = torch.where(y_valid, y_values, torch.nan)
        x_nan = torch.where(x_valid, x_values, torch.nan)
        return MaskedProblem(y_nan, x_nan, ones, x_nan, None)

    x_zero = zero_filled(x_values, x_valid)
    y_zero = zero_filled(y_values, y_valid)
    if policy == "zero":
        return MaskedProblem(y_zero, x_zero, ones, x_zero, None)

    # drop family: zero the excluded rows so they drop out of the fit
    mask = is_valid_mask(policy, y_valid, x_valid)
    y_fit = torch.where(mask, y_zero, 0.0)
    x_fit = torch.where(mask[:, None], x_zero, 0.0)
    predict_valid = mask if policy in ("drop", "drop_window") else None
    return MaskedProblem(y_fit, x_fit, mask, x_zero, predict_valid)
