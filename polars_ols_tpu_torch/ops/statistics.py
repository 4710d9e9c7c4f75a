"""Model-quality statistics: r2 / mae / mse, standard errors, t and p.

The JAX engine's ``ops/statistics.py`` (the reference's
src/statistics.rs): residual metrics over each group's fitted rows, and
ridge-aware feature metrics from the normal equations, ``sigma^2 = RSS /
df`` with ``df = n - trace((XtX + alpha I)^-1)`` when alpha > 0
and ``n - K`` otherwise, ``se = sqrt(sigma^2 |diag((XtX + alpha I)^-1)|)``,
``t = beta / se`` and two-sided p-values (ops/special.py, a CUDA kernel on
the card). The inverse comes from the Cholesky factor (ops/linalg.py:
``chol_factor``; the library's above K = 32, as in the JAX engine). Groups
whose ``XtX + alpha I`` has no finite Cholesky factor get NaN feature
metrics. Rows outside the fit mask are selected away, never
multiplied by zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import F64
from .linalg import chol_factor, chol_substitute
from .special import t_two_sided_p_value


def residual_metrics(
    y: torch.Tensor,  # [B, R] fit targets
    preds: torch.Tensor,  # [B, R] predictions
    w: torch.Tensor,  # [B, R] bool fit mask
    blocks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """mse, mae, r2 and rss [G] of each group's fitted rows. Row b of the
    inputs is group b, or with ``blocks = (block_group [B], block_offsets
    [G+1])`` a row block of group ``block_group[b]`` (a group's blocks are
    contiguous and summed in block order)."""

    def per_group(v):  # [B] block sums -> [G]
        if blocks is None:
            return v
        return torch.segment_reduce(v, "sum", offsets=blocks[1], axis=0)

    n_safe = torch.clamp_min(per_group(w.sum(dim=1, dtype=F64)), 1.0)
    mean = per_group(torch.where(w, y, 0.0).sum(dim=1)) / n_safe
    mean_rows = mean if blocks is None else mean.index_select(0, blocks[0])
    sst = per_group(torch.where(w, torch.square(y - mean_rows[:, None]), 0.0).sum(dim=1))
    err = torch.where(w, y - preds, 0.0)
    sse = per_group((err * err).sum(dim=1))
    sae = per_group(err.abs().sum(dim=1))
    return {"mse": sse / n_safe, "mae": sae / n_safe, "r2": 1.0 - sse / sst, "rss": sse}


def feature_metrics(
    XtX: torch.Tensor,  # [G, K, K]
    Xty: torch.Tensor,  # [G, K]
    rss: torch.Tensor,  # [G] residual sum of squares over the fitted rows
    n: torch.Tensor,  # [G] valid-row counts
    alpha: float,
) -> Dict[str, torch.Tensor]:
    """Normal-equation coefficients, standard errors, t- and p-values
    [G, K]; any ``alpha > 0`` takes the ridge degrees of freedom. RSS must
    come from per-row residuals: the moment identity cancels for good fits
    (src/statistics.rs:119-123)."""
    G, k, _ = XtX.shape
    eye = torch.eye(k, dtype=F64, device=XtX.device)
    L, ok = chol_factor(XtX + alpha * eye)
    A_inv = torch.where(ok[:, None, None], chol_substitute(L, eye.expand(G, k, k)), eye)
    beta = torch.einsum("gkl,gl->gk", A_inv, Xty)
    if alpha > 0.0:
        df = n - torch.diagonal(A_inv, dim1=-2, dim2=-1).sum(dim=-1)
    else:
        df = n - float(k)
    sigma2 = rss / df
    se = torch.sqrt(sigma2[:, None] * torch.diagonal(A_inv, dim1=-2, dim2=-1).abs())
    t = beta / se
    p = t_two_sided_p_value(t.contiguous(), df.contiguous())
    ok2 = ok[:, None]
    return {
        "coefficients": torch.where(ok2, beta, torch.nan),
        "standard_errors": torch.where(ok2, se, torch.nan),
        "t_values": torch.where(ok2, t, torch.nan),
        "p_values": torch.where(ok2, p, torch.nan),
    }
