"""Least-squares evaluation engine: the static fits, their statistics and
the moving models.

A static fit runs as: the cached ``[N, 1+K]`` column stack (values and
validity, target first; scaled by sqrt(w) for WLS) -> the null policy
(ops/masking.py) and one row gather into a batched layout (cached per
layout, columns and policy) -> the solve -> predictions in that layout ->
row order, deferred (``BlockPermuted``) or materialized.

- ``chol`` / ``lu`` / ``qr``: the split-padded blocks ``Zp [S, R, 1+K]``,
  per-group moments from the hand-written CUDA kernel (ops/moments.py),
  then a batched Cholesky with eigh fallback and conditioning-gated CSNE
  refinement (``qr``: always refined; ``lu``: partial-pivot LU, never
  refined).
- ``cd`` / ``cd_active_set`` (lasso, elastic net, NNLS): the same moments,
  then covariance-form coordinate descent (ops/cd.py, a CUDA kernel on the
  card).
- ``svd``: the fully padded ``[G, R, K]`` layout, Householder reduction
  and one batched SVD of the K x K factors (minimum norm, numpy lstsq's
  cutoff), for any number of groups.
- ``mode="statistics"``: the split-padded blocks and their moments for
  every solver; the dispatch solver's coefficients with their residual
  metrics, and se / t / p from the normal equations (ops/statistics.py).

The moving models (``rls`` / ``expanding_ols`` / ``rolling_ols``) run on
the fully padded ``[G, R, 1+K]`` layout under the moving null-policy
semantics (zero-filled values, validity carried apart; one group is the
column stack itself, no gather): ops/moving.py gives every row its
coefficients, or their predictions, from one scan-and-solve kernel family
on the card; rolling warm-up NaNs become nulls; the output goes back to row
order like the static fits'.

What is not ported (multi-target, predict, formulas, K > 32, fused select)
raises ``NotImplementedError`` naming its ROADMAP queue item; nothing falls
back silently.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import CONFIG, EPSILON, F64, device
from ..ops.cd import solve_elastic_net_cov
from ..ops.direct import grouped_moments, resolve_solve_method
from ..ops.linalg import MAX_K, psd_solver, solve_lu, solve_psd, solve_psd_cond, svd_lstsq
from ..ops.masking import prepare_problem, zero_filled
from ..ops.moving import recursive_least_squares, rolling_ols
from ..ops.rolling import default_min_periods, rolling_indices
from ..ops.statistics import feature_metrics, residual_metrics
from ..series import BlockPermuted, Series, StatisticsSeries, StructSeries
from .groups import bucket_size, single_layout

# cond(XtX) beyond which one f64 Cholesky solve of the squared system loses
# lstsq-grade accuracy; flagged batches take the CSNE refinement branch
_COND_REFINE = 1.0e6

# policies whose predictions cover every row, formed from the zero-filled
# features rather than from the fit's (masked) rows
_ROW_PREDICT_POLICIES = ("drop_zero", "drop_y_zero_x")

_STACK_CACHE_LIMIT = 8


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to polars_ols_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {item})"
    )


# --------------------------------------------------------------------------- #
# column stacks and layout caches
# --------------------------------------------------------------------------- #
def _split_layout(layout):
    # same bucketed block width as the JAX engine, so both engines build
    # identical blocks for identical data
    r_cap = min(
        CONFIG.moment_chunk_rows, bucket_size(max(8, int(layout.counts.max())))
    )
    return layout.device_split(r_cap)


def _cache_of(owner) -> dict:
    if owner._layout_cache is None:
        owner._layout_cache = {}
    return owner._layout_cache


def _put(cache: dict, key, value) -> None:
    if len(cache) >= _STACK_CACHE_LIMIT:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _lru(store: dict, kind: str, key, build):
    """``store[key]``, built on a miss, in an LRU of 2 entries of ``kind``
    (the layout's device caches: steady-state queries reuse them)."""
    if key not in store:
        value = build()
        keys = [k for k in store if isinstance(k, tuple) and k[0] == kind]
        if len(keys) >= 2:
            del store[keys[0]]
        store[key] = value
    store[key] = store.pop(key)  # most recently used
    return store[key]


def _stack_cached(target, feat_series):
    """([N, 1+K] f64 values, [N, 1+K] bool validity or None when every
    column is fully valid), target first, memoized on the target Series:
    repeated queries re-evaluate to the same Series objects."""
    key = ("stack",) + tuple(id(s) for s in feat_series)
    cache = _cache_of(target)
    if key in cache:
        return cache[key][0]
    cols = [target] + list(feat_series)
    vals = torch.stack(
        [torch.as_tensor(s.values, dtype=F64, device=device()) for s in cols], dim=1
    )
    valid = None
    if any(s.validity is not None for s in cols):
        valid = torch.stack([s.valid_mask() for s in cols], dim=1)
    _put(cache, key, ((vals, valid), tuple(feat_series)))  # hold refs: keys use id()s
    return vals, valid


def _weight_vectors(w_vals: torch.Tensor, w_valid: torch.Tensor):
    """sqrt(w) and 1/sqrt(w); null weights become EPSILON (reference
    least_squares.py:190-196)."""
    sq = torch.where(w_valid, torch.sqrt(w_vals), EPSILON)
    return sq, 1.0 / sq


def _weighted_stack_cached(target, feat_series, weights):
    """(values * sqrt(w), validity, 1/sqrt(w)): WLS as one scaling of the
    whole [N, 1+K] stack, intercept column included (the reference scales
    each column expression-side), memoized beside the unweighted stack."""
    vals, valid = _stack_cached(target, feat_series)
    key = ("wstack", id(vals), id(weights))
    cache = _cache_of(target)
    if key in cache:
        return cache[key][0]
    sq, inv = _weight_vectors(
        torch.as_tensor(weights.values, dtype=F64, device=device()), weights.valid_mask()
    )
    out = (vals * sq[:, None], valid, inv)
    _put(cache, key, (out, (vals, weights)))  # hold refs: the key uses id()s
    return out


def _const_series(target, n: int) -> Series:
    """Engine-side intercept column: a cached all-ones Series."""
    cache = _cache_of(target)
    key = ("const", n)
    if key not in cache:
        _put(cache, key, Series("const", torch.ones(n, dtype=F64, device=device())))
    return cache[key]


def _problem(vals, valid, policy: str, moving: bool = False):
    """(y [N], X [N, K], fit_mask [N] or None, predict_valid [N] or None)
    of a stack under a null policy (``moving``: a moving model's
    semantics); fully valid stacks pass through."""
    if valid is None:
        return vals[:, 0], vals[:, 1:], None, None
    p = prepare_problem(
        policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:], moving=moving
    )
    return p.y, p.X, p.fit_mask, p.predict_valid


def _gather_layout(vals, valid, policy: str, gather, pmask, moving: bool = False):
    """Policy pass, then one row gather of ``[y | X]`` (and of the bool
    fit mask) into a padded layout ``pmask.shape``: (Zp [B, R, 1+K] target
    in slot 0, wp [B, R] fit mask, predict_valid [N] or None). Padding
    slots gather row 0 and are masked out."""
    y, X, fit_mask, predict_valid = _problem(vals, valid, policy, moving)
    B, R = pmask.shape
    Z = vals if fit_mask is None else torch.cat([y[:, None], X], dim=1)
    Zp = Z.index_select(0, gather).reshape(B, R, Z.shape[1])
    wp = pmask if fit_mask is None else pmask & fit_mask.index_select(0, gather).reshape(B, R)
    return Zp, wp, predict_valid


def _cache_key(kind: str, vals, valid, policy: str, R: int):
    # the policy matters only with nulls: fully valid stacks share one entry
    return (kind, id(vals), id(valid), policy if valid is not None else None, R)


def _blocks_cached(layout, vals, valid, policy: str):
    """The split-padded partition (Zp [S, R, 1+K], wp [S, R],
    predict_valid) of the moment path, cached per (columns, layout,
    policy). The entry holds vals and valid: the key uses their ids."""
    g, pmask, _, _ = _split_layout(layout)
    key = _cache_key("blocks", vals, valid, policy, pmask.shape[1])
    entry = _lru(
        layout._dev, "blocks", key,
        lambda: _gather_layout(vals, valid, policy, g, pmask) + (vals, valid),
    )
    return entry[:3]


def _padded_cached(layout, vals, valid, policy: str):
    """The fully padded layout (Zp [G, R, 1+K], wp [G, R], predict_valid)
    of the SVD path, cached like ``_blocks_cached``."""
    gather, pmask, R = layout.device_padded()
    key = _cache_key("padded", vals, valid, policy, R)
    entry = _lru(
        layout._dev, "padded", key,
        lambda: _gather_layout(vals, valid, policy, gather, pmask) + (vals, valid),
    )
    return entry[:3]


def _moving_layout(layout, vals, valid, policy: str):
    """The moving models' layout: one group is the column stack itself
    (no gather), several are the fully padded gather."""
    if layout.num_groups > 1:
        gather, pmask, _ = layout.device_padded()
        return _gather_layout(vals, valid, policy, gather, pmask, moving=True)
    y, X, fit_mask, predict_valid = _problem(vals, valid, policy, moving=True)
    Z = vals if fit_mask is None else torch.cat([y[:, None], X], dim=1)
    if fit_mask is None:
        fit_mask = torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
    return Z[None].contiguous(), fit_mask[None].contiguous(), predict_valid


def _moving_cached(layout, vals, valid, policy: str):
    """(Zp [G, R, 1+K], vp [G, R], predict_valid) of a moving model,
    cached like ``_blocks_cached``."""
    key = _cache_key("moving", vals, valid, policy, 0)
    entry = _lru(
        layout._dev, "moving", key,
        lambda: _moving_layout(layout, vals, valid, policy) + (vals, valid),
    )
    return entry[:3]


def _rolling_indices_cached(layout, vp, window: int, min_periods: int, positional: bool):
    """``rolling_indices`` of a cached layout's valid rows, cached beside
    it (the entry holds ``vp``: the key uses its id)."""
    key = ("rolling_indices", id(vp), window, min_periods, positional)
    entry = _lru(
        layout._dev, "rolling_indices", key,
        lambda: rolling_indices(vp, window, min_periods, positional) + (vp,),
    )
    return entry[:2]


# --------------------------------------------------------------------------- #
# solves
# --------------------------------------------------------------------------- #
def _block_preds(Xp, beta_blocks):
    """Block predictions [B, R] as K multiply-adds of [B, R] planes."""
    K = Xp.shape[-1]
    acc = Xp[..., 0] * beta_blocks[:, None, 0]
    for k in range(1, K):
        acc = acc + Xp[..., k] * beta_blocks[:, None, k]
    return acc


def _csne_refine_blocks(A, beta, Xp, yp, wp, block_group, block_offsets, alpha):
    """Corrected semi-normal-equations refinement (Björck's CSNE). The
    normal-equation solve squares cond(X); four sweeps of ``r = y - X b``
    (from the rows, in f64) and ``b += A^{-1}(X'r - alpha b)`` restore
    QR-grade forward error for cond(X) up to ~1e7 and recover lanes whose
    Cholesky failed into the eigh fallback. X'r is summed per group over
    the group's contiguous blocks in block order (deterministic). Rows
    outside ``wp`` are selected away, not multiplied by zero, so a NaN in
    a padding slot never reaches a group."""
    solve = psd_solver(A)  # factor A once; the sweeps reuse it
    for _ in range(4):
        bb = beta.index_select(0, block_group)
        resid = torch.where(wp, yp - _block_preds(Xp, bb), 0.0)
        Xr = torch.where(wp[..., None], Xp * resid[..., None], 0.0)
        Xtr = torch.segment_reduce(Xr.sum(dim=1), "sum", offsets=block_offsets, axis=0)
        beta = beta + solve(Xtr - alpha * beta)
    return beta


def _cd_params(kwargs, method: str) -> dict:
    """Coordinate-descent settings with the JAX engine's defaults
    (l1_ratio 0.5, max_iter 1000, tol 1e-5; polars_ols_tpu/engine/fit.py
    :1153-1159): ``ols(alpha=a, solve_method="cd")`` is an elastic net at
    ratio 0.5."""
    return dict(
        l1_ratio=float(0.5 if kwargs.l1_ratio is None else kwargs.l1_ratio),
        max_iter=int(kwargs.max_iter or 1000),
        tol=float(kwargs.tol if kwargs.tol is not None else 1e-5),
        positive=bool(kwargs.positive),
        active_set=method == "cd_active_set",
    )


def _solve_cd(XtX, Xty, counts, alpha: float, cd: dict):
    """Covariance-form coordinate descent (ops/cd.py) on contiguous copies
    of the moment slices; the coefficients [G, K]."""
    w, _ = solve_elastic_net_cov(XtX.contiguous(), Xty.contiguous(), counts, alpha, **cd)
    return w


def _solve_dispatch(XtX, Xty, alpha: float, method: str, refine):
    """The per-group solve of the moment path (``refine`` = (Xp, yp, wp,
    block_group, block_offsets), the rows of the CSNE sweeps):

    - 'chol': Cholesky, CSNE sweeps when cond(XtX) > 1e6;
    - 'qr': Cholesky with unconditional CSNE sweeps (QR-grade forward
      error for cond(X) up to ~1e7; reference col-piv QR,
      src/least_squares.rs:193-205);
    - 'lu': partial-pivot LU, no sweeps (src/least_squares.rs:264-273).

    Host syncs: the Cholesky or LU fallback (``ok.all()``) and the
    refinement choice for 'chol'."""
    K = XtX.shape[-1]
    A = XtX + alpha * torch.eye(K, dtype=F64, device=XtX.device)
    if method == "lu":
        return solve_lu(A, Xty)
    if method == "qr":
        return _csne_refine_blocks(A, solve_psd(A, Xty), *refine, alpha)
    beta, cond_est = solve_psd_cond(A, Xty)
    if float(cond_est.max()) > _COND_REFINE:
        beta = _csne_refine_blocks(A, beta, *refine, alpha)
    return beta


def _moment_blocks(layout, vals, valid, policy: str):
    """The cached split-padded blocks and their per-group moments:
    (Zp, wp, predict_valid, block_group, block_offsets, XtX, Xty, counts)."""
    _, pmask, block_group, _ = _split_layout(layout)
    Zp, wp, predict_valid = _blocks_cached(layout, vals, valid, policy)
    offsets = layout.device_block_offsets(pmask.shape[1])
    XtX, Xty, counts = grouped_moments(Zp, wp, offsets, layout.num_groups)
    return Zp, wp, predict_valid, block_group, offsets, XtX, Xty, counts


def _fit_moments(layout, vals, valid, policy: str, alpha: float, method: str, cd=None):
    """Per-group beta [G, K] on the split-padded blocks (coordinate descent
    with the settings ``cd``, else ``_solve_dispatch``); returns (beta,
    Xp, block_group, unpad, predict_valid): the blocks' features, their
    group ids and the row-order gather [N] out of the flat block layout
    (None for one group, whose layout is row-sequential)."""
    Zp, wp, predict_valid, block_group, offsets, XtX, Xty, counts = _moment_blocks(
        layout, vals, valid, policy
    )
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    if cd is not None:
        beta = _solve_cd(XtX, Xty, counts, alpha, cd)
    else:
        beta = _solve_dispatch(XtX, Xty, alpha, method, (Xp, yp, wp, block_group, offsets))
    r_cap = Zp.shape[1]
    unpad = layout.device_split_unpad(r_cap) if layout.num_groups > 1 else None
    return beta, Xp, block_group, unpad, predict_valid


def _fit_svd(layout, vals, valid, policy: str, alpha: float, rcond):
    """Per-group minimum-norm beta [G, K] on the fully padded layout
    (``svd_lstsq``: Householder reduction, one batched SVD of the K x K
    factors). Returns what ``_fit_moments`` returns (block i is group i)."""
    Zp, wp, predict_valid = _padded_cached(layout, vals, valid, policy)
    G, R = wp.shape
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    n_valid = wp.sum(dim=1, dtype=F64)
    Xm = torch.where(wp[..., None], Xp, 0.0)
    ym = torch.where(wp, yp, 0.0)
    beta = svd_lstsq(Xm, ym, alpha, rcond, n_valid)
    return beta, Xp, None, layout.device_unpad(R) if G > 1 else None, predict_valid


def _coef_struct(beta: torch.Tensor, names: List[str]) -> StructSeries:
    """Coefficient matrix -> struct column; NaN entries become nulls."""
    return StructSeries("coefficients", names, beta, torch.isfinite(beta))


def _statistics(layout, vals, valid, policy: str, kwargs, method: str, cd, names, layout_in):
    """mode='statistics' (the JAX engine's ``_blocks_statistics_kernel``
    and, for 'svd', its ``_statistics``): moments, residuals and metrics on
    the split-padded blocks. The coefficients field holds the dispatch
    solver's estimate: the plain Cholesky solve (with its eigh fallback,
    no CSNE, no LU) for chol / lu / qr, coordinate descent for cd, the
    minimum-norm SVD for svd; r2 / mae / mse are those coefficients'.
    se / t / p always come from the normal equations with the raw alpha
    and the per-row RSS of their own solution; df = n - tr(A^-1) whenever
    alpha > 0 (lasso and elastic net included)."""
    alpha = float(kwargs.alpha or 0.0)
    Zp, wp, _, block_group, offsets, XtX, Xty, counts = _moment_blocks(
        layout, vals, valid, policy
    )
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    blocks = (block_group, offsets)

    def metrics(beta):
        preds = _block_preds(Xp, beta.index_select(0, block_group))
        return residual_metrics(yp, preds, wp, blocks)

    A = XtX + alpha * torch.eye(XtX.shape[-1], dtype=F64, device=XtX.device)
    beta_ne = solve_psd(A, Xty)
    if cd is not None:
        beta = _solve_cd(XtX, Xty, counts, alpha, cd)
    elif method == "svd":
        beta = _fit_svd(layout, vals, valid, policy, alpha, kwargs.rcond)[0]
    else:
        beta = beta_ne
    rm = metrics(beta)
    rss_ne = rm["rss"] if beta is beta_ne else metrics(beta_ne)["rss"]
    fm = feature_metrics(XtX, Xty, rss_ne, counts, alpha)
    out = StatisticsSeries("statistics", names, {
        "coefficients": beta,
        "mse": rm["mse"],
        "mae": rm["mae"],
        "r2": rm["r2"],
        "standard_errors": fm["standard_errors"],
        "t_values": fm["t_values"],
        "p_values": fm["p_values"],
    })
    return out if layout_in is None else out.gather(layout.device_gids())


def _resolve_method(layout, kwargs, k: int) -> str:
    return resolve_solve_method(
        kwargs.solve_method,
        kwargs.alpha or 0.0,
        kwargs.l1_ratio,
        bool(kwargs.positive),
        int(layout.counts.max()),
        k,
    )


def _evaluate_moving(function_name, target, feat_series, kwargs, mode, layout, weights):
    """``rls`` / ``rolling_ols`` per group (the JAX engine's moving branch,
    engine/fit.py:1293-1520): per-row coefficients as a struct column, or
    their predictions. ``initial_state_mean`` reaches the coefficients
    only: the reference's predictions entry point passes none
    (src/expressions.rs:624-646), and so predictions and residuals run
    with a zero prior mean."""
    n, k, G = len(target), len(feat_series), layout.num_groups
    inv_w = None
    if weights is None:
        vals, valid = _stack_cached(target, feat_series)
    else:
        vals, valid, inv_w = _weighted_stack_cached(target, feat_series, weights)
    policy = kwargs.null_policy
    Zp, vp, predict_valid = _moving_cached(layout, vals, valid, policy)
    rows = layout.device_counts()
    want = "coefficients" if mode == "coefficients" else "predictions"
    is_rls = function_name == "recursive_least_squares"
    if is_rls:
        mean0 = kwargs.initial_state_mean if mode == "coefficients" else None
        out = recursive_least_squares(
            Zp, vp, rows, kwargs.half_life, kwargs.initial_state_covariance, mean0, want=want
        )
    else:
        window, mp = int(kwargs.window_size), kwargs.min_periods
        # on a fully valid stack every row is a window member, so the
        # valid-rank window of the drop family is the positional one
        positional = policy == "drop_window" or (valid is None and (mp is None or mp <= window))
        indices = None
        if Zp.is_cuda:
            indices = _rolling_indices_cached(
                layout, vp, window, default_min_periods(mp, k, window), positional
            )
        out = rolling_ols(
            Zp, vp, rows, window, mp, float(kwargs.alpha or 0.0), positional,
            want=want, indices=indices,
        )
    R = Zp.shape[1]
    unpad = layout.device_unpad(R) if G > 1 else None
    if mode == "coefficients":
        flat = out.reshape(G * R, k)
        rows_out = flat if unpad is None else flat.index_select(0, unpad)
        return _coef_struct(rows_out, [s.name for s in feat_series])
    flat = out.reshape(-1)
    if not is_rls:
        # warm-up NaN predictions become nulls (the reference's fill_nan
        # post-step, least_squares.py:407)
        finite = ~torch.isnan(flat)
        finite = finite if unpad is None else finite.index_select(0, unpad)
        predict_valid = finite if predict_valid is None else predict_valid & finite
    if CONFIG.lazy_row_order and G > 1 and inv_w is None:
        return Series(target.name, BlockPermuted(flat, unpad), predict_valid)
    preds = flat if unpad is None else flat.index_select(0, unpad)
    if inv_w is not None:
        preds = preds * inv_w
    return Series(target.name, preds, predict_valid)


# --------------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------------- #
def evaluate_least_squares(
    target: Series,
    feat_series: List[Series],
    kwargs,
    mode: str,
    layout_in,
    add_intercept: bool = False,
    weights: Series | None = None,
    function_name: str = "least_squares",
):
    """A least-squares fit of ``target`` on ``feat_series`` per group of
    ``layout_in`` (one group when None), under the kwargs' null policy,
    weighted by ``weights`` when given. ``function_name`` picks the model:
    a static fit (``least_squares``, by the kwargs' solve method) or a
    moving one (``recursive_least_squares``, ``rolling_least_squares``).
    Predictions come as a Series (unscaled for WLS), coefficients as a
    struct column, statistics (static fits only) as a ``StatisticsSeries``
    (one row per group without ``.over()``, one per row with it)."""
    n = len(target)
    if add_intercept:
        feat_series = list(feat_series) + [_const_series(target, n)]
    k = len(feat_series)
    layout = layout_in if layout_in is not None else single_layout(n)
    G = layout.num_groups
    if k > MAX_K:
        raise _not_ported(f"K={k} > {MAX_K} features", 12)
    if function_name != "least_squares":
        return _evaluate_moving(function_name, target, feat_series, kwargs, mode, layout, weights)
    method = _resolve_method(layout, kwargs, k)

    inv_w = None
    if weights is None:
        vals, valid = _stack_cached(target, feat_series)
    else:
        vals, valid, inv_w = _weighted_stack_cached(target, feat_series, weights)
    policy = kwargs.null_policy
    alpha = float(kwargs.alpha or 0.0)
    cd = _cd_params(kwargs, method) if method.startswith("cd") else None
    names = [s.name for s in feat_series]
    if mode == "statistics":
        return _statistics(layout, vals, valid, policy, kwargs, method, cd, names, layout_in)
    row_preds = valid is not None and policy in _ROW_PREDICT_POLICIES
    if method == "svd":
        beta, Xp, block_group, unpad, predict_valid = _fit_svd(
            layout, vals, valid, policy, alpha, kwargs.rcond
        )
    else:
        beta, Xp, block_group, unpad, predict_valid = _fit_moments(
            layout, vals, valid, policy, alpha, method, cd
        )

    if mode == "coefficients":
        rows = beta if layout_in is None else beta.index_select(0, layout.device_gids())
        return _coef_struct(rows, names)
    if row_preds:
        # X_predict of the drop family: the zero-filled features of every
        # row, against each row's group coefficients
        X_pred = zero_filled(vals[:, 1:], valid[:, 1:])
        rows = beta if G == 1 else beta.index_select(0, layout.device_gids())
        preds = (X_pred * rows).sum(dim=1)
    else:
        bb = beta if block_group is None else beta.index_select(0, block_group)
        flat = _block_preds(Xp, bb).reshape(-1)
        if CONFIG.lazy_row_order and G > 1 and inv_w is None:
            # block-ordered output with a deferred row-order permutation
            return Series(target.name, BlockPermuted(flat, unpad), predict_valid)
        # one group: the layout is row-sequential, so row order is a slice
        preds = flat[:n] if G == 1 else flat.index_select(0, unpad)
    if inv_w is not None:
        preds = preds * inv_w
    return Series(target.name, preds, predict_valid)
