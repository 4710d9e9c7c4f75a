"""Least-squares evaluation engine: the static fits, their statistics and
the moving models.

A static fit runs as: the cached ``[N, 1+K]`` column stack (values and
validity, target first; scaled by sqrt(w) for WLS) -> the null policy
(ops/masking.py) and one row gather into a batched layout (cached per
layout, columns and policy) -> the solve -> predictions in that layout ->
row order, deferred (``BlockPermuted``) or materialized. This module holds
the stack, the layouts and each stage's pieces; engine/batch.py plans a
fit and runs it through the stages, a fit alone as a run of one plan and
the fits of a select as one run.

- ``chol`` / ``lu`` / ``qr``: the split-padded blocks ``Zp [S, R, 1+K]``,
  per-group moments from the hand-written CUDA kernel (ops/moments.py),
  then a batched Cholesky with eigh fallback and conditioning-gated CSNE
  refinement (``qr``: always refined; ``lu``: partial-pivot LU, never
  refined).
- ``cd`` / ``cd_active_set`` (lasso, elastic net, NNLS): the same moments,
  then covariance-form coordinate descent (ops/cd.py, CUDA kernels on the
  card): cyclic up to K = 32 and for ``cd_active_set``, FISTA with an
  active-set polish above.
- ``svd``: the same split-padded blocks, reduced per group to the K x K
  triangular factor and ``Q^T y`` by the hand-written Householder kernel
  (ops/householder.py: each block, then a tree over a group's stacked
  block factors), then the one-sided Jacobi SVD of the factors (minimum
  norm, numpy lstsq's cutoff; ops/jacobi.py, a CUDA kernel on the card);
  groups of at most K rows take the SVD of their rows.
- ``mode="statistics"``: the split-padded blocks and their moments for
  every solver; the dispatch solver's coefficients with their residual
  metrics, and se / t / p from the normal equations (ops/statistics.py).

A multi-target fit (a struct target of M fields) stacks ``[Y | X]``
(``[N, M + K]``, cached on the struct's field Series) and runs the ``svd`` path with M target columns: one reduction and one
SVD per group serve every target; the predictions are a struct of the
target's fields. ``predict`` dots a row-aligned coefficient struct with
feature columns (``evaluate_predict``).

The moving models (``rls`` / ``expanding_ols`` / ``rolling_ols``) run on
the fully padded ``[G, R, 1+K]`` layout under the moving null-policy
semantics (zero-filled values, validity carried apart; one group is the
column stack itself, no gather): ops/moving.py gives every row its
coefficients, or their predictions, from one scan-and-solve kernel family
on the card; rolling warm-up NaNs become nulls; the output goes back to row
order like the static fits'.

Every fit runs at any K: above K = 32 the moments take the moment
kernel's wide form, the Cholesky the library's batched factorization
(ops/linalg.py: ``chol_factor``), the reduction and the SVD the
Householder and Jacobi kernels' wide forms, coordinate descent the wide
kernels of ops/cd.py. Nothing falls back silently.

With ``CONFIG.auto_shard`` on and a mesh of more than one shard
(parallel/sharded.py), grouped fits run sharded (``_evaluate_sharded``):
the static fits of several groups through ``fit_moments_sharded`` or
``statistics_moments_sharded`` (every null policy, WLS, CD, ``lu``,
``qr``), and where there are at least as many groups as shards the
whole-group solves (``svd``, multi-target, the moving models) through
``solve_groups_sharded``. Otherwise, with a log line, a fit stays on one
device; with ``auto_shard`` off nothing here changes.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import List

import numpy as np

import torch

from ..config import CONFIG, EPSILON, F64, device
from ..ops.cd import solve_elastic_net_cov
from ..ops.direct import resolve_solve_method
from ..ops.householder import plan_reduction, reduce_groups
from ..ops.linalg import svd_lstsq, svd_lstsq_from_factor
from ..ops.masking import prepare_problem, zero_filled
from ..ops.moving import recursive_least_squares, rolling_ols
from ..ops.rolling import default_min_periods, rolling_indices
from ..ops.statistics import feature_metrics, residual_metrics
from ..series import BlockPermuted, Series, StatisticsSeries, StructSeries
from .groups import bucket_size, register_cache_owner, single_layout

logger = logging.getLogger(__name__)

# cond(XtX) beyond which one f64 Cholesky solve of the squared system loses
# lstsq-grade accuracy; flagged batches take the CSNE refinement branch
_COND_REFINE = 1.0e6

# policies whose predictions cover every row, formed from the zero-filled
# features rather than from the fit's (masked) rows
_ROW_PREDICT_POLICIES = ("drop_zero", "drop_y_zero_x")

_STACK_CACHE_LIMIT = 8

# row gathers into a batched layout since the last reset (_gather_layout):
# what a layout-cache miss costs, counted for the smoke's thrash check
layout_gathers = 0

# the layout-cache keys that a fused select in progress has touched
# (engine/batch.py): ``_lru`` evicts none of them, so a select over more
# stacks than the LRU keeps does not evict its own entries and rebuild
# them on its next call; None outside such a select
_HELD = None


@contextmanager
def held_caches():
    """Within the block, the layout-cache entries touched stay cached
    (``_lru`` evicts older ones only) until the block ends."""
    global _HELD
    outer, _HELD = _HELD, set() if _HELD is None else _HELD
    try:
        yield
    finally:
        _HELD = outer


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
        register_cache_owner(owner)
    return owner._layout_cache


def _put(cache: dict, key, value) -> None:
    if len(cache) >= _STACK_CACHE_LIMIT:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _lru(store: dict, kind: str, key, build):
    """``store[key]``, built on a miss, in an LRU of 2 entries of ``kind``
    (the layout's device caches: steady-state queries reuse them). Entries
    held by a fused select in progress (``held_caches``) are not evicted:
    the kind then keeps more than 2 until a later miss outside it."""
    if key not in store:
        value = build()
        keys = [k for k in store if isinstance(k, tuple) and k[0] == kind]
        victims = [k for k in keys if _HELD is None or k not in _HELD]
        for k in victims[: max(0, len(keys) - 1)]:
            del store[k]
        store[key] = value
    if _HELD is not None:
        _HELD.add(key)
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


def _stack(target, feat_series, weights):
    """(vals, valid, 1/sqrt(w) or None): the cached column stack of
    ``target`` and ``feat_series``, scaled by sqrt(w) where weighted."""
    if weights is None:
        return _stack_cached(target, feat_series) + (None,)
    return _weighted_stack_cached(target, feat_series, weights)


def _const_series(layout, n: int) -> Series:
    """Engine-side intercept column: an all-ones Series of the layout's n
    rows, cached on the layout (the stacks key on its id)."""
    if "const" not in layout._dev:
        layout._dev["const"] = Series("const", torch.ones(n, dtype=F64, device=device()))
    return layout._dev["const"]


def _problem(vals, valid, policy: str, moving: bool = False, m: int = 1):
    """(y [N] or, for m > 1 targets, [N, m], X [N, K], fit_mask [N] or
    None, predict_valid [N] or None) of a stack (targets in its first m
    columns) under a null policy (``moving``: a moving model's semantics);
    fully valid stacks pass through."""
    ys = slice(0, m) if m > 1 else 0
    if valid is None:
        return vals[:, ys], vals[:, m:], None, None
    p = prepare_problem(
        policy, vals[:, ys], valid[:, ys], vals[:, m:], valid[:, m:], moving=moving
    )
    return p.y, p.X, p.fit_mask, p.predict_valid


def _gather_layout(vals, valid, policy: str, gather, pmask, moving: bool = False, m: int = 1):
    """Policy pass, then one row gather of ``[y | X]`` (and of the bool
    fit mask) into a padded layout ``pmask.shape``: (Zp [B, R, m+K]
    targets in the first m slots, wp [B, R] fit mask, predict_valid [N] or
    None). Padding slots gather row 0 and are masked out."""
    global layout_gathers
    layout_gathers += 1
    y, X, fit_mask, predict_valid = _problem(vals, valid, policy, moving, m)
    B, R = pmask.shape
    Z = vals if fit_mask is None else torch.cat([y.reshape(len(X), -1), X], dim=1)
    Zp = Z.index_select(0, gather).reshape(B, R, Z.shape[1])
    wp = pmask if fit_mask is None else pmask & fit_mask.index_select(0, gather).reshape(B, R)
    return Zp, wp, predict_valid


def _cache_key(kind: str, vals, valid, policy: str, R: int, m: int = 1):
    # the policy matters only with nulls: fully valid stacks share one entry
    return (kind, id(vals), id(valid), policy if valid is not None else None, R, m)


def _blocks_cached(layout, vals, valid, policy: str, m: int = 1):
    """The split-padded partition (Zp [S, R, m+K], wp [S, R],
    predict_valid) of the moment and SVD paths, cached per (columns,
    layout, policy). The entry holds vals and valid: the key uses their
    ids."""
    g, pmask, _, _ = _split_layout(layout)
    key = _cache_key("blocks", vals, valid, policy, pmask.shape[1], m)
    entry = _lru(
        layout._dev, "blocks", key,
        lambda: _gather_layout(vals, valid, policy, g, pmask, m=m) + (vals, valid),
    )
    return entry[:3]


def _reduction_plan(layout, r_cap: int, k: int):
    """The Householder tree of the layout's split blocks (ops/householder.py:
    plan_reduction), planned on the host from its counts and cached on it."""
    key = ("reduction", r_cap, k)
    if key not in layout._dev:
        layout._dev[key] = plan_reduction(layout._blocks_per_group(r_cap), k, device(), rows=r_cap)
    return layout._dev[key]


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
    """Block predictions [B, R] as K multiply-adds of [B, R] planes, or
    [P, B, R] of P coefficient sets ``beta_blocks`` [P, B, K] in one pass
    over ``Xp`` [B, R, K] (each element the same operations in the same
    order either way)."""
    K = Xp.shape[-1]
    acc = Xp[..., 0] * beta_blocks[..., None, 0]
    for k in range(1, K):
        acc = acc + Xp[..., k] * beta_blocks[..., None, k]
    return acc


def _csne_refine_blocks(A, beta, Xp, yp, wp, block_group, block_offsets, alpha, solve):
    """Corrected semi-normal-equations refinement (Björck's CSNE). The
    normal-equation solve squares cond(X); four sweeps of ``r = y - X b``
    (from the rows, in f64) and ``b += A^{-1}(X'r - alpha b)`` restore
    QR-grade forward error for cond(X) up to ~1e7 and recover lanes whose
    Cholesky failed into the eigh fallback. X'r is summed per group over
    the group's contiguous blocks in block order (deterministic). Rows
    outside ``wp`` are selected away, not multiplied by zero, so a NaN in
    a padding slot never reaches a group. ``solve``: A's factored solve
    (ops/linalg.py: ``psd_solver_from``), which the sweeps reuse."""
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


def _fit_svd(layout, vals, valid, policy: str, alpha: float, rcond, m: int = 1):
    """Per-group minimum-norm beta [G, K, m] of the m targets on the
    split-padded blocks: each group's rows reduced by the Householder
    kernel to its K x K factor and ``Q^T Y`` (the blocks, then the tree
    over a group's block factors), then the Jacobi SVD kernel on the
    factors (``svd_lstsq_from_factor``, one launch; the factors and ``Q^T
    Y`` go to it as strided views of the tree's last level, not copies).
    Where no group has more than K rows (each is one block), the SVD of
    the rows themselves (``svd_lstsq``). Returns (beta [G, K, m], Xp,
    block_group, unpad, predict_valid): the blocks' features, their group
    ids and the row-order gather [N] out of the flat block layout (None
    for one group, whose layout is row-sequential)."""
    block_group = _split_layout(layout)[2]
    Zp, wp, predict_valid = _blocks_cached(layout, vals, valid, policy, m)
    G, R = layout.num_groups, Zp.shape[1]
    beta = _svd_solve(layout, Zp, wp, _svd_reduce(layout, Zp, wp, m), alpha, rcond, m)
    unpad = layout.device_split_unpad(R) if G > 1 else None
    return beta, Zp[..., m:], block_group, unpad, predict_valid


def _svd_reduce(layout, Zp, wp, m: int = 1):
    """The Householder tree's last level T [G, K, m + K] of the blocks (m
    target columns), or None where no group has more than K rows."""
    k = Zp.shape[2] - m
    if int(layout.counts.max()) > k:
        return reduce_groups(Zp, wp, k, _reduction_plan(layout, Zp.shape[1], k))
    return None


def _svd_solve(layout, Zp, wp, T, alpha: float, rcond, m: int = 1):
    """Beta [G, K, m] of ``_fit_svd`` from the reduction ``T`` (None: the
    SVD of each group's rows)."""
    G, (S, R, C) = layout.num_groups, Zp.shape
    k = C - m
    n_valid = wp.sum(dim=1, dtype=F64)
    if S > G:
        n_valid = torch.segment_reduce(n_valid, "sum", offsets=layout.device_block_offsets(R), axis=0)
    if T is not None:
        return svd_lstsq_from_factor(T[..., m:], T[..., :m], n_valid, alpha, rcond)
    # a group's rows sit at the top of its one block
    Zm = torch.where(wp[:, :k, None], Zp[:, :k], 0.0)
    return svd_lstsq(Zm[..., m:], Zm[..., :m], alpha, rcond, n_valid)


def _coef_struct(beta: torch.Tensor, names: List[str]) -> StructSeries:
    """Coefficient matrix -> struct column; NaN entries become nulls."""
    return StructSeries("coefficients", names, beta, torch.isfinite(beta))


def _statistics_series(moments, alpha: float, beta, beta_ne, names, layout, layout_in):
    """mode='statistics' (the JAX engine's ``_blocks_statistics_kernel``
    and, for 'svd', its ``_statistics``): residual metrics and se / t / p
    from the split-padded blocks and their per-group moments ``moments``
    (Zp, wp, predict_valid, block_group, block_offsets, XtX, Xty, counts).
    The coefficients field holds the dispatch solver's estimate ``beta``:
    the plain Cholesky solve (with its eigh fallback, no CSNE, no LU) for
    chol / lu / qr, coordinate descent for cd, the minimum-norm SVD for
    svd; r2 / mae / mse are those coefficients'. se / t / p always come
    from the normal equations' ``beta_ne`` with the raw alpha and the
    per-row RSS of that solution (the same tensor as ``beta`` where they
    agree); df = n - tr(A^-1) whenever alpha > 0 (lasso and elastic net
    included)."""
    Zp, wp, _, block_group, offsets, XtX, Xty, counts = moments
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    blocks = (block_group, offsets)

    def metrics(beta):
        preds = _block_preds(Xp, beta.index_select(0, block_group))
        return residual_metrics(yp, preds, wp, blocks)

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


def _moving_start(function_name, target, feat_series, kwargs, mode, layout, weights):
    """``rls`` / ``rolling_ols`` per group (the JAX engine's moving branch,
    engine/fit.py:1293-1520) up to its kernels: (the moving call's
    ``Deferred`` (ops/moving.py), whose flag count the caller reads, and
    ``finish(out)`` -> per-row coefficients as a struct column, or their
    predictions). ``initial_state_mean`` reaches the coefficients only:
    the reference's predictions entry point passes none
    (src/expressions.rs:624-646), and so predictions and residuals run
    with a zero prior mean."""
    k, G = len(feat_series), layout.num_groups
    vals, valid, inv_w = _stack(target, feat_series, weights)
    policy = kwargs.null_policy
    Zp, vp, predict_valid = _moving_cached(layout, vals, valid, policy)
    rows = layout.device_counts()
    want = "coefficients" if mode == "coefficients" else "predictions"
    is_rls = function_name == "recursive_least_squares"
    if is_rls:
        mean0 = kwargs.initial_state_mean if mode == "coefficients" else None
        out = recursive_least_squares(
            Zp, vp, rows, kwargs.half_life, kwargs.initial_state_covariance, mean0, want=want,
            counts=layout.counts, defer=True,
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
            want=want, indices=indices, counts=layout.counts, defer=True,
        )
    R = Zp.shape[1]
    unpad = layout.device_unpad(R) if G > 1 else None

    def finish(out):
        return _moving_series(out, mode, is_rls, target.name, feat_series, G, R, k, unpad, predict_valid, inv_w)

    return out, finish


def _moving_series(out, mode, is_rls, name, feat_series, G, R, k, unpad, predict_valid, inv_w):
    """The Series of a moving call's output (``_moving_start``)."""
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
        return Series(name, BlockPermuted(flat, unpad), predict_valid)
    preds = flat if unpad is None else flat.index_select(0, unpad)
    if inv_w is not None:
        preds = preds * inv_w
    return Series(name, preds, predict_valid)


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
    multi_target: bool = False,
):
    """A least-squares fit of ``target`` on ``feat_series`` per group of
    ``layout_in`` (one group when None), under the kwargs' null policy,
    weighted by ``weights`` when given. ``function_name`` picks the model:
    a static fit (``least_squares``, by the kwargs' solve method) or a
    moving one (``recursive_least_squares``, ``rolling_least_squares``).
    Predictions come as a Series (unscaled for WLS), coefficients as a
    struct column, statistics (static fits only) as a ``StatisticsSeries``
    (one row per group without ``.over()``, one per row with it). With
    ``multi_target`` a struct target's fields share one SVD fit and the
    predictions come as a struct; a plain target takes the 'svd' fit, as
    in the JAX engine. A plain target's fit is a run of one plan of
    engine/batch.py, the pipeline a select's fits share."""
    from .batch import plan_fit, run_plans

    if isinstance(target, StructSeries):
        if not (multi_target and function_name == "least_squares" and mode == "predictions"):
            raise TypeError(
                "a struct target is fitted by multi_target_ols, in predictions or residuals mode"
            )
    mesh = shard_mesh()
    if mesh is not None and (layout_in is None or layout_in.num_groups <= 1):
        logger.info("auto_shard: a single group stays on one device")
    elif mesh is not None:
        out = _evaluate_sharded(
            mesh, target, feat_series, kwargs, mode, layout_in, add_intercept, weights, function_name
        )
        if out is not None:
            return out
    if isinstance(target, StructSeries):
        layout, feat_series = _fit_layout(len(target), feat_series, layout_in, add_intercept)
        return _evaluate_multi_target(target, feat_series, kwargs, layout, weights)
    plan = plan_fit(target, feat_series, kwargs, mode, layout_in, add_intercept, weights, function_name)
    return run_plans([plan])[0]


def _fit_layout(n: int, feat_series: List[Series], layout_in, add_intercept: bool):
    """A fit's layout (one group where ``layout_in`` is None) and its
    features, the intercept's constant column last."""
    layout = layout_in if layout_in is not None else single_layout(n)
    return layout, list(feat_series) + ([_const_series(layout, n)] if add_intercept else [])


def _row_features(vals, valid, policy: str, m: int):
    """X_predict of the drop family, ``drop_zero`` / ``drop_y_zero_x``: the
    zero-filled features [N, K] of every row (the fit's blocks hold the
    excluded rows zeroed); None where the blocks' features serve."""
    if valid is None or policy not in _ROW_PREDICT_POLICIES:
        return None
    return zero_filled(vals[:, m:], valid[:, m:])


def _predictions(beta, Xp, block_group, unpad, layout, n: int, X_row=None, lazy: bool = False):
    """Predictions [N] of the coefficients beta [G, K] in row order: from
    the row features ``X_row`` [N, K] where given (against each row's
    group coefficients), else from the blocks ``Xp`` [S, R, K] and brought
    to row order by ``unpad``, or deferred (``BlockPermuted``) with
    ``lazy``. One group's layout is row-sequential: row order is a slice."""
    G = layout.num_groups
    if X_row is not None:
        rows = beta if G == 1 else beta.index_select(0, layout.device_gids())
        return (X_row * rows).sum(dim=1)
    flat = _block_preds(Xp, beta.index_select(0, block_group)).reshape(-1)
    return _row_order(flat, unpad, n, G, lazy)


def _row_order(flat, unpad, n: int, G: int, lazy: bool = False):
    """Block-ordered predictions ``flat`` [S * R] in row order [N] (a slice
    for one group), or deferred (``BlockPermuted``) with ``lazy``."""
    if G == 1:
        return flat[:n]
    return BlockPermuted(flat, unpad) if lazy else flat.index_select(0, unpad)


def _evaluate_multi_target(target: StructSeries, feat_series, kwargs, layout, weights):
    """One shared SVD fit per group of the struct's M targets (the JAX
    engine's ``_multi_target_fused``, engine/fit.py:1766-1793): the
    ``[Y | X]`` stack through the ``svd`` path with M target columns, and a
    struct of predictions named after the target's fields, null on the
    rows the policy drops (src/expressions.rs:521-591)."""
    n, m = len(target), len(target.field_names)
    # the [N, M + K] stack of the fields and the features, cached on the
    # first field: a query rebuilds its struct, but not the field Series
    fields = list(target.sources or target.fields())
    vals, valid, inv_w = _stack(fields[0], fields[1:] + list(feat_series), weights)
    policy = kwargs.null_policy
    beta, Xp, block_group, unpad, predict_valid = _fit_svd(
        layout, vals, valid, policy, float(kwargs.alpha or 0.0), kwargs.rcond, m
    )
    X_row = _row_features(vals, valid, policy, m)
    preds = torch.stack(
        [_predictions(beta[..., j], Xp, block_group, unpad, layout, n, X_row) for j in range(m)], dim=1
    )
    if inv_w is not None:
        preds = preds * inv_w[:, None]
    validity = None if predict_valid is None else predict_valid[:, None].expand(n, m).contiguous()
    return StructSeries("predictions", target.field_names, preds, validity)


# --------------------------------------------------------------------------- #
# sharded routing (CONFIG.auto_shard)
# --------------------------------------------------------------------------- #
def shard_mesh():
    """The mesh grouped fits are sharded over: ``make_mesh()`` where
    ``CONFIG.auto_shard`` is on and it has more than one shard, else None."""
    if not CONFIG.auto_shard:
        return None
    from ..parallel import make_mesh

    mesh = make_mesh()
    return mesh if mesh.size > 1 else None


def _evaluate_sharded(mesh, target, feat_series, kwargs, mode, layout_in, add_intercept, weights, function_name):
    """A grouped fit (``layout_in`` of G > 1 groups) on the mesh, or None
    where it stays on one device: a whole-group solve (``svd``,
    multi-target, a moving model) with fewer groups than shards, and
    ``svd`` statistics (their moments are one device's)."""
    n = len(target)
    layout, feats = _fit_layout(n, feat_series, layout_in, add_intercept)
    G, n_shards = layout.num_groups, mesh.size
    if isinstance(target, StructSeries) or function_name != "least_squares":
        if G < n_shards:
            logger.info("auto_shard: %d groups < %d shards; the whole-group solve stays on one device", G, n_shards)
            return None
        if isinstance(target, StructSeries):
            return _sharded_svd(mesh, target, feats, kwargs, "predictions", layout, weights)
        return _sharded_moving(mesh, function_name, target, feats, kwargs, mode, layout, weights)
    method = _resolve_method(layout, kwargs, len(feats))
    if method == "svd":
        if G < n_shards or mode == "statistics":
            logger.info("auto_shard: svd %s on %d groups stays on one device", mode, G)
            return None
        return _sharded_svd(mesh, target, feats, kwargs, mode, layout, weights)
    return _sharded_static(mesh, target, feats, kwargs, mode, layout, method, weights)


def _sharded_static(mesh, target, feats, kwargs, mode, layout, method, weights):
    """A static fit of several groups through ``fit_moments_sharded`` /
    ``statistics_moments_sharded`` (the JAX engine's ``_sharded_static``):
    the policy's fit rows and features, the layout's host group ids."""
    from ..parallel import fit_moments_sharded, statistics_moments_sharded

    vals, valid, inv_w = _stack(target, feats, weights)
    n, G = vals.shape[0], layout.num_groups
    if valid is None:
        X_fit, y_fit, X_pred, predict_valid = vals[:, 1:], vals[:, 0], None, None
        wmask = torch.ones(n, dtype=torch.bool, device=vals.device)
    else:
        p = prepare_problem(kwargs.null_policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:])
        X_fit, y_fit, wmask, X_pred, predict_valid = p.X, p.y, p.fit_mask, p.X_predict, p.predict_valid
    alpha = float(kwargs.alpha or 0.0)
    cd = _cd_params(kwargs, method) if method.startswith("cd") else None
    cd_params = None if cd is None else (
        cd["l1_ratio"], cd["max_iter"], cd["tol"], cd["positive"], cd["active_set"]
    )
    names = [s.name for s in feats]
    if mode == "statistics":
        out = statistics_moments_sharded(
            mesh, X_fit, y_fit, wmask, layout.gids, G, alpha=alpha, cd_params=cd_params
        )
        return StatisticsSeries("statistics", names, out).gather(layout.device_gids())
    beta, preds = fit_moments_sharded(
        mesh, X_fit, y_fit, wmask, layout.gids, G, alpha=alpha, cd_params=cd_params, X_pred=X_pred,
        force_refine=method == "qr", lu=method == "lu",
    )
    if mode == "coefficients":
        return _coef_struct(beta.index_select(0, layout.device_gids()), names)
    if inv_w is not None:
        preds = preds * inv_w
    return Series(target.name, preds, predict_valid)


def _rows_svd(Zp, wp, alpha: float, rcond, m: int, reduce: bool):
    """Minimum-norm beta [g, K, m] of whole padded groups ``Zp [g, R, m +
    K]`` under ``wp``: each group one block of the Householder kernel, then
    the Jacobi SVD kernel on the factors (``reduce``), or the SVD of the
    rows where no group has more than K rows (``_fit_svd``'s two routes)."""
    g, R, C = Zp.shape
    k = C - m
    n_valid = wp.sum(dim=1, dtype=F64)
    if reduce:
        plan = plan_reduction(np.ones(g, dtype=np.int64), k, Zp.device, rows=R)
        T = reduce_groups(Zp.contiguous(), wp.contiguous(), k, plan)
        return svd_lstsq_from_factor(T[..., m:], T[..., :m], n_valid, alpha, rcond)
    Zm = torch.where(wp[:, :k, None], Zp[:, :k], 0.0)
    return svd_lstsq(Zm[..., m:], Zm[..., :m], alpha, rcond, n_valid)


def _sharded_svd(mesh, target, feats, kwargs, mode, layout, weights):
    """An ``svd`` fit, or a multi-target one (a struct target), with its
    groups sharded: the fully padded ``[G, R, m + K]`` layout (cached like
    the moving models'), ``_rows_svd`` on each shard's groups
    (``solve_groups_sharded``), the predictions from the layout's rows."""
    from ..parallel import solve_groups_sharded

    multi = isinstance(target, StructSeries)
    if multi:
        fields = list(target.sources or target.fields())
        m = len(fields)
        vals, valid, inv_w = _stack(fields[0], fields[1:] + list(feats), weights)
    else:
        m = 1
        vals, valid, inv_w = _stack(target, feats, weights)
    policy = kwargs.null_policy
    gather, pmask, R = layout.device_padded()
    key = _cache_key("svd_rows", vals, valid, policy, R, m)
    Zp, wp, predict_valid = _lru(
        layout._dev, "svd_rows", key,
        lambda: _gather_layout(vals, valid, policy, gather, pmask, m=m) + (vals, valid),
    )[:3]
    k = Zp.shape[2] - m
    beta = solve_groups_sharded(
        mesh, _rows_svd, [Zp, wp], alpha=float(kwargs.alpha or 0.0), rcond=kwargs.rcond, m=m,
        reduce=int(layout.counts.max()) > k,
    )
    if mode == "coefficients":
        return _coef_struct(beta[..., 0].index_select(0, layout.device_gids()), [s.name for s in feats])
    X_row = _row_features(vals, valid, policy, m)
    unpad = layout.device_unpad(R)
    n = vals.shape[0]
    cols = []
    for j in range(m):
        if X_row is not None:
            cols.append(_predictions(beta[..., j], None, None, None, layout, n, X_row))
        else:
            cols.append(_block_preds(Zp[..., m:], beta[..., j]).reshape(-1).index_select(0, unpad))
    preds = torch.stack(cols, dim=1)
    if inv_w is not None:
        preds = preds * inv_w[:, None]
    if not multi:
        return Series(target.name, preds[:, 0], predict_valid)
    validity = None if predict_valid is None else predict_valid[:, None].expand(n, m).contiguous()
    return StructSeries("predictions", target.field_names, preds, validity)


def _moving_groups(Zp, vp, rows, counts, rls: bool, **kw):
    """A moving model on a shard's groups (``solve_groups_sharded``):
    ``counts`` is ``rows`` on the host."""
    fn = recursive_least_squares if rls else rolling_ols
    return fn(Zp.contiguous(), vp.contiguous(), rows.contiguous(), counts=np.asarray(counts), **kw)


def _sharded_moving(mesh, function_name, target, feats, kwargs, mode, layout, weights):
    """``rls`` / ``rolling_ols`` with the groups sharded
    (``solve_groups_sharded`` on the padded ``[G, R, 1+K]`` layout); the
    output as ``_moving_start`` gives it."""
    from ..parallel import solve_groups_sharded

    k, G = len(feats), layout.num_groups
    vals, valid, inv_w = _stack(target, feats, weights)
    policy = kwargs.null_policy
    Zp, vp, predict_valid = _moving_cached(layout, vals, valid, policy)
    want = "coefficients" if mode == "coefficients" else "predictions"
    is_rls = function_name == "recursive_least_squares"
    if is_rls:
        kw = dict(
            half_life=kwargs.half_life, initial_state_covariance=kwargs.initial_state_covariance,
            initial_state_mean=kwargs.initial_state_mean if mode == "coefficients" else None,
        )
    else:
        window, mp = int(kwargs.window_size), kwargs.min_periods
        positional = policy == "drop_window" or (valid is None and (mp is None or mp <= window))
        kw = dict(window=window, min_periods=mp, alpha=float(kwargs.alpha or 0.0), positional=positional)
    out = solve_groups_sharded(
        mesh, _moving_groups, [Zp, vp, layout.device_counts(), layout.counts], rls=is_rls, want=want, **kw
    )
    R = Zp.shape[1]
    return _moving_series(
        out, mode, is_rls, target.name, feats, G, R, k, layout.device_unpad(R), predict_valid, inv_w
    )


# --------------------------------------------------------------------------- #
# predict
# --------------------------------------------------------------------------- #
def evaluate_predict(coef, feat_series: List[Series], null_policy: str, name: str) -> Series:
    """Each row's coefficient struct dotted with its features (the JAX
    engine's ``evaluate_predict``, engine/fit.py:1856-1877; the reference's
    predict, src/expressions.rs:706-741). Null features count as zero
    ('zero', 'drop') or NaN ('ignore'); null coefficient fields are NaN, as
    the reference's unnest makes them. Under 'drop' a row is null where a
    feature is, or where every field of its coefficient struct is (a
    left-join row without coefficients)."""
    if not isinstance(coef, StructSeries):
        raise AssertionError("the first input to predict must be a coefficients struct")
    if len(coef.field_names) != len(feat_series):
        raise AssertionError(
            f"coefficient struct has {len(coef.field_names)} fields but "
            f"{len(feat_series)} feature columns were passed"
        )
    X = torch.stack([torch.as_tensor(s.values, dtype=F64, device=device()) for s in feat_series], dim=1)
    xv = torch.stack([s.valid_mask() for s in feat_series], dim=1)
    X = torch.where(xv, X, torch.nan if null_policy == "ignore" else 0.0)
    beta = coef.values if coef.validity is None else torch.where(coef.validity, coef.values, torch.nan)
    preds = (X * beta).sum(dim=1)
    validity = None
    if null_policy == "drop":
        coef_rows = torch.ones_like(xv[:, 0]) if coef.validity is None else coef.validity.any(dim=1)
        validity = xv.all(dim=1) & coef_rows
    return Series(name, preds, validity)
