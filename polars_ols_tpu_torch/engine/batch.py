"""The fits of a select run together: they share their moments, their
solves and one host read.

The counterpart of the JAX package's ``engine/batch.py``, which traces a
multi-fit select into one XLA program (whose CSE computes an alpha sweep's
moments once). Here a fit is a plan and a list of plans runs in stages on
the device. A fit evaluated alone (``evaluate_least_squares``) is a run of
one plan; a select runs every fit expression it holds as one run
(``try_fused_select``). There is one pipeline:

1. Planning (``plan_fit``): the cached stacks, partitions and layouts of
   engine/fit.py and the solve method. In a select, an expression that is
   not a single-target fit (a column, a multi-target fit, a nested
   ``.over``) is evaluated on its own in its place, and so is a grouped
   fit under ``CONFIG.auto_shard`` (engine/fit.py routes it through the
   sharded engine). Planning catches nothing: an error raises where the
   inputs are evaluated.
2. On the device, with no host read between the stages: the moments once
   for each distinct partition (``grouped_moments``, csrc/moments.cu),
   keyed on tensor identity; the Cholesky solves of plans that share
   moments and K as one batch of ``[P * G, K, K]`` (ops/linalg.py:
   ``chol_solve``; LU likewise), coordinate descent a plan (csrc/cd.cu),
   the Householder reduction once a partition for the ``svd`` plans and
   the Jacobi SVD a plan, the moving kernels queued without their flag
   read (ops/moving.py: ``Deferred``).
3. One host read of every plan's flags: a failed Cholesky or LU lane,
   ``chol``'s condition estimate over ``_COND_REFINE``, a moving call's
   flagged rows.
4. A flagged plan continues (the eigh solve of its failed lanes, the CSNE
   sweeps on the batch's factor, ``_resolve_flagged``); then the
   predictions of the plans on one partition in one pass over its
   features (``[P, S, R]``), and each output wrapped.

Every lane's arithmetic is that of a plan run alone: up to K = 32 the
batched Cholesky and LU are elementwise across lanes, so a lane's bits do
not depend on the batch; above K = 32 the library Cholesky may round
differently at another batch size, so there each plan keeps its own call.
A select gives what its expressions give one by one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..config import CONFIG, F64
from ..ops.direct import grouped_moments
from ..ops.linalg import MAX_K, chol_solve, cond_estimate, fallback_lanes, lu_solve, psd_solver_from
from . import fit

# host reads of flags since the last reset: one a run with a flag to read,
# whatever the number of its plans
flag_reads = 0
# plans that continued past the read on a flag (failed lanes, chol's CSNE,
# flagged moving rows) since the last reset
flagged_plans = 0


@dataclass(eq=False)
class _Plan:
    """One single-target fit, prepared up to its solve.

    ``kind`` is "fit" (a static fit's predictions or coefficients), "stats"
    or "moving"; ``family`` the solve: "chol", "qr", "lu", "cd" or "svd"
    (statistics also solve the normal equations by Cholesky). ``alias``
    and ``resid`` (the Series a ``y - fit`` residual subtracts from) are a
    select's. Results of the stages are set on it as they come."""

    kind: str
    mode: str = "predictions"
    family: str = ""
    layout: object = None
    layout_in: object = None
    n: int = 0
    alpha: float = 0.0
    rcond: Optional[float] = None
    cd: Optional[dict] = None
    names: tuple = ()
    name: str = ""
    blocks: tuple = ()  # (Zp, wp, predict_valid, block_group, offsets)
    inv_w: Optional[torch.Tensor] = None
    X_row: Optional[torch.Tensor] = None  # the drop family's row features (fit._row_features)
    start: Optional[Callable] = None  # moving: fit._moving_start bound to its inputs
    alias: Optional[str] = None
    resid: object = None
    # set by the stages
    moments: tuple = ()  # blocks + (XtX, Xty, counts)
    A: Optional[torch.Tensor] = None
    sol: Optional[torch.Tensor] = None  # [G, K, 1], failed lanes not yet replaced
    ok: Optional[torch.Tensor] = None
    L: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    flat: Optional[torch.Tensor] = None  # block-ordered predictions [S * R]
    pending: object = None  # moving: its Deferred
    out: Optional[torch.Tensor] = None
    finish: Optional[Callable] = None

    @property
    def K(self) -> int:
        return 0 if self.kind == "moving" else self.blocks[0].shape[2] - 1

    @property
    def ident(self) -> tuple:
        """The partition: the identities of the cached blocks."""
        return () if self.kind == "moving" else (id(self.blocks[0]), id(self.blocks[1]))


@dataclass(frozen=True)
class _Program:
    """A run's schedule: plan indices that share a moment launch, a
    batched solve (with its family), a Householder reduction, a prediction
    pass; and the moving plans."""

    moments: tuple
    solves: tuple
    reductions: tuple
    passes: tuple
    moving: tuple


def _schedule(plans: List[_Plan]) -> _Program:
    """Which plans share work: those on one partition share its moments,
    its Householder reduction and a prediction pass, and those of one
    solve family and K there one batched solve (above MAX_K each plan its
    own call)."""

    def groups(key) -> Dict[tuple, tuple]:
        out: Dict = {}
        for i, p in enumerate(plans):
            k = key(i, p)
            if k is not None:
                out.setdefault(k, []).append(i)
        return {k: tuple(v) for k, v in out.items()}

    def moments(i, p):
        return p.ident if p.kind == "stats" or p.family in ("chol", "qr", "lu", "cd") else None

    def solves(i, p):
        if p.kind == "stats" or p.family in ("chol", "qr"):
            # the library Cholesky above MAX_K: each plan its own call
            return ("chol", p.ident, p.K) if p.K <= MAX_K else ("chol", i)
        return ("lu", p.ident, p.K) if p.family == "lu" else None

    def reductions(i, p):
        return p.ident if p.family == "svd" else None

    def passes(i, p):
        predictions = p.kind == "fit" and p.mode != "coefficients" and p.X_row is None
        return p.ident if predictions else None

    return _Program(
        moments=tuple(groups(moments).values()),
        solves=tuple((k[0], g) for k, g in groups(solves).items()),
        reductions=tuple(groups(reductions).values()),
        passes=tuple(groups(passes).values()),
        moving=tuple(i for i, p in enumerate(plans) if p.kind == "moving"),
    )


def plan_fit(
    target, feat_series, kwargs, mode: str, layout_in, add_intercept: bool = False, weights=None,
    function_name: str = "least_squares",
) -> _Plan:
    """The plan of a plain target's fit (``evaluate_least_squares``'s
    arguments): its layout and features, the intercept's constant last;
    for a static fit the solve method, the cached column stack and blocks,
    and for predictions under the drop family the row features."""
    n = len(target)
    layout, feats = fit._fit_layout(n, feat_series, layout_in, add_intercept)
    if function_name != "least_squares":
        def start():
            return fit._moving_start(function_name, target, feats, kwargs, mode, layout, weights)

        return _Plan("moving", mode, start=start)

    method = fit._resolve_method(layout, kwargs, len(feats))
    vals, valid, inv_w = fit._stack(target, feats, weights)
    policy = kwargs.null_policy
    _, pmask, block_group, _ = fit._split_layout(layout)
    Zp, wp, predict_valid = fit._blocks_cached(layout, vals, valid, policy)
    offsets = layout.device_block_offsets(pmask.shape[1])
    cd = fit._cd_params(kwargs, method) if method.startswith("cd") else None
    family = "cd" if cd is not None else method
    if mode == "statistics" and family not in ("cd", "svd"):
        family = "chol"  # the dispatch solver's estimate is the normal equations'
    return _Plan(
        "stats" if mode == "statistics" else "fit", mode, family, layout=layout, layout_in=layout_in, n=n,
        alpha=float(kwargs.alpha or 0.0), rcond=kwargs.rcond, cd=cd, names=tuple(s.name for s in feats),
        name=target.name, blocks=(Zp, wp, predict_valid, block_group, offsets), inv_w=inv_w,
        X_row=fit._row_features(vals, valid, policy, 1) if mode == "predictions" else None,
    )


def _unwrap(expr):
    """Peel alias / over wrappers: (core expression, alias, over keys), or
    (None, None, None) for a nested ``.over``."""
    from ..expr import AliasExpr, OverExpr

    alias = keys = None
    while True:
        if isinstance(expr, AliasExpr):
            alias = alias or expr.name
            expr = expr.inner
        elif isinstance(expr, OverExpr):
            if keys is not None:
                return None, None, None
            keys, expr = expr.keys, expr.inner
        else:
            return expr, alias, keys


def _plan_expr(df, expr) -> Optional[_Plan]:
    """The plan of one expression of a select: a single-target fit or its
    ``y - fit`` residuals, each with or without one ``.over``; None for
    any other expression (a column, a multi-target fit, a struct target, a
    nested ``.over``). The inputs are evaluated as the expression's own
    ``evaluate`` evaluates them, in the same order."""
    from ..expr import BinExpr, LeastSquaresExpr
    from ..series import Series
    from .groups import layout_for_columns

    core, alias, keys = _unwrap(expr)
    resid = None
    if isinstance(core, BinExpr) and core.op == "sub" and isinstance(core.right, LeastSquaresExpr):
        resid, core = core.left, core.right
    if not isinstance(core, LeastSquaresExpr) or core.multi_target:
        return None
    layout_in = None if keys is None else layout_for_columns([df.get_column(k) for k in keys])
    if layout_in is not None and layout_in.num_groups > 1 and fit.shard_mesh() is not None:
        return None  # evaluated on its own, through the sharded engine
    resid = None if resid is None else resid.evaluate(df, layout_in)
    target, feats, weights = core.inputs(df, layout_in)
    if not isinstance(target, Series):
        return None
    plan = plan_fit(
        target, feats, core.kwargs, core.mode, layout_in, core.add_intercept, weights, core.function_name
    )
    plan.alias, plan.resid = alias, resid
    return plan


def _solve_batch(family: str, plans: List[_Plan]):
    """The Cholesky (or LU) solves of plans on one moment set and K as one
    batch ``[P * G, K, K]`` of ``XtX + alpha_p I``; each plan gets its
    slices of A, the solution (failed lanes not yet replaced), ``ok`` and
    the factor. Returns the batch's ``ok`` [P, G] and factor [P, G, K, K]
    (None for LU). Reads nothing from the device and copies nothing to it
    (a host-to-device copy synchronises)."""
    XtX, Xty = plans[0].moments[5:7]
    G, K = XtX.shape[0], XtX.shape[-1]
    P = len(plans)
    eye = torch.eye(K, dtype=F64, device=XtX.device)
    A = torch.stack([XtX + p.alpha * eye for p in plans])
    rhs = Xty[None, ..., None].expand(P, G, K, 1).reshape(P * G, K, 1)
    if family == "chol":
        sol, ok, L = chol_solve(A.reshape(P * G, K, K), rhs)
    else:
        (sol, ok), L = lu_solve(A.reshape(P * G, K, K), rhs), None
    for j, p in enumerate(plans):
        lanes = slice(j * G, (j + 1) * G)
        p.A, p.sol, p.ok = A[j], sol[lanes], ok[lanes]
        p.L = None if L is None else L[lanes]
    return ok.reshape(P, G), None if L is None else L.reshape(P, G, K, K)


def _flags(batches, moving: List[_Plan]):
    """The tensors of the one host read, each [P] or [1], and for each a
    list of (plan, what) its entries belong to (None: an entry no plan
    reads): "ok" (every lane of the plan factored), "refine" (``chol``'s
    condition estimate over the CSNE threshold), "moving" (the count of
    flagged rows). ``batches``: (plans, ok [P, G], factor [P, G, K, K])
    of each batched solve."""
    tensors, owners = [], []
    for group, ok, L in batches:
        tensors.append(ok.all(dim=1))
        owners += [(p, "ok") for p in group]
        chol = [p.kind == "fit" and p.family == "chol" for p in group]
        if any(chol):
            tensors.append(cond_estimate(L).amax(dim=1) > fit._COND_REFINE)
            owners += [(p, "refine") if c else None for p, c in zip(group, chol)]
    for p in moving:
        if p.pending.nflag is not None:
            tensors.append(p.pending.nflag)
            owners.append((p, "moving"))
    return tensors, owners


def _continue(p: _Plan, failed: bool, refine: bool) -> None:
    """A static fit after its solve, given its flags: the eigh solve of
    failed lanes, then the CSNE sweeps on the batch's factor for a
    ``chol`` fit whose condition estimate passed 1e6 and for every ``qr``
    fit (QR-grade forward error for cond(X) up to ~1e7; the reference's
    col-piv QR, src/least_squares.rs:193-205); ``lu`` takes no sweeps
    (src/least_squares.rs:264-273). ``beta`` [G, K]."""
    rhs = p.moments[6][..., None]
    sol = fallback_lanes(p.A, rhs, p.sol, p.ok) if failed else p.sol
    beta = sol[..., 0]
    if p.kind == "fit" and (p.family == "qr" or refine):
        Zp, wp, _, block_group, offsets = p.blocks
        solve = psd_solver_from(p.A, p.L, p.ok, not failed)
        beta = fit._csne_refine_blocks(
            p.A, beta, Zp[..., 1:], Zp[..., 0], wp, block_group, offsets, p.alpha, solve
        )
    p.beta = beta


def _run(plans: List[_Plan]) -> None:
    """The stages on the plans."""
    global flag_reads, flagged_plans
    program = _schedule(plans)
    for idxs in program.moments:  # a. moments once a partition
        p0 = plans[idxs[0]]
        Zp, wp, _, _, offsets = p0.blocks
        moments = p0.blocks + grouped_moments(Zp, wp, offsets, p0.layout.num_groups)
        for i in idxs:
            plans[i].moments = moments
    batches = []
    for family, idxs in program.solves:  # b. the batched solves
        group = [plans[i] for i in idxs]
        batches.append((group,) + _solve_batch(family, group))
    for p in plans:  # coordinate descent, a plan
        if p.family == "cd":
            XtX, Xty, counts = p.moments[5:]
            p.beta = fit._solve_cd(XtX, Xty, counts, p.alpha, p.cd)
    for idxs in program.reductions:  # the Householder reduction once, the Jacobi SVD a plan
        p0 = plans[idxs[0]]
        Zp, wp = p0.blocks[:2]
        T = fit._svd_reduce(p0.layout, Zp, wp)
        for i in idxs:
            p = plans[i]
            p.beta = fit._svd_solve(p.layout, Zp, wp, T, p.alpha, p.rcond)[..., 0]
    for i in program.moving:
        plans[i].pending, plans[i].finish = plans[i].start()

    tensors, owners = _flags(batches, [plans[i] for i in program.moving])  # e. one host read
    values = []
    if tensors:
        values = torch.cat([t.reshape(-1) for t in tensors]).tolist()
        flag_reads += 1
    flags: Dict[int, Dict[str, int]] = {}
    for owner, v in zip(owners, values):
        if owner is not None:
            flags.setdefault(id(owner[0]), {})[owner[1]] = int(v)
    flagged_plans += sum(
        (not f.get("ok", 1)) or f.get("refine", 0) > 0 or f.get("moving", 0) > 0 for f in flags.values()
    )

    for group, _, _ in batches:  # the flagged plans continue
        for p in group:
            f = flags[id(p)]
            failed = not f["ok"]
            if p.kind == "stats":  # the normal equations' solve; beta is theirs unless cd / svd
                sol = fallback_lanes(p.A, p.moments[6][..., None], p.sol, p.ok) if failed else p.sol
                p.sol = sol[..., 0]
                if p.family == "chol":
                    p.beta = p.sol
            else:
                _continue(p, failed, bool(f.get("refine", 0)))
    for i in program.moving:
        p = plans[i]
        p.out = p.pending.finish(flags.get(id(p), {}).get("moving", 0))

    for idxs in program.passes:  # c. predictions from shared blocks, one pass
        group = [plans[i] for i in idxs]
        Zp, block_group = group[0].blocks[0], group[0].blocks[3]
        betas = torch.stack([p.beta for p in group]).index_select(1, block_group)
        flat = fit._block_preds(Zp[..., 1:], betas).reshape(len(group), -1)
        for j, p in enumerate(group):
            p.flat = flat[j]


def _output(p: _Plan):
    """A plan's column: predictions in row order (unscaled for WLS), a
    coefficient struct, a ``StatisticsSeries``; a residual's subtraction
    and the alias last."""
    from ..expr import binop_series
    from ..series import Series

    if p.kind == "moving":
        s = p.finish(p.out)
    elif p.kind == "stats":
        s = fit._statistics_series(p.moments, p.alpha, p.beta, p.sol, list(p.names), p.layout, p.layout_in)
    elif p.mode == "coefficients":
        rows = p.beta if p.layout_in is None else p.beta.index_select(0, p.layout.device_gids())
        s = fit._coef_struct(rows, list(p.names))
    else:
        G = p.layout.num_groups
        if p.X_row is not None:
            preds = fit._predictions(p.beta, None, None, None, p.layout, p.n, p.X_row)
        else:
            unpad = p.layout.device_split_unpad(p.blocks[0].shape[1]) if G > 1 else None
            preds = fit._row_order(p.flat, unpad, p.n, G, lazy=CONFIG.lazy_row_order and p.inv_w is None)
        if p.inv_w is not None:
            preds = preds * p.inv_w
        s = Series(p.name, preds, p.blocks[2])
    if p.resid is not None:
        s = binop_series("sub", p.resid, s)
    return s.alias(p.alias) if p.alias else s


def run_plans(plans: List[_Plan]) -> List:
    """The plans' columns, in order, from one run."""
    _run(plans)
    return [_output(p) for p in plans]


def try_fused_select(df, exprs: List) -> Optional[List]:
    """The columns of a select's expressions, in order: its fit
    expressions as one run (shared moments, batched solves, one host
    read), any other expression evaluated on its own in its place; None
    where no expression is a fit or ``CONFIG.fused_select`` is off (the
    caller evaluates each expression on its own). The layout-cache entries
    the select touches stay cached while it runs (``fit.held_caches``), so
    a select over more partitions than that cache keeps does not rebuild
    them when it is repeated."""
    if not CONFIG.fused_select:
        return None
    with fit.held_caches():
        plans = [_plan_expr(df, e) for e in exprs]
        if all(p is None for p in plans):
            return None
        _run([p for p in plans if p is not None])
        return [e.evaluate(df) if p is None else _output(p) for e, p in zip(exprs, plans)]
