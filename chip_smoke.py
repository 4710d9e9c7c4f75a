"""Smoke run of the PyTorch/CUDA engine (polars_ols_tpu_torch) on one GPU.

Builds the hand-written CUDA kernels from this checkout (one nvcc per
source, all at once), runs the probe kernel's entry point, checks each
kernel against its plain PyTorch version on the card, drives the
grouped-OLS main path, the static fits (the five null policies, WLS,
residuals, explicit lu / qr / svd), the statistics and
coordinate-descent queries (statistics, also with svd, lasso, elastic
net, NNLS, the active-set variant) and the moving models (rls, expanding_ols,
rolling_ols under 'drop_window' and 'drop', weighted, coefficients), the
multi-target queries (struct(y, y2): predictions, residuals, weighted,
'drop' on the null columns) and predict / from_formula once
at full width through the public API (8,000,000 rows x 5 features x
10,000 groups, f64: the workload of bench.py, with ~1 % nulls per column
in half of the groups and a weight column; the moving models also on the
first 2,000,000 rows as one series, rolling_ols on all 8,000,000 rows as
one), checks the results against numpy and
scipy (a literal Kalman recursion and a numpy lstsq per window for the
moving models), and times them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Every phase prints one line. A kernel's time is device ms per launch: one
CUDA event pair around a run of back-to-back launches, divided by their
count, with the stream held by a device sleep while the host queues them,
so that the span is the device's time and not the host's; beside it, host
us per call (the host clock over the same calls, no synchronise). The
plain versions of the coordinate-descent and p-value kernels synchronise
inside (a convergence test per sweep or per 8 iterations), so they cannot
be queued behind a hold: their time is an event pair around whole calls,
host gaps included. An empty kernel timed the same way gives the floor
under every launch. Each kernel's bound is the least time the card could
take for its work on this run's inputs: the larger of the bytes it must
move over 3.35 TB/s and its operations over the peak rate of their type
(f64 67 TFLOP/s on the tensor cores for the products of matrices that
the moments and the Householder updates are, f64 34 TFLOP/s outside them
for the rest, f32 67 TFLOP/s). The edge cases
of the card-only tests (moments at C = 8 / 9, R = 513, empty groups, a grid
larger than the work; coordinate descent at K = 8 / 9 / 16 / 17; the
Householder reduction at R < K, with a zero feature column, NaN in masked
slots, K = 32, and one group of 2,000,000 rows through every level of its
tree; the Jacobi SVD at K = 1 / 8 / 16 / 32, rank-deficient and NaN
factors, alpha > 0 with a user rcond, and general square matrices) are
held to the plain versions too, and ``torch.profiler`` reads device busy
time, launches and host syncs of the main, svd, multi-target, lasso,
statistics, rls and rolling queries (and which moving kernels ran). The
Householder kernel is also timed beside ``torch.linalg.qr`` of the same
blocks and stopped after 0, 1 and K reflections (its phases); the Jacobi
SVD kernel beside the ``torch.linalg.svd`` route the port ran before it,
stopped after 0, 1 and all sweeps (its phases, each held to the plain
version under the same cap), at K = 8 / 16 / 32 too (its thread form at 8,
its segment form at 16 / 32), with numpy lstsq on sampled groups and a
latency bound (its longest group's chain of dependent rotations). The
coordinate-descent kernel gets a latency bound too (its longest group's
sweeps x K dependent coordinate steps and a stop test). The moving
kernel is also timed
on a sweep of its shape (rows a lane, rows a range), at K = 8 (its register
form) and 16 and 32 (its shared form) on the main frame's groups, on a
frame of lognormal group sizes, and at the shapes of the two wide
configurations below (K = 40 and 100); its register form's outputs at
K = 1 .. 8 are held bit for bit to digests recorded from it before the
shared form took K > 8, and its shared form is timed stopped after its
update, its LDL' and its back substitution (``_moving_phases``) at the
main frame's K = 16 and at "grouped_largek". The moment kernel's wide
form is checked to issue DMMA (mma.sync m8n8k4 f64) instructions in the
built code (``cuobjdump -sass``). The
p-value kernel also gets a latency bound (the dependent f64 operations of
its longest thread times the measured time of one) and a breakdown of its
time by stage. Last, the reference suite's two wide configurations run at
full size (benchmarks/suite.py:274-288): "large", one group of 10,000 rows
x 100 features, and "grouped_largek", 500,000 rows x 40 features x 1,000
groups (with the multi-target query of 40 seeded targets on 3 features),
and the suite's rls(252) and rolling_ols(252) there (the queries the suite
runs on "grouped_largek"), and the suite's elastic_net with the lasso,
NNLS, cd_active_set and the elastic net's statistics (coordinate descent
above K = 32: FISTA and the wide cyclic kernel), each query checked on
sampled groups against numpy lstsq and scipy.stats.t (rls against the
Kalman recursion, rolling against lstsq per window, the CD queries against
the elastic-net KKT conditions and a numpy coordinate descent), timed and
profiled; the FISTA and wide cyclic kernels are held to their plain
versions bit for bit at those moments, at K = 33 .. 200 and on
test_fit_wide's lasso, and timed beside their bounds; and the kernels' wide forms (the
moments above 33 columns, the Householder reduction above 33 columns with
its panel in shared or device memory, the Jacobi SVD above K = 32 and its
rows mode for fewer rows than features) are held to their plain versions
at the shapes those configurations give them and at their edges, and
timed beside their bounds and library calls. Before the wide configurations, the frame phase
(``_frame_phase``) runs the reference suite's workflow (``frame_steps``:
a lazy filter, row index, ``.over`` fits and column arithmetic,
``group_by(...).agg`` and ``.last()``, ``unique``, a left join then
``predict``, a two-key sort, statistics exploded; the features as
``selectors.starts_with("x")``) on the main frame, checks each step
against numpy and that every value column stays on the card, times and
profiles each step, then runs ``warmup()`` at the main frame's shape twice
and ``utils.trace`` around one query (its Chrome trace must hold CUDA
kernel events). After it the fused phase (``_fused_phase``) runs four
selects of several fits each (an alpha sweep, the JAX suite's mix, the
sweep over a collinear and an ill-conditioned group, "large"'s seven
queries) fused and eagerly: every column equal within 1e-12, sampled
groups against numpy, one flag read a select, one moment launch for the
sweep's eight, and each select's wall, device busy, launches and host
syncs fused beside eager. Then the sharded phase (``_sharded_phase``)
sets ``CONFIG.virtual_devices = 4`` and ``CONFIG.auto_shard`` on: every
family of tests/test_autoshard.py at the main frame (ols, lu, 'drop'
nulls, ridge, wls, lasso, elastic net, rls, rolling, expanding),
statistics (also by coordinate descent), coefficients, 'svd' and
multi-target run over four virtual shards of the card, each held to the
same query on one device (rtol 1e-8 / atol 1e-10, p-values 1e-6) and
timed and profiled both ways; three cases at the JAX tests' shapes (a
heavy group spanning every shard, the all-to-all shuffle bit for bit, a
near-collinear frame through the CSNE sweeps); over the real cards too
where the host has several. Then ``utils.trace`` of the main query in a
fresh process (``--trace-main``) says whether the port's kernels are in
its Chrome trace. The line before the last is a JSON object with the
kernels' names, sources, launch counts on their paths, errors, times and
bounds; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_ROWS = 8_000_000
N_FEATURES = 5
N_GROUPS = 10_000
N_CHECK_GROUPS = 200
TIMING_REPS = 5
KERNEL_REPS = 20  # samples of each version, taken in turns
PROBE_LAUNCHES = 100  # launches per sample: a few microseconds each
MOMENT_LAUNCHES = 20  # ~0.5 ms each
CD_LAUNCHES = 20
WIDE_CD_ONE_MS = 500.0  # a wide CD launch this long is timed once
PVALUE_LAUNCHES = 100
SYNCED_CALLS = 2  # calls per sample of a plain version that synchronises inside
# device sleep that holds the stream while the host queues a sample's
# launches: ~20 ms at the H100's ~2 GHz, several times the host's queueing
# (up to ~5 ms for 20 calls of the plain moment version)
HOLD_CYCLES = 40_000_000
HOLD_TRIES = 3  # a sample whose queueing outlasted the hold is taken again
NULL_RATE = 0.02  # per column in the odd-numbered groups (~1 % overall); row 0 valid
POLICIES = ("ignore", "zero", "drop", "drop_zero", "drop_y_zero_x")
COEF_TOL = dict(rtol=1e-9, atol=1e-11)
PRED_TOL = dict(rtol=1e-8, atol=1e-10)
# the statistics against numpy lstsq and scipy.stats.t (tests/oracles.py)
SE_T_TOL = dict(rtol=1e-8, atol=0.0)
P_TOL = dict(rtol=1e-6, atol=1e-12)
METRIC_TOL = dict(rtol=1e-9, atol=0.0)
CD_TOL = dict(rtol=1e-8, atol=1e-10)  # against a literal numpy coordinate descent
P_KERNEL_RTOL = 1e-12  # p-value kernel against its plain version and scipy
# alpha = 1 puts the lasso's threshold at the size of the true coefficients
# (all 1): about half the coefficients of a group are zero
LASSO_ALPHA = 1.0
ENET_ALPHA = 1.0
RIDGE_ALPHA = 10.0
# the H100 SXM's peaks at 700 W (NVIDIA's data sheet): device memory, f64
# outside the tensor cores, f64 on the tensor cores (DMMA: products of
# matrices, such as the moments' Z^T Z and the Householder panel updates),
# f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12
PEAK_F64_TC_PER_S = 67e12
PEAK_F32_PER_S = 67e12
PROFILE_QUERIES = 5
# profiles taken again where the device recorded fewer kernels than the host
# launched (CUPTI drops activity records now and then)
PROFILE_TRIES = 3
# the moving models: the reference benchmark suite's rls(half_life=252) and
# rolling_ols(window_size=252) under .over("group"), and the same models on
# the first SERIES_ROWS rows as one series
HALF_LIFE = 252.0
WINDOW = 252
MOVING_LAUNCHES = 20
# the moving kernel's shape, timed at the main frame: rows a lane (T) at the
# planner's rows a range, and rows a range at the default T (480 cuts every
# group of the frame into two ranges or more, 240 into four)
STRETCH_SWEEP = (3, 4, 5, 7, 8)
RANGE_SWEEP = (480, 240)
SWEEP_LAUNCHES = 10
# the moving kernel at wider K on the main frame's groups: its register
# form's widest (8) and its shared form (16, 32); the plain versions hold
# about PLAIN_COPIES tensors of [G, R, K, K] f64 at once (the outer
# products, their running sums, the regularised systems, their factors),
# so they run on as many groups as keep those under PLAIN_STATE_BYTES
# (_plain_groups; "grouped_largek"'s 1,000 groups hold 6.4 GB a copy at
# K = 40, the main frame's 10,000 about 5 GB at K = 8 and 75 GB at K = 32)
WIDE_K = (8, 16, 32)
PLAIN_COPIES = 5
PLAIN_STATE_BYTES = 36e9
WIDE_STRETCH_SWEEP = {8: (5,)}  # rows a lane timed beside the default (the register form)
# the skewed frame: N_ROWS rows over N_GROUPS groups of lognormal sizes
# (sigma 1) capped at SKEW_CAP rows; its plain check runs on SKEW_CHECKED
# groups, the longest among them
SKEW_SIGMA = 1.0
SKEW_CAP = 4_000
SKEW_CHECKED = 300
SKEW_RANGE_SWEEP = (2_560, 4_000)  # rows a range timed beside the planner's on it
# the moving kernels by name in a profile: the walk and the summary pass are
# one template (its last argument says which), then the prefix and the
# fill; the shared form's (K > 8) likewise, its third argument saying which
# and its last whether the states sit in shared memory or the workspace
MOVING_KERNEL_NAMES = {
    "walk": ("walk<", "true>("), "summary": ("walk<", "false>("), "prefix": ("prefix_",),
    "fill": ("fill<",), "walk (shared form)": ("walk_shared<", ", true, true>("),
    "walk (shared form, workspace)": ("walk_shared<", ", true, false>("),
    "summary (shared form)": ("walk_shared<", ", false, true>("),
    "summary (shared form, workspace)": ("walk_shared<", ", false, false>("), "fill (shared form)": ("fill_shared",),
}
# the Householder kernel: launches a timing sample (~0.2 ms each; the plain
# version and torch.linalg.qr take tens of ms), and the tolerance against its
# plain version: each entry of a block's factor within REDUCTION_RTOL of its
# column's norm over the block's valid rows (the same reflections, sums in
# another order)
HOUSEHOLDER_LAUNCHES = 10
REDUCTION_RTOL = 1e-12
TREE_RTOL = 1e-11  # a group's factor after three levels against the plain tree
# the Jacobi SVD kernel: launches a timing sample (tens of microseconds
# each), its tolerance against the plain version (each entry of a group's
# beta within JACOBI_RTOL of the group's largest |beta|: the same rotations,
# shuffle sums in another order), the edge batches' group count, and the
# groups held to the torch.linalg.svd route and numpy lstsq (COEF_TOL)
JACOBI_LAUNCHES = 50
JACOBI_RTOL = 1e-12
JACOBI_EDGE_GROUPS = 2_000
JACOBI_TIMED_K = (8, 16, 32)  # edge batches timed beside the main path's K = 5
# the multi-target queries: the reference suite's struct(y, y2) target
# (benchmarks/suite.py:151-156); y2 and its nulls come from a child stream
# of seed 0, so that every draw of the earlier phases stays as it was
Y2_COEFS = (0.5, -1.0, 2.0, 0.0, 1.5)
# predict of the ols coefficients against the ols predictions (the same
# coefficients, one dot product a row)
PREDICT_TOL = dict(rtol=1e-12, atol=1e-12)
SERIES_ROWS = 2_000_000
SERIES_HEAD = 20_000  # rows of the series checked against the literal oracles
SERIES_TAIL = 50  # and its last rows against closed forms
MOVING_KERNEL_TOL = dict(rtol=1e-9, atol=1e-11)  # kernel against its plain versions
# the moving kernel's register form (K <= 8) keeps its bits: digests of its
# outputs on _register_digests's inputs, recorded from the kernel as it was
# before the shared form took K > 8 (one NVIDIA H100 80GB HBM3)
REGISTER_FORM_DIGESTS = {
    1: "41570243a5bed743", 2: "7aeb33faec37fe08", 3: "e9fac194b5c94fd9", 4: "b6cb0e4da5c47b7a",
    5: "3b457e8651292c1b", 6: "699de79e1a1e9535", 7: "0db0abee2ddb6636", 8: "bf28bf9ecf79040f",
}
# windows with fewer than K + SETTLED_EXTRA valid rows are compared by their
# null pattern only: with as many rows as features the normal equations'
# error (cond^2 eps) can pass any tolerance, and with fewer the system is
# singular and round-off picks the branch
SETTLED_EXTRA = 3
# the latency yardstick: chains of dependent f64 operations of each kind
# the p-value and Jacobi kernels' critical paths hold (ops/special.py:CHAIN_OPS), at
# two lengths whose difference cancels the launch
CHAIN_LAUNCHES = 5
CHAIN_LENGTHS = (20_000, 40_000)


def _hold_ms(torch) -> float:
    """Device ms of one HOLD_CYCLES sleep."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def _launch_run(fn, n, hold_ms, torch):
    """(device ms per launch, host us per call) of n back-to-back calls of
    fn. The sleep queued first holds the stream until the host has queued
    all n, so the event pair brackets device time alone. A sample in which
    the host queued for more than 0.8 of the hold, so that the device may
    have waited on it, is taken again, up to HOLD_TRIES times; then it
    raises."""
    for _ in range(HOLD_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        stop.synchronize()
        if host_ms <= 0.8 * hold_ms:
            return start.elapsed_time(stop) / n, host_ms * 1e3 / n
    raise AssertionError(
        f"the host queued {n} calls in {host_ms!r} ms against a {hold_ms!r} ms "
        f"hold, {HOLD_TRIES} times: the event span would include host time"
    )


def _synced_run(fn, n, torch):
    """(ms per call, host us per call) of n calls of fn that synchronises
    inside: an event pair around the calls, host gaps included."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n, host_ms * 1e3 / n


def _in_turns(fns, n, torch, synced=()):
    """Median (device ms per launch, host us per call) of each named
    callable, KERNEL_REPS samples of n calls each, taken in turns forward
    and back (plain, kernel, kernel, plain for two), after a warm call.
    The callables named in ``synced`` synchronise inside: SYNCED_CALLS
    calls a sample, timed by ``_synced_run``."""
    for fn in fns.values():
        fn()
    hold_ms = _hold_ms(torch)
    samples = {name: [] for name in fns}
    order = list(fns)
    for _ in range(KERNEL_REPS // 2):
        for name in order + order[::-1]:
            if name in synced:
                samples[name].append(_synced_run(fns[name], SYNCED_CALLS, torch))
            else:
                samples[name].append(_launch_run(fns[name], n, hold_ms, torch))
    return {
        name: tuple(float(np.median(col)) for col in zip(*runs))
        for name, runs in samples.items()
    }


def _timing_fields(times):
    """The kernels-line fields of an _in_turns result over kernel, plain
    (None where it was not timed) and (where one PyTorch call computes the
    same function) library."""
    plain = times.get("plain", (None, None))
    return {
        "ms": times["kernel"][0], "plain_ms": plain[0],
        "library_ms": times["library"][0] if "library" in times else None,
        "host_us": times["kernel"][1], "plain_host_us": plain[1],
    }


def _bound(moved_bytes, ops, ops_per_s):
    """{bound_ms, bound_by}: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    by_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def _moment_bound(Zp, wp, G):
    """Zp, wp and the offsets read once, M and counts written once; one
    multiply and one add per upper-triangle entry of each valid row, at the
    tensor cores' f64 rate (a block's moments are a product of matrices)."""
    S, R, C = Zp.shape
    moved = S * R * (8 * C + 1) + 8 * (G + 1) + 8 * G * C * C + 8 * G
    return _bound(moved, int(wp.sum()) * C * (C + 1), PEAK_F64_TC_PER_S)


def _cd_step_path():
    """The dependent f64 operations from one coordinate's new w_j to the
    next coordinate's: the product with its XtX entry and the add that
    brings it into the row's sum, rho (b - sum, + XtX_jj w_j), the soft
    threshold (|rho| - a_l1, the clamp at 0, the sign's multiply) and the
    division. The shared-memory store and load between them are left out,
    so the bound stays a bound."""
    return {"fma": 7, "div": 1}


def _cd_test_path():
    """The stop test after a sweep's last coordinate: w_new - w_old, its
    square, the add that brings it into the norm, the square root and the
    comparison with tol (the shuffles left out)."""
    return {"fma": 4, "sqrt": 1}


def _cd_bound(G, K, sweeps, op_ms):
    """XtX, Xty and n_valid read once, w and the sweep counts written once;
    per sweep of a group K coordinate steps of 2K + 6 operations (the
    K-term dot, rho, the threshold, the division) and 3K for the step norm,
    over the sweeps this run's groups took. Beside it the latency bound:
    the most sweeps any group took, each K coordinate steps
    (``_cd_step_path``) and the stop test (``_cd_test_path``), each
    operation at the time one of its kind takes in a chain on this card,
    every warp resident at once."""
    moved = 8 * (G * K * K + G * K + G) + 8 * G * K + 4 * G
    most = int(np.max(sweeps, initial=0))
    chain = {kind: most * K * n for kind, n in _cd_step_path().items()}
    for kind, n in _cd_test_path().items():
        chain[kind] = chain.get(kind, 0) + most * n
    return {
        **_bound(moved, int(sweeps.sum()) * K * (2 * K + 9), PEAK_F64_PER_S),
        "latency_bound_ms": _path_ms(chain, op_ms), "longest_path": chain, "sweeps_max": most,
    }


def _cf_iterations(p, q, z):
    """Iterations the kernel's continued fraction
    (csrc/t_pvalue.cu:continued_fraction) takes for each element: a numpy
    replica of its recurrence and its stop test."""
    eps, big = 2.0 ** -52, 2.0 ** 200
    qab, qap, qam = p + q, p + 1.0, p - 1.0
    am, bm, az = np.ones_like(z), np.ones_like(z), np.ones_like(z)
    bz = 1.0 - qab * z / qap
    count = np.zeros(z.shape, dtype=np.int64)
    running = np.ones(z.shape, dtype=bool)
    for m in range(1, 201):
        m2 = 2.0 * m
        aa = (m * (q - m)) / ((qam + m2) * (p + m2)) * z
        ap, bp = az + aa * am, bz + aa * bm
        aa = -((p + m) * (qab + m)) / ((p + m2) * (qap + m2)) * z
        app, bpp = ap + aa * az, bp + aa * bz
        scale = np.where(np.abs(bpp) > big, 1.0 / big, np.where(np.abs(bpp) < 1.0 / big, big, 1.0))
        am, bm, az, bz = ap * scale, bp * scale, app * scale, bpp * scale
        count += running
        running &= ~(np.abs(app * bp - ap * bpp) <= eps * np.abs(ap * bpp))
        if not running.any():
            break
    return count


def _pvalue_branches(t, dof):
    """(live, series, cf, continued-fraction iterations of the cf elements)
    of the kernel on these inputs: which elements it computes at all, and
    by which branch."""
    d = np.broadcast_to(dof[:, None], t.shape).ravel()
    t = t.ravel()
    with np.errstate(all="ignore"):
        x = d / (d + t * t)
        a = d / 2.0
        live = (a > 0) & np.isfinite(a) & (x > 0) & (x < 1)
        series = live & (a >= 15.0) & (-np.log(x) <= 1.0)
        cf = live & ~series
        direct = x < (a + 1.0) / (a + 2.5)
        iters = _cf_iterations(
            np.where(direct, a, 0.5)[cf], np.where(direct, 0.5, a)[cf],
            np.where(direct, x, 1.0 - x)[cf],
        )
    return live, series, cf, iters


def _pvalue_paths(cf_iterations, series_terms):
    """The strands of dependent f64 operations that can be the longest path
    of one thread of the p-value kernel, each as {operation kind: count};
    the thread runs ``cf_iterations`` of the continued fraction, or (None)
    the series with ``series_terms`` terms.

    Every strand starts with x = d / (d + t^2): a multiply, an add, a
    divide. Continued fraction: the front factor exp(a log x + log1p(-x) / 2
    + lgamma ratio - ...) is reached through log x, through log1p(-x), or
    through the lgamma ratio's log1p(0.5 / a) (a division first), each
    followed by the sum's four multiply-adds, exp and the last multiply;
    beside them the recurrence: the first convergent's division (and two
    multiply-adds), two multiply-adds and the four-operation stop test an
    iteration, the final division, the last multiply. Series: log x, z = T u,
    sqrt, erfc, two operations on H and the sum a term, the last multiply."""
    x = {"fma": 2, "div": 1}
    if cf_iterations is None:
        return [{**x, "log": 1, "sqrt": 1, "erfc": 1, "fma": 2 + 1 + 3 * series_terms + 1}]
    tail = {"exp": 1, "fma_tail": 5}
    strands = [
        {**x, "log": 1, **tail},
        {**x, "log1p": 1, **tail},
        {"div": 1, "log1p": 1, **tail},
        {"fma": 2 + 2 + 6 * cf_iterations + 1, "div": 3},
    ]
    for strand in strands:
        strand["fma"] = strand.get("fma", 0) + strand.pop("fma_tail", 0)
    return strands


def _path_ms(path, op_ms):
    return sum(count * op_ms[kind] for kind, count in path.items())


def _pvalue_bound(t, dof, op_ms):
    """t and dof read once, p written once. Operations: 20 adds, multiplies
    and divides per continued-fraction iteration, as many as a numpy
    replica of the kernel's loop counts for these inputs, 10 per series
    term (all 15 counted where the series branch runs), and 25 around them;
    a call of log, exp, lgamma or erfc counts as one. Beside that bound,
    the latency bound: the longest strand of dependent f64 operations of
    any thread on these inputs (``_pvalue_paths``), each operation at the
    time ``op_ms`` one of its kind takes in a chain of its own on this
    card, all threads resident at once."""
    G, K = t.shape
    live, series, cf, iters = _pvalue_branches(t.cpu().numpy(), dof.cpu().numpy())
    ops = 25 * int(live.sum()) + 20 * int(iters.sum()) + 10 * 15 * int(series.sum())
    paths = []
    if cf.any():
        paths += _pvalue_paths(int(iters.max()), 0)
    if series.any():
        paths += _pvalue_paths(None, 15)
    longest = max(paths, key=lambda path: _path_ms(path, op_ms), default={})
    return {
        **_bound(8 * (2 * G * K + G), ops, PEAK_F64_PER_S),
        "latency_bound_ms": _path_ms(longest, op_ms), "longest_path": longest,
    }


def _kalman_numpy(X, y, v, ff, c=10.0, mean0=None):
    """The literal recursive-least-squares recursion of one series
    (src/least_squares.rs:494-598): P = c I and coef = mean0 to begin with;
    a valid row updates both with forgetting factor ff, an invalid one
    leaves them. Returns the coefficients after every row [n, K]."""
    n, k = X.shape
    P = np.eye(k) * c
    coef = np.zeros(k) if mean0 is None else np.broadcast_to(np.asarray(mean0, float), (k,)).copy()
    out = np.empty((n, k))
    for i in range(n):
        if v[i]:
            Px = P @ X[i]
            r = 1.0 + X[i] @ Px / ff
            gain = Px / (r * ff)
            coef = coef + gain * (y[i] - X[i] @ coef)
            P = P / ff - np.outer(gain, gain) * r
        out[i] = coef
    return out


def _window_numpy(X, y, v, window, min_periods, positional, rows=None):
    """Rolling OLS of one series by a numpy lstsq per window: (coefficients
    [n, K], NaN before the first solved window; valid rows in each row's
    window [n]). positional: the window is the last ``window`` rows, solved
    where it holds >= min_periods valid ones, else the last solution is
    carried. Otherwise the window is the last ``window`` valid rows, solved
    at valid rows from the min_periods-th on. ``rows`` limits the rows that
    are solved (the others stay NaN)."""
    n, k = X.shape
    out = np.full((n, k), np.nan)
    valid_idx = np.flatnonzero(v)
    rank = np.cumsum(v)
    counts = np.zeros(n, dtype=np.int64)
    last = np.full(k, np.nan)
    for i in (range(n) if rows is None else rows):
        if positional:
            lo = max(0, i - window + 1)
            take = lo + np.flatnonzero(v[lo:i + 1])
            solve = len(take) >= min_periods
        else:
            take = valid_idx[max(0, rank[i] - window):rank[i]]
            solve = bool(v[i]) and rank[i] >= min_periods
            if rows is not None and not solve and rank[i] >= min_periods:
                solve = True  # a carried row of a sparse selection: its window is unchanged
        counts[i] = len(take)
        if solve:
            last = _lstsq(X[take], y[take])
        out[i] = last
    return out, counts


def _moving_bound(n_rows, n_valid, n_refresh, n_leaving, K, rolling, discounted, coefficients, G,
                  fresh=True):
    """Z and the valid mask read once (and, rolling, the leaving-row index
    and the refresh mask), the row counts read once, the output written
    once. Operations: K (K + 3) multiply-adds to add a row's outer products
    (as many again for a leaving row; K (K + 3) / 2 + 1 multiplies where the
    state is discounted), and per solved row a Cholesky solve: K^3 / 3 + 2 K^2
    operations and 2 K square roots and divisions; 2 K for a prediction.
    ``fresh=False``: the least the function needs, a rank-one update of a
    kept factor for each row that enters or leaves (2 K^2 beside the
    moments') and per solved row only the two triangular solves (2 K^2 +
    2 K), no factorisation."""
    per_row = 8 * (1 + K) + 1 + (5 if rolling else 0) + 8 * (K if coefficients else 1)
    update = K * (K + 3) + (0 if fresh else 2 * K * K)
    solve = (K ** 3 / 3 if fresh else 0) + 2 * K * K + 2 * K
    ops = (n_valid + n_leaving) * update + n_refresh * solve
    if discounted:
        ops += n_valid * (K * (K + 3) // 2 + 1)
    if not coefficients:
        ops += 2 * K * n_rows
    return _bound(n_rows * per_row + 8 * G, ops, PEAK_F64_PER_S)


def _ptxas(log):
    """(kernel, registers line, spill line) of each entry in nvcc's
    -Xptxas -v output; the kernel named by the readable part of its
    mangled name."""
    out, entry, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = mangled = line.split("'")[1]
            # _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<hash8><n><name>[I...E]
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if m:
                end = m.end() + int(m.group(1))
                entry = mangled[m.end():end]
                t = re.match(r"I(?:NS_\d+([A-Za-z]+)I)?((?:L[ib]\d+E)+)", mangled[end:])
                if t:
                    args = ",".join(re.findall(r"L[ib](\d+)E", t.group(2)))
                    entry += f"<{t.group(1)}<{args}>>" if t.group(1) else f"<{args}>"
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "ptxas info" in line and "Used" in line:
            out.append((entry, line.split(":", 1)[1].strip(), spill))
    return out


def _dmma_counts(kernels):
    """{function: DMMA instructions} of the moment kernel's wide forms in
    the built sm_90a code (cuobjdump -sass of the library); raises where
    the staged or direct form issues none."""
    sass = subprocess.run(
        [str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(kernels.build("moments"))],
        capture_output=True, text=True, check=True,
    ).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((f for f in ("block_moments_wide", "block_moments_direct") if f in m.group(1)), None)
            if fn:
                fn += "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
                counts[fn] = 0
        elif fn and "DMMA" in line:
            counts[fn] += 1
    if len(counts) < 3 or not all(counts.values()):
        raise AssertionError(f"the moment kernel's wide forms issue no DMMA: {counts}")
    return counts


def _householder_sass(kernels):
    """{instantiation: {DMMA, LDS, STS, LD, ST}} of the Householder kernel's
    wide form in the built sm_90a code (cuobjdump -sass of the library;
    LD / ST are generic loads and stores). Raises where an instantiation
    issues no DMMA, or where the form whose panel sits in one CTA's shared
    memory (householder_wide<true, false>) reaches memory through a generic
    load or store."""
    sass = subprocess.run(
        [str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(kernels.build("householder"))],
        capture_output=True, text=True, check=True,
    ).stdout
    counts, fn = {}, None
    names = {"ILb1ELb0E": "shared", "ILb1ELb1E": "cluster", "ILb0ELb0E": "device memory"}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((v for k, v in names.items() if "householder_wide" in m.group(1) and k in m.group(1)), None)
            if fn:
                counts[fn] = dict.fromkeys(("DMMA", "LDS", "STS", "LD", "ST"), 0)
        elif fn:
            op = re.search(r"\b(DMMA|LDS|STS|LD|ST)(?=[.\s])", line)
            if op:
                counts[fn][op.group(1)] += 1
    if len(counts) < 3 or not all(c["DMMA"] for c in counts.values()):
        raise AssertionError(f"the Householder kernel's wide form issues no DMMA: {counts}")
    if counts["shared"]["LD"] or counts["shared"]["ST"]:
        raise AssertionError(f"the Householder wide form's shared path issues generic loads or stores: {counts}")
    return counts


def _householder_bound(Z, w, K):
    """Z and w read once, T [B, K, C] written once; ~4 (C - j) operations a
    valid row for reflection j (a dot product and an update of each column
    from the pivot on and of each target), at the tensor cores' f64 rate
    (blocked reflections are products of matrices)."""
    S, R, C = Z.shape
    moved = S * R * (8 * C + 1) + 8 * S * K * C
    return _bound(moved, 4 * int(w.sum()) * sum(C - j for j in range(K)), PEAK_F64_TC_PER_S)


def _reduction_err(T_k, T_p, Z, w, M, torch):
    """(max abs error on R, on Q^T Y) of the kernel's factors against the
    plain version's, checked: NaN where the plain version has it, each
    entry within REDUCTION_RTOL of its column's norm over the block's valid
    rows."""
    norm = torch.where(w[..., None], Z, 0.0).square().sum(dim=1, keepdim=True).sqrt()
    nan = torch.isnan(T_p)
    if not torch.equal(torch.isnan(T_k), nan):
        raise AssertionError("Householder kernel: NaN where the plain version has none, or none where it has")
    err = torch.where(nan, 0.0, (T_k - T_p).abs())
    if not bool((err <= REDUCTION_RTOL * norm).all()):
        worst = float((err / norm.clamp_min(1e-300)).max())
        raise AssertionError(f"Householder kernel: an entry {worst!r} of its column's norm from the plain version")
    return float(err[..., M:].max()), float(err[..., :M].max())


def _check_householder(label, Z, w, K, householder, torch, timed=True):
    """The Householder kernel against its plain version on the same CUDA
    blocks (and the same bits from a second launch); timed in turns with
    the plain version and torch.linalg.qr(mode="r") of the masked blocks
    with the feature columns first, whose first K rows are the same
    [R | Q^T Y]. Those two queue their work more slowly than a hold lasts
    (tens of launches a call; the QR's host side), so each is timed by an
    event pair around whole calls: their device time is tens of ms a call,
    far above the host's."""
    M = Z.shape[-1] - K
    T_k = householder.householder_blocks(Z, w, K)
    T_k2 = householder.householder_blocks(Z, w, K)
    torch.cuda.synchronize()
    if not torch.equal(torch.nan_to_num(T_k), torch.nan_to_num(T_k2)):
        raise AssertionError(f"Householder kernel ({label}): two launches differ")
    T_p = householder.householder_blocks_ref(Z, w, K)
    err_r, err_q = _reduction_err(T_k, T_p, Z, w, M, torch)
    S, R, C = Z.shape
    if R < K and not bool((T_k[:, R:] == 0).all()):
        raise AssertionError(f"Householder kernel ({label}): rows below the block's last are not zero")
    if bool(torch.isfinite(torch.where(w[..., None], Z, 0.0)).all()) and not bool(torch.isfinite(T_k).all()):
        raise AssertionError(f"Householder kernel ({label}): a masked slot's NaN reached the factor")
    ctas = householder.cluster_ctas(R, C) if Z.is_cuda else 0
    form = householder.kernel_form(R, C) if Z.is_cuda else "plain"
    line = (
        f"kernel householder {label}: B={S} R={R} C={C} K={K} ({form}, {ctas} CTAs a block) max_abs_err "
        f"R={err_r!r} Q^T Y={err_q!r} (within {REDUCTION_RTOL} of each column's norm), bit-equal launch to launch"
    )
    out = {"max_abs_err": max(err_r, err_q), "max_abs_err_r": err_r, "max_abs_err_qty": err_q, "ctas": ctas}
    if not timed:
        print(line)
        return out
    Zm = torch.where(w[..., None], Z, 0.0)
    Zx = torch.cat([Zm[..., M:], Zm[..., :M]], dim=-1)
    t = _timing_fields(_in_turns({
        "plain": lambda: householder.householder_blocks_ref(Z, w, K),
        "kernel": lambda: householder.householder_blocks(Z, w, K),
        "library": lambda: torch.linalg.qr(Zx, mode="r"),
    }, HOUSEHOLDER_LAUNCHES, torch, synced=("plain", "library")))
    bound = _householder_bound(Z, w, K)
    print(
        f"{line} kernel_ms={t['ms']!r} per launch, plain_ms={t['plain_ms']!r} library_ms="
        f"{t['library_ms']!r} (torch.linalg.qr) per call, host_us={t['host_us']!r} "
        f"plain_host_us={t['plain_host_us']!r}; bound {json.dumps(bound)}"
    )
    return {**out, **t, **bound}


def _householder_phases(label, Z, w, K, householder, torch, smi):
    """Device ms per launch of the Householder kernel stopped after the load
    (0 reflections), after one reflection, after the wide form's first
    panel (WY_PANEL reflections, where K has more) and after all K, in
    turns: the load, the first reflection and panel, and the rest apart."""
    steps = sorted({0, 1, min(householder.WY_PANEL, K), K})
    times = _in_turns({
        f"{r} reflections": (lambda r=r: householder._launch(Z, w, K, r)) for r in steps
    }, HOUSEHOLDER_LAUNCHES, torch)
    ms = {name: t[0] for name, t in times.items()}
    print(f"kernel householder phases {label}: ms per launch {json.dumps(ms)} ({smi})")
    return ms


# the dependent f64 operations of a rotation's angle in csrc/jacobi_svd.cu
# (``angle``, both forms), from the three dots to the rotated columns: 2 apq
# (or aqq - app); tau's Newton division (an rcp estimate and 6 multiply-adds);
# 1 + tau^2, its Newton root (an rsqrt estimate and 7), |tau| + that root and
# t's division (an estimate and 6); 1 + t^2 and c's reciprocal root (an
# estimate and 4); s = c t; and the rotation's multiply and multiply-add
JACOBI_ANGLE_PATH = {"fma": 1 + 6 + 1 + 7 + 1 + 6 + 1 + 4 + 1 + 2, "rcp": 2, "rsqrt": 2}


def _jacobi_dot_path(K, form):
    """The dependent f64 operations of a pair's dot products: a chain of K
    multiply-adds in a thread (the thread form), or a product and log2(KB)
    shuffle adds in a segment of KB lanes (the segment form; the shuffles'
    own latency is left out, so the bound stays a bound). The wide form's
    pair takes a warp or a half-warp: the shorter of a lane's ceil(K / 32)
    multiply-adds and 5 shuffle adds, and ceil(K / 16) and 4."""
    if form == "thread":
        return K
    if form == "wide":
        return min(-(-K // 32) + 5, -(-K // 16) + 4)
    return 1 + (16 if K <= 16 else 32).bit_length() - 1


def _jacobi_pair_path(K, form):
    """The dependent f64 operations from one rotated pair of columns to a
    later pair that shares a column with it, in the kernel's ``form``: the
    dots, then ``JACOBI_ANGLE_PATH``."""
    return {**JACOBI_ANGLE_PATH, "fma": _jacobi_dot_path(K, form) + JACOBI_ANGLE_PATH["fma"]}


def _jacobi_test_path(K, form):
    """The dependent f64 operations of a pair's test alone (a sweep that
    rotates nothing), on squares and without a root: the dots, then apq^2
    against K eps^2 app aqq (two multiplies deep)."""
    return {"fma": _jacobi_dot_path(K, form) + 2}


def _jacobi_chain(rotated, K, pairs=None):
    """Each group's longest chain of dependent rotations (pairs rotated in
    turn, each sharing a column with the one before: a rotation reads the
    columns the last rotations of p and q wrote) and its count of rotated
    pairs, from ``jacobi_ref``'s record ``rotated [G, sweeps, pairs]``,
    whose pairs go in the order ``pairs`` (default: the cyclic order).
    Pairs that rotate nothing write nothing and start no chain. A full
    sweep in cyclic order is 2 K - 3 rotations deep, not K(K-1)/2: (0, 4)
    and (1, 2) share no column; in the wide form's rounds it is K - 1 deep
    (K even), a round's pairs sharing no column."""
    rot = rotated.cpu().numpy()
    G, S, _ = rot.shape
    if pairs is None:
        pairs = [(p, q) for p in range(K - 1) for q in range(p + 1, K)]
    ready = np.zeros((G, K), dtype=np.int64)
    for sweep in range(S):
        for i, (p, q) in enumerate(pairs):
            r = rot[:, sweep, i]
            depth = np.maximum(ready[:, p], ready[:, q]) + 1
            ready[r, p] = ready[r, q] = depth[r]
    return ready.max(axis=1, initial=0), rot.sum(axis=(1, 2))


def _jacobi_bound(F, QtY, sweeps, rotated, op_ms, form, order=None):
    """F's K x K entries, Q^T Y and n_valid read once, beta written once;
    18 K + 20 operations a rotated pair (three K-term dots, the angle, two
    columns of W and of V) and 6 K + 6 a pair tested and not rotated (the
    three dots and the test), counted from this run's groups (the plain
    version's record: the kernel's may differ by a rotation where
    round-off puts |apq| at the threshold), and K^2 (2 M + 2) around them.
    Beside it the latency bound: the longest group's chain of dependent
    rotations (``_jacobi_chain``, the record's pairs in the order
    ``order``) times ``_jacobi_pair_path`` of the kernel's ``form``, plus
    the last sweep's test where that sweep rotated nothing, each operation
    at the time one of its kind takes in a chain on this card, every warp
    resident at once (the main path's 313 warps fit the card)."""
    G, K, M = QtY.shape
    pairs = K * (K - 1) // 2
    depth, rotations = _jacobi_chain(rotated, K, order)
    sweeps = sweeps.cpu().numpy()
    tested = int(sweeps.sum()) * pairs
    ops = int(rotations.sum()) * (18 * K + 20) + (tested - int(rotations.sum())) * (6 * K + 6)
    ops += G * K * K * (2 * M + 2)
    rot = rotated.cpu().numpy()
    last = (rot[np.arange(G), np.maximum(sweeps - 1, 0)].any(axis=-1) if rot.shape[1]
            else np.zeros(G, dtype=bool))
    converged = (sweeps > 0) & ~last
    pair, test = _jacobi_pair_path(K, form), _jacobi_test_path(K, form)
    chain = depth * _path_ms(pair, op_ms) + converged * _path_ms(test, op_ms)
    return {
        **_bound(8 * (G * K * K + 2 * G * K * M + G), ops, PEAK_F64_PER_S),
        "latency_bound_ms": float(chain.max(initial=0.0)), "chain_pairs_max": int(depth.max(initial=0)),
        "sweeps_max": int(sweeps.max(initial=0)), "sweeps_median": float(np.median(sweeps)),
        "pair_path": pair, "test_path": test,
    }


def _svd_route(F, QtY, n_valid, alpha, rcond, torch):
    """The torch.linalg.svd route the port ran before this kernel: the
    batched SVD of the factors (NaN on a non-finite factor, which
    torch.linalg.svd would refuse), numpy's cutoff and the ridge shrink."""
    bad = ~torch.isfinite(F).all(dim=-1).all(dim=-1)
    u, s, vt = torch.linalg.svd(torch.where(bad[:, None, None], 0.0, F), full_matrices=False)
    s = torch.where(bad[:, None], torch.nan, s)
    uty = torch.einsum("gji,gjm->gim", u, QtY)
    K = F.shape[-1]
    rc = 2.0 ** -52 * torch.clamp(n_valid, min=float(K)) if rcond is None else torch.full_like(n_valid, rcond)
    denom = s * s + alpha
    d = torch.where(s > (rc * s.amax(dim=-1))[:, None], s / torch.where(denom == 0, 1.0, denom), 0.0)
    beta = torch.einsum("gik,gim->gkm", vt, d[..., None] * uty)
    return torch.where(bad[:, None, None], torch.nan, beta)


def _jacobi_edge(rng, G, K, M, kind, torch, device="cuda"):
    """(F, QtY, n_valid) on the card: the triangular factors of G tall
    problems of 3 K + 2 rows, columns scaled by exp(normal) (kind
    "factor"); a third of them with a duplicate column and a third with a
    zero one ("deficient"); NaN in every seventh factor and in a target of
    others ("nan"); or general square matrices ("square", svd_lstsq's
    branch for groups of K rows)."""
    n = 3 * K + 2
    if kind == "square":
        F = rng.normal(size=(G, K, K))
    else:
        F = np.linalg.qr(rng.normal(size=(G, n, K)) * np.exp(rng.normal(size=(G, 1, K))), mode="r")
    if kind == "deficient":
        F[0::3, :, K - 1] = F[0::3, :, 0]
        F[1::3, :, K // 2] = 0.0
    Y = rng.normal(size=(G, K, M))
    if kind == "nan":
        F[0::7, 0, K - 1] = np.nan
        Y[3::7, K - 1, M - 1] = np.nan
    return (torch.as_tensor(F, device=device), torch.as_tensor(Y, device=device),
            torch.full((G,), float(n), dtype=torch.float64, device=device))


def _jacobi_err(label, b_k, b_p, torch):
    """Max abs error of the Jacobi kernel's beta against the plain
    version's, checked: NaN exactly where the plain version has it, each
    entry within JACOBI_RTOL of the group's largest |beta|."""
    nan = torch.isnan(b_p)
    if not torch.equal(torch.isnan(b_k), nan):
        raise AssertionError(f"Jacobi kernel ({label}): NaN where the plain version has none, or none where it has")
    err = torch.where(nan, 0.0, (b_k - b_p).abs())
    scale = torch.where(nan, 0.0, b_p.abs()).amax(dim=(1, 2), keepdim=True)
    if not bool((err <= JACOBI_RTOL * scale).all()):
        worst = float((err / scale.clamp_min(1e-300)).max())
        raise AssertionError(f"Jacobi kernel ({label}): an entry {worst!r} of its group's largest |beta| off")
    return float(err.max())


def _check_jacobi(label, F, QtY, n_valid, jacobi, torch, op_ms, alpha=0.0, rcond=None, timed=(),
                  plain_once=False):
    """The Jacobi SVD kernel against its plain version on the same CUDA
    factors (each entry of a group's beta within JACOBI_RTOL of the group's
    largest |beta|, NaN exactly where the plain version has it, the same
    bits from a second launch), and against the torch.linalg.svd route and
    numpy lstsq (alpha 0) on N_CHECK_GROUPS sampled finite groups at
    COEF_TOL. ``timed`` names what is timed in turns, with the bounds: of
    "kernel" (in the form its C entry picks, ``jacobi.kernel_form``),
    "plain" and "library" (the torch.linalg.svd route). With
    ``plain_once`` the plain version's time is its one checked call (at K
    = 40 / 100 its rounds launch some 10^4 small operations a call)."""
    b_k = jacobi.factor_lstsq(F, QtY, n_valid, alpha, rcond)
    b_k2 = jacobi.factor_lstsq(F, QtY, n_valid, alpha, rcond)
    torch.cuda.synchronize()
    if not torch.equal(torch.nan_to_num(b_k), torch.nan_to_num(b_k2)):
        raise AssertionError(f"Jacobi kernel ({label}): two launches differ")
    t0 = time.perf_counter()
    b_p = jacobi.factor_lstsq_ref(F, QtY, n_valid, alpha, rcond)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    G, K, M = QtY.shape
    form = jacobi.kernel_form(K, G)
    ctas = jacobi.wide_ctas(K, G) if form[0] == "wide" and F.is_cuda else 1
    out = {"max_abs_err": _jacobi_err(label, b_k, b_p, torch), "form": form[0],
           "threads_per_block": form[1], "groups_per_block": form[2], "ctas_per_group": ctas}
    nan = torch.isnan(b_p)
    b_l = _svd_route(F, QtY, n_valid, alpha, rcond, torch)
    finite = torch.isfinite(F).all(dim=-1).all(dim=-1) & torch.isfinite(QtY).all(dim=-1).all(dim=-1)
    if not torch.equal(torch.isnan(b_l), nan):
        raise AssertionError(f"Jacobi kernel ({label}): NaN pattern differs from the torch.linalg.svd route")
    pick = torch.nonzero(finite).flatten().cpu().numpy()
    pick = np.random.default_rng(G).choice(pick, size=min(N_CHECK_GROUPS, len(pick)), replace=False)
    Fh, Yh, nh = F[pick].cpu().numpy(), QtY[pick].cpu().numpy(), n_valid[pick].cpu().numpy()
    bk, bl = b_k[pick].cpu().numpy(), b_l[pick].cpu().numpy()
    np.testing.assert_allclose(bk, bl, err_msg=f"{label}: vs torch.linalg.svd", **COEF_TOL)
    if alpha == 0.0:
        for i in range(len(pick)):
            rc = 2.0 ** -52 * max(nh[i], K) if rcond is None else rcond
            want = np.linalg.lstsq(Fh[i], Yh[i], rcond=rc)[0]
            np.testing.assert_allclose(bk[i], want, err_msg=f"{label}: vs numpy lstsq", **COEF_TOL)
    out["max_abs_err_vs_library"] = float(np.abs(bk - bl).max())
    _, _, sweeps, rotated = jacobi.jacobi_ref(F)
    line = (
        f"kernel jacobi_svd {label}: G={G} K={K} M={M} alpha={alpha} rcond={rcond} {form[0]} form "
        f"({form[1]} threads, {form[2]} groups a block), {ctas} CTAs a group, max_abs_err={out['max_abs_err']!r} "
        f"vs plain "
        f"(within {JACOBI_RTOL} of each group's largest |beta|), NaN where the plain version has it, "
        f"bit-equal launch to launch; {len(pick)} groups match torch.linalg.svd"
        f"{' and numpy lstsq' if alpha == 0.0 else ''} ({COEF_TOL}); sweeps median "
        f"{float(sweeps.double().median())!r} max {int(sweeps.max())}"
    )
    if not timed:
        print(line)
        return out
    fns = {
        "plain": lambda: jacobi.factor_lstsq_ref(F, QtY, n_valid, alpha, rcond),
        "kernel": lambda: jacobi.factor_lstsq(F, QtY, n_valid, alpha, rcond),
        "library": lambda: _svd_route(F, QtY, n_valid, alpha, rcond, torch),
    }
    in_turns = [name for name in fns if name in timed and not (plain_once and name == "plain")]
    times = _in_turns({name: fns[name] for name in in_turns}, JACOBI_LAUNCHES, torch, synced=("plain", "library"))
    if plain_once and "plain" in timed:
        times["plain"] = (plain_s * 1e3, plain_s * 1e6)
    t = _timing_fields(times)
    order = [pq for rnd in jacobi.sweep_rounds(K, form[0] == "wide") for pq in rnd]
    bound = _jacobi_bound(F, QtY, sweeps, rotated, op_ms, form[0], order)
    print(
        f"{line}; kernel_ms={t['ms']!r} per launch, "
        f"plain_ms={t['plain_ms']!r} library_ms={t['library_ms']!r} (torch.linalg.svd route) per "
        f"call, host_us={t['host_us']!r}; bound {json.dumps(bound)}"
    )
    return {**out, **t, **bound}


def _jacobi_phases(label, F, QtY, n_valid, jacobi, torch, smi, held=None):
    """Device ms per launch of the Jacobi SVD kernel stopped after 0 sweeps
    (the loads, the cutoff, the shrink and the stores), after 1 and after
    all it needs (the cap MAX_SWEEPS), in turns; each capped launch of
    ``held`` (default: all three) first held to the plain version under the
    same cap. The wide forms' factors hold 0 and all sweeps: after one sweep
    W is not yet orthogonal, and the two orders of sums round apart by up to
    the factor's condition times eps in beta (4.1e-12 of a group's largest
    |beta| at B's factors, against JACOBI_RTOL 1e-12, on an H100)."""
    steps = sorted({0, 1, jacobi.MAX_SWEEPS})
    for n in steps if held is None else held:
        b_p = jacobi.factor_lstsq_ref(F, QtY, n_valid, max_sweeps=n)
        _jacobi_err(f"{label}, {n} sweeps", jacobi.factor_lstsq(F, QtY, n_valid, max_sweeps=n), b_p, torch)
    times = _in_turns({
        f"{n} sweeps": (lambda n=n: jacobi.factor_lstsq(F, QtY, n_valid, max_sweeps=n)) for n in steps
    }, JACOBI_LAUNCHES, torch)
    ms = {name: t[0] for name, t in times.items()}
    held = "each" if held is None else " / ".join(str(n) for n in held) + " sweeps"
    print(f"kernel jacobi_svd phases {label}: ms per launch {json.dumps(ms)}, {held} held to the plain "
          f"version under its cap ({smi})")
    return ms


def _check_kernel(name, Zp, wp, offsets, G, moments, torch, timed=True, library=False):
    """Kernel against plain version on the same CUDA tensors: only the
    summation order differs, so rtol 1e-12 / atol 1e-13 * max|M|; counts
    are integers and must match exactly, and a second launch gives the same
    bits (no atomics). Timed in turns with the plain version and, with
    ``library``, with torch.bmm(Zm^T, Zm) on the pre-masked blocks (block
    products only: no mask, no segment sum)."""
    M_k, c_k = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    M_k2, _ = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    torch.cuda.synchronize()
    if not torch.equal(M_k, M_k2):
        raise AssertionError(f"moment kernel ({name}): two launches differ")
    M_p, c_p = moments.grouped_moments_blocks_ref(Zp, wp, offsets, G)
    torch.cuda.synchronize()
    M_k, M_p = M_k.cpu().numpy(), M_p.cpu().numpy()
    scale = float(np.abs(M_p).max())
    np.testing.assert_allclose(M_k, M_p, rtol=1e-12, atol=1e-13 * scale)
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_p.cpu().numpy())
    err = float(np.abs(M_k - M_p).max())
    S, R, C = Zp.shape
    line = (
        f"kernel {name}: S={S} R={R} C={C} G={G} max_abs_err={err!r} "
        f"(max|M|={scale!r}), bit-equal launch to launch"
    )
    if not timed:
        print(line)
        return err, None
    fns = {
        "plain": lambda: moments.grouped_moments_blocks_ref(Zp, wp, offsets, G),
        "kernel": lambda: moments.grouped_moments_blocks(Zp, wp, offsets, G),
    }
    if library:
        Zm = torch.where(wp[..., None], Zp, torch.zeros((), dtype=Zp.dtype, device=Zp.device))
        fns["library"] = lambda: torch.bmm(Zm.mT, Zm)
    t = _timing_fields(_in_turns(fns, MOMENT_LAUNCHES, torch))
    print(
        f"{line} kernel_ms={t['ms']!r} plain_ms={t['plain_ms']!r} "
        f"library_ms={t['library_ms']!r} per launch, host_us={t['host_us']!r} "
        f"plain_host_us={t['plain_host_us']!r} per call"
    )
    return err, t


def _random_blocks(rng, n_blocks, R, C, torch, device="cuda"):
    """Blocks with column scales spread over decades and ~20% masked rows."""
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    wp = rng.random((S, R)) > 0.2
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    dev = torch.device(device)
    return (
        torch.as_tensor(Zp, dtype=torch.float64, device=dev),
        torch.as_tensor(wp, dtype=torch.bool, device=dev),
        torch.as_tensor(offsets, dtype=torch.int64, device=dev),
        len(n_blocks),
    )


def _group_rows(gids, groups):
    """[(g, rows)] for each listed group id, rows in row order."""
    order = np.argsort(gids, kind="stable")
    bounds = np.searchsorted(gids[order], [groups, np.asarray(groups) + 1])
    return [(g, order[lo:hi]) for g, lo, hi in zip(groups, bounds[0], bounds[1])]


def _groupwise_lstsq(X, y, gids, groups):
    """(rows, beta) of numpy lstsq for each listed group id."""
    for g, rows in _group_rows(gids, groups):
        yield g, rows, _lstsq(X[rows], y[rows])


def _lstsq(X, y):
    return np.linalg.lstsq(X, y, rcond=None)[0]


def _probe_inputs(grid_probe, torch):
    """(form, x, block_rows) of the probe cases: the JAX probe's two forms,
    a ragged shape, a view 4 bytes past a 16-byte boundary, tiles of an odd
    element count (bulk-copy edges at every tile), and more tiles than a
    grid's y dimension takes."""
    rows, cols, tile = grid_probe.PROBE_ROWS, grid_probe.PROBE_COLS, grid_probe.PROBE_TILE_ROWS
    x = torch.arange(rows * cols, dtype=torch.float32, device="cuda").reshape(rows, cols)
    shifted = torch.arange(rows * cols + 1, dtype=torch.float32, device="cuda")[1:]
    return (
        ("ungridded", x[:tile], None),
        ("gridded", x, tile),
        ("ragged", torch.arange(300 * 7, dtype=torch.float32, device="cuda").reshape(300, 7), 100),
        ("misaligned", shifted.view(rows, cols), tile),
        ("odd-tiles", torch.arange(999 * 33, dtype=torch.float32, device="cuda").reshape(999, 33), 333),
        ("many-tiles", torch.arange(70_000 * 4, dtype=torch.float32, device="cuda").reshape(70_000, 4), 1),
    )


def _check_probe(grid_probe, torch):
    """Every probe case against x * 2 on the card, one launch each: doubling
    an f32 is exact, so bit equality. The JAX probe's two forms are timed;
    returns the gridded form's (err, timing fields)."""
    gridded = None
    for form, x, block_rows in _probe_inputs(grid_probe, torch):
        before = grid_probe.scale_copy_launches
        out = grid_probe.scale_copy(x, block_rows)
        ref = grid_probe.scale_copy_ref(x)
        torch.cuda.synchronize()
        if grid_probe.scale_copy_launches != before + 1:
            raise AssertionError(f"probe kernel ({form}) was not launched exactly once")
        if not torch.equal(out, ref):
            raise AssertionError(f"probe kernel ({form}) differs from x * 2")
        err = float((out - ref).abs().max())
        rows = x.shape[0]
        line = (
            f"kernel probe {form}: {tuple(x.shape)} f32 in {rows // (block_rows or rows)} "
            f"tile(s) max_abs_err={err!r} (bit-equal)"
        )
        if form in ("ungridded", "gridded"):
            t = _timing_fields(_in_turns({
                "plain": lambda: grid_probe.scale_copy_ref(x),
                "kernel": lambda: grid_probe.scale_copy(x, block_rows),
            }, PROBE_LAUNCHES, torch))
            line += (
                f" kernel_ms={t['ms']!r} plain_ms={t['plain_ms']!r} per launch, "
                f"host_us={t['host_us']!r} plain_host_us={t['plain_host_us']!r} per call"
            )
            if form == "gridded":
                gridded = (err, t)
        print(line)
    return gridded


def _policy_expected(policy, X, y, vx, vy):
    """numpy reference of one group under a static null policy: (beta,
    predictions of every row, rows whose prediction is not null). 'ignore'
    fits nulls as NaN values: a NaN feature leaves the group without
    coefficients (the eigh fallback's NaN), a NaN target only leaves its
    non-finite solution zeroed (the Cholesky path's ``where(isfinite)``)."""
    k = X.shape[1]
    every = np.ones(len(y), dtype=bool)
    xz, yz = np.where(vx, X, 0.0), np.where(vy, y, 0.0)
    if policy == "ignore":
        if not vx.all():
            beta = np.full(k, np.nan)
        elif not vy.all():
            beta = np.zeros(k)
        else:
            beta = _lstsq(X, y)
        return beta, np.where(vx, X, np.nan) @ beta, every
    if policy == "zero":
        beta = _lstsq(xz, yz)
        return beta, xz @ beta, every
    fit = vy if policy == "drop_y_zero_x" else vy & vx.all(axis=1)
    beta = _lstsq(xz[fit], yz[fit])
    return beta, xz @ beta, (fit if policy == "drop" else every)


def _picked(s, sel):
    """Rows ``sel`` (a device index) of a Series or struct column on the
    host, nulls as NaN."""
    vals = s.values.index_select(0, sel).cpu().numpy()
    if s.validity is not None:
        vals = np.where(s.validity.index_select(0, sel).cpu().numpy(), vals, np.nan)
    return vals


def _timed_median(fn, torch, reps=TIMING_REPS) -> float:
    """Median host seconds of ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _check_cd(label, XtX, Xty, counts, kw, cd, torch, timed=True):
    """The coordinate-descent kernel against its plain version on the same
    CUDA moments: the same sums in the same order, so the same sweep counts
    and the same bits on every group. Returns (max abs error, timing fields
    or None, the sweep counts)."""
    w_k, s_k = cd.solve_elastic_net_cov(XtX, Xty, counts, **kw)
    torch.cuda.synchronize()
    w_p, s_p = cd.solve_elastic_net_cov_ref(XtX, Xty, counts, **kw)
    w_k, w_p = w_k.cpu().numpy(), w_p.cpu().numpy()
    s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
    np.testing.assert_array_equal(s_k, s_p)
    np.testing.assert_array_equal(w_k, w_p)
    err = float(np.abs(w_k - w_p).max())
    G, K = w_k.shape
    line = (
        f"kernel cd {label}: G={G} K={K} {kw} max_abs_err={err!r} bit-equal, equal sweep "
        f"counts (median {float(np.median(s_k))!r}, max {int(s_k.max())}), zero "
        f"coefficients={float((w_k == 0).mean())!r}"
    )
    if not timed:
        print(line)
        return err, None, s_k
    t = _timing_fields(_in_turns({
        "plain": lambda: cd.solve_elastic_net_cov_ref(XtX, Xty, counts, **kw),
        "kernel": lambda: cd.solve_elastic_net_cov(XtX, Xty, counts, **kw),
    }, CD_LAUNCHES, torch, synced=("plain",)))
    print(
        f"{line} kernel_ms={t['ms']!r} per launch, plain_ms={t['plain_ms']!r} per call (host "
        f"syncs inside), host_us={t['host_us']!r} plain_host_us={t['plain_host_us']!r} per call"
    )
    return err, t, s_k


def _wide_cd_paths(K):
    """The dependent f64 operations of the wide kernels' steps (L = log2 W,
    W the tree order's width): a row of XtX x or a dot is a product and L
    adds; a FISTA iteration is that row, grad (a subtract and an add), x
    (a division and a subtract), the threshold (|x| - thr, the clamp, the
    sign's multiply), the restart dot (a subtract, a product, L adds) and
    z's update (a subtract, a multiply, an add), and the stop test's square
    root; a power step the row, the norm (a product, L adds, a square root,
    the clamp) and the division. A cyclic coordinate is its row's dot, rho
    (a subtract, an add), the threshold and the division; a sweep ends with
    the step norm (a subtract, a product, L adds, a square root). Barriers,
    shared-memory traffic and shuffles are left out, so the bound stays a
    bound."""
    L = (max(32, 1 << (K - 1).bit_length())).bit_length() - 1
    return {
        "iteration": {"fma": 12 + 2 * L, "div": 1, "sqrt": 1},
        "power_step": {"fma": 3 + 2 * L, "div": 1, "sqrt": 1},
        "coordinate": {"fma": 6 + L, "div": 1},
        "sweep_end": {"fma": 2 + L, "sqrt": 1},
    }


def _cd_wide_bound(G, K, counts, op_ms, fista, power_steps):
    """XtX, Xty and n_valid read once, w and the counts written once; the
    operations this run's groups needed: a FISTA group (power steps + 1 +
    its iterations) products of XtX with a vector, 2 K^2 each; a cyclic
    group K coordinate dots of 2 K a sweep, over the sweeps it took; at 34
    TFLOP/s. Beside it the latency bound: the longest group's chain of
    dependent steps (``_wide_cd_paths``), each operation at the time one of
    its kind takes in a chain on this card."""
    moved = 8 * (G * K * K + G * K + G) + 8 * G * K + 4 * G
    paths = _wide_cd_paths(K)
    most = int(np.max(counts, initial=0))
    if fista:
        ops = (G * (power_steps + 1) + int(counts.sum())) * 2 * K * K
        chain = {kind: power_steps * paths["power_step"].get(kind, 0) + most * paths["iteration"].get(kind, 0)
                 for kind in ("fma", "div", "sqrt")}
    else:
        ops = int(counts.sum()) * K * 2 * K
        chain = {kind: most * (K * paths["coordinate"].get(kind, 0) + paths["sweep_end"].get(kind, 0))
                 for kind in ("fma", "div", "sqrt")}
    return {**_bound(moved, ops, PEAK_F64_PER_S), "latency_bound_ms": _path_ms(chain, op_ms),
            "longest_path": chain, "counts_max": most, "counts_median": float(np.median(counts))}


def _wide_cd_ms(fn, torch):
    """(device ms, host us) per launch of a wide coordinate-descent kernel,
    which may run for seconds: a warm launch, then one timed by an event
    pair, which is the reading where it took WIDE_CD_ONE_MS or more; else
    it sets the launches a sample (enough for ~20 ms, at least 1), and
    samples behind the hold, KERNEL_REPS of them or as many as ~1 s allows
    (at least 3), give the medians."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    host_us = (time.perf_counter() - t0) * 1e6
    stop.record()
    stop.synchronize()
    one = max(start.elapsed_time(stop), 1e-3)
    if one >= WIDE_CD_ONE_MS:
        return one, host_us
    n = max(1, min(CD_LAUNCHES, int(20.0 / one)))
    reps = max(3, min(KERNEL_REPS, int(1000.0 / (one * n))))
    hold = _hold_ms(torch)
    samples = [_launch_run(fn, n, hold, torch) for _ in range(reps)]
    return tuple(float(np.median(col)) for col in zip(*samples))


def _wide_cd_moments(seed, G, K, rows, torch):
    """Moments on the card of G groups of ``rows`` rows x K features drawn
    from a generator seeded with ``seed``, with coefficients of both signs,
    two thirds of them zero, so that positive=True clamps and the lasso
    leaves zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((G, rows, K), generator=gen, dtype=torch.float64, device="cuda")
    beta = torch.randn((G, K), generator=gen, dtype=torch.float64, device="cuda")
    beta = beta * (torch.rand((G, K), generator=gen, dtype=torch.float64, device="cuda") > 0.67)
    y = (X @ beta[..., None])[..., 0] + torch.randn((G, rows), generator=gen, dtype=torch.float64, device="cuda")
    XtX = (X.mT @ X).contiguous()
    Xty = (X.mT @ y[..., None])[..., 0].contiguous()
    del X
    return XtX, Xty, torch.full((G,), float(rows), dtype=torch.float64, device="cuda")


def _cd_wide_phases(label, args, fista, cd, torch, smi):
    """Device ms per launch of a wide coordinate-descent kernel stopped
    early, in turns with the whole launch: FISTA at max_iter = 0 (its cap is
    4 max_iter, so the power steps alone), the cyclic form at max_iter = 1
    (one sweep)."""
    early = "power steps" if fista else "1 sweep"
    part = (*args[:5], 0 if fista else 1, *args[6:])
    times = _in_turns({
        early: lambda: cd.launch_wide(*part, not fista, fista=fista),
        "all": lambda: cd.launch_wide(*args, not fista, fista=fista),
    }, CD_LAUNCHES, torch)
    ms = {name: t[0] for name, t in times.items()}
    print(f"kernel cd_{'fista' if fista else 'cyclic_wide'} phases {label}: ms per launch {json.dumps(ms)} ({smi})")
    return ms


def _check_cd_wide(label, XtX, Xty, counts, kw, cd, torch, op_ms, smi, timed=True, phases=False):
    """A wide coordinate-descent kernel (FISTA, or the cyclic form where
    ``kw`` asks for active_set) against its plain version on the same CUDA
    moments: the same sums in the same tree order, so the same iteration or
    sweep counts and the same values (the kernel's w before the polish;
    then the whole solve, the polish being the same torch code); timed (the
    kernel alone, ``_wide_cd_ms``) beside its bound, the plain version's
    time its one checked call, and with ``phases`` stopped early
    (``_cd_wide_phases``). The plan (form, warps a CTA, CTAs a group) is
    the C entry's, on CUDA tensors. No PyTorch call computes either
    function. Returns the kernels-line fields."""
    fista = not kw.get("active_set", False)
    args = (XtX, Xty, counts, kw["alpha"], kw.get("l1_ratio", 0.5), kw.get("max_iter", 1000),
            kw.get("tol", 1e-5), kw.get("positive", False))
    w_k, c_k = cd.launch_wide(*args, not fista, fista=fista)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_p, c_p = cd.fista_ref(*args, kernel_order=True) if fista else cd._cyclic_wide_ref(*args, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    c_k, c_p = c_k.cpu().numpy(), c_p.cpu().numpy()
    np.testing.assert_array_equal(c_k, c_p, err_msg=f"{label}: iteration counts")
    np.testing.assert_array_equal(w_k.cpu().numpy(), w_p.cpu().numpy(), err_msg=f"{label}: w")
    err = float(torch.nan_to_num(w_k - w_p).abs().max())
    s_k, _ = cd.solve_elastic_net_cov(XtX, Xty, counts, **kw)
    s_p = w_p
    if fista:  # the plain solve is the plain iterate, polished
        s_p = cd.active_set_polish(XtX, Xty, *cd._strengths(counts, args[3], args[4]), w_p, args[7])
    np.testing.assert_array_equal(s_k.cpu().numpy(), s_p.cpu().numpy(), err_msg=f"{label}: the whole solve")
    G, K = w_k.shape
    plan = cd.wide_plan(G, K, fista)._asdict() if XtX.is_cuda else {"xtx_shared": True, "work": 0}
    name = "fista" if fista else "cyclic_wide"
    out = {"max_abs_err": err, "plain_ms": plain_ms, "library_ms": None, "G": G, "K": K,
           "settings": {k: v for k, v in kw.items()},
           **{key: plan[key] for key in ("form", "warps", "ctas") if key in plan},
           "xtx_in": "shared memory" if plan["xtx_shared"] else "device memory",
           "workspace_doubles": plan["work"], "zero_share": float((s_k == 0).double().mean())}
    shape = f" form {out['form']} ({out['warps']} warps x {out['ctas']} CTAs a group)" if "form" in out else ""
    line = (f"kernel cd_{name} {label}: G={G} K={K} {kw}{shape} XtX in {out['xtx_in']}: the same "
            f"{'iterations' if fista else 'sweeps'} (median {float(np.median(c_k))!r}, max {int(c_k.max())}) "
            f"and values as the plain version (w and the whole solve); zero coefficients "
            f"{out['zero_share']!r}; plain_ms={plain_ms!r} (one call)")
    if not timed:
        print(line)
        return out
    ms, host_us = _wide_cd_ms(lambda: cd.launch_wide(*args, not fista, fista=fista), torch)
    bound = _cd_wide_bound(G, K, c_k, op_ms, fista, cd.POWER_STEPS)
    out.update({"ms": ms, "host_us": host_us, **bound})
    print(f"{line}; kernel_ms={ms!r} per launch, host_us={host_us!r}; bound {json.dumps(bound)}; "
          f"no library call computes it ({smi})")
    if phases:
        out["phases_ms"] = _cd_wide_phases(label, args, fista, cd, torch, smi)
    return out


def _profile(fn, torch, named=None, top=0, queries=PROFILE_QUERIES, warm=True):
    """Device busy ms (the union of device intervals), launches (launch API
    calls) and host syncs (stream / device syncs, less the loop's own) per
    query, from torch.profiler over ``queries`` queries (PROFILE_QUERIES)
    after a warm one (``warm``), with the host ms per query under the profiler (which inflates it:
    the idle share 1 - busy / wall is an upper bound), and the device ms per
    query of the kernels of each label of ``named`` (those whose names hold
    all of its strings), and the ``top`` device operations by device ms
    per query. Taken again, up to PROFILE_TRIES times, where the device
    recorded fewer kernels than the host launched. None when the profiler
    records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    named = named or {}
    if warm:
        fn()
        torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(queries):
                fn()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / queries
        events = prof.events()
        names = [e.name for e in events if e.device_type == DeviceType.CPU]
        launches = sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
                       for n in names)
        kernels = sum(e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))
                      for e in events)
        if kernels >= launches:
            break
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    syncs = sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for n in names)
    busy_ms = busy_us / 1e3 / queries
    by_name = {
        label: sum(
            e.time_range.end - e.time_range.start
            for e in events if e.device_type == DeviceType.CUDA and all(k in e.name for k in keys)
        ) / 1e3 / queries
        for label, keys in named.items()
    }
    seen = sorted({
        e.name.split(">(")[0] + ">" for e in events
        if e.device_type == DeviceType.CUDA and any(all(k in e.name for k in keys) for keys in named.values())
    })
    totals = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            name = e.name[:90]
            totals[name] = totals.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / queries
    return {
        "top_ms": sorted(totals.items(), key=lambda kv: -kv[1])[:top],
        "kernels_ms": by_name, "kernel_names": seen, "tries": tries, "complete": kernels >= launches,
        "busy_ms": busy_ms, "launches": launches / queries,
        "host_syncs": (syncs - queries) / queries,
        "wall_ms": wall_ms, "idle_share": 1.0 - busy_ms / wall_ms,
    }


def _signed_moments(rng, G, K, torch):
    """Moments of G groups of 40 rows with sparse coefficients of both
    signs, so that positive=True clamps."""
    X = rng.normal(size=(G, 40, K))
    beta = rng.normal(size=(G, K)) * (rng.random((G, K)) > 0.3)
    y = np.einsum("grk,gk->gr", X, beta) + rng.normal(size=(G, 40))
    dev = torch.device("cuda")
    return (
        torch.as_tensor(np.einsum("grk,grl->gkl", X, X), device=dev),
        torch.as_tensor(np.einsum("grk,gr->gk", X, y), device=dev),
        torch.full((G,), 40.0, dtype=torch.float64, device=dev),
    )


def _pvalue_inputs(t_query, dof_query, torch):
    """(t [G, 5], dof [G]) of the p-value check: the statistics query's t and
    dof, the same t / 100 (p-values away from 0), and edge rows: t = 0,
    |t| = 40, dof 1 / 2.5 / 8e6, dof 0 and -3, NaN t."""
    nan = float("nan")
    edges = np.asarray([
        [0.0, 0.5, 1.0, 2.0, 40.0],
        [0.0, -0.5, 1.5, 3.0, -40.0],
        [0.0, 1.5, 1.8, 2.0, 40.0],
        [0.0, 1.0, 2.0, 3.0, 4.0],
        [1.0, 2.0, 3.0, 4.0, 5.0],
        [nan, 1.0, nan, 2.0, 3.0],
    ])
    edge_dof = np.asarray([1.0, 2.5, 8e6, 0.0, -3.0, 10.0])
    dev = torch.device("cuda")
    t = torch.cat([t_query, t_query / 100.0, torch.as_tensor(edges, device=dev)]).contiguous()
    dof = torch.cat([dof_query, dof_query, torch.as_tensor(edge_dof, device=dev)]).contiguous()
    return t, dof


def _dependent_op_ms(special, torch):
    """Device ms of one dependent f64 operation of each kind of
    ops/special.py:CHAIN_OPS, from chains of two lengths on one warp (their
    difference cancels the launch)."""
    seed = torch.full((1,), 0.5, dtype=torch.float64, device="cuda")
    chain = _in_turns({
        (kind, n): (lambda kind=kind, n=n: special.f64_chain(n, seed, kind))
        for kind in special.CHAIN_OPS for n in CHAIN_LENGTHS
    }, CHAIN_LAUNCHES, torch)
    short, long_ = CHAIN_LENGTHS
    op_ms = {
        kind: (chain[(kind, long_)][0] - chain[(kind, short)][0]) / (long_ - short)
        for kind in special.CHAIN_OPS
    }
    for kind in special.CHAIN_OPS[1:]:  # their steps carry one more add or multiply
        op_ms[kind] -= op_ms["fma"]
    return op_ms


def _check_pvalue(t_query, dof_query, special, torch, op_ms):
    """The p-value kernel against its plain version (rtol 1e-12, NaN where
    it has NaN) and scipy.special.betainc (rtol 1e-12) on the statistics
    query's t, the same t / 100 and edge rows; timed at the query's shape."""
    from scipy import special as sp

    t, dof = _pvalue_inputs(t_query, dof_query, torch)
    p_k = special.t_two_sided_p_value(t, dof)
    torch.cuda.synchronize()
    p_p = special.t_two_sided_p_value_ref(t, dof).cpu().numpy()
    p_k = p_k.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(p_k), np.isnan(p_p))
    np.testing.assert_allclose(p_k, p_p, rtol=P_KERNEL_RTOL, atol=0.0)
    tn, dn = t.cpu().numpy(), dof.cpu().numpy()[:, None]
    with np.errstate(invalid="ignore"):
        x = dn / (dn + tn * tn)
    ok = (dn > 0) & np.isfinite(x)
    ref = sp.betainc(np.broadcast_to(dn / 2.0, x.shape)[ok], 0.5, x[ok])
    np.testing.assert_allclose(p_k[ok], ref, rtol=P_KERNEL_RTOL, atol=1e-300)
    if not ((p_k[tn == 0] == 1.0) | (dn <= 0).repeat(5, 1)[tn == 0]).all():
        raise AssertionError("p-value at t = 0 is not 1")
    if not (np.isnan(p_k[-2:-1]).all() and np.isnan(p_k[-1, [0, 2]]).all()):
        raise AssertionError("p-value of a negative dof or a NaN t is not NaN")
    err = float(np.nanmax(np.abs(p_k - p_p)))
    scipy_rel = float(np.max(np.abs(p_k[ok] - ref) / np.maximum(ref, 1e-300)))
    G = t_query.shape[0]
    raw = _in_turns({
        "plain": lambda: special.t_two_sided_p_value_ref(t_query, dof_query),
        "kernel": lambda: special.t_two_sided_p_value(t_query, dof_query),
        "load_store": lambda: special.t_pvalue_timing_stage(t_query, dof_query, "load_store"),
        "front": lambda: special.t_pvalue_timing_stage(t_query, dof_query, "front"),
    }, PVALUE_LAUNCHES, torch, synced=("plain",))
    times = _timing_fields(raw)
    times["load_store_ms"], times["front_ms"] = raw["load_store"][0], raw["front"][0]
    times["dependent_op_ns"] = {kind: ms * 1e6 for kind, ms in op_ms.items()}
    print(
        f"kernel t_pvalue: {2 * G + 6} rows x 5 (query t, t/100, edges) max_abs_err={err!r} "
        f"vs plain, max rel err vs scipy={scipy_rel!r}; at the query's [{G}, 5]: "
        f"kernel_ms={times['ms']!r} per launch (loads, x and store alone {times['load_store_ms']!r}, "
        f"with the front factor {times['front_ms']!r}), plain_ms={times['plain_ms']!r} per call "
        f"(host syncs inside), host_us={times['host_us']!r} plain_host_us="
        f"{times['plain_host_us']!r} per call; one dependent f64 operation, ns: "
        f"{json.dumps(times['dependent_op_ns'])}"
    )
    return err, times


def _moving_batch(rng, K, torch, r=300, device="cuda"):
    """Five groups for the moving kernel's checks: full, shorter than the
    long window, empty, one row, ragged; ~5 % invalid rows."""
    rows = np.asarray([r, 40, 0, 1, r - 13])
    G = len(rows)
    X = rng.normal(size=(G, r, K)) * np.resize([1.0, 3.0, 0.3], K)
    y = X.sum(-1) + rng.normal(size=(G, r)) * 0.1
    v = (rng.random((G, r)) > 0.05) & (np.arange(r)[None] < rows[:, None])
    dev = torch.device(device)
    return (
        torch.as_tensor(np.concatenate([y[..., None], X], axis=-1), device=dev),
        torch.as_tensor(v, device=dev), torch.as_tensor(rows, device=dev), rows,
    )


def _window_counts(v, window, positional):
    """Valid rows in each row's window, [G, R]."""
    r = np.cumsum(v, axis=1)
    if not positional:
        return np.minimum(r, window)
    shifted = np.concatenate([np.zeros((v.shape[0], window), dtype=r.dtype), r], axis=1)
    return r - shifted[:, : v.shape[1]]


def _moving_diff(out, ref, rows, settled=None):
    """Max abs difference of a moving result from its plain version over
    each group's own rows: an equal NaN pattern everywhere, values at
    MOVING_KERNEL_TOL where ``settled`` (default: everywhere)."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    worst = 0.0
    for g, n in enumerate(rows):
        a, b = out[g, :n], ref[g, :n]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(b)
        if settled is not None:
            m &= settled[g, :n].reshape((-1,) + (1,) * (a.ndim - 1))
        np.testing.assert_allclose(a[m], b[m], **MOVING_KERNEL_TOL)
        if m.any():
            worst = max(worst, float(np.abs(a[m] - b[m]).max()))
    return worst


def _ridge_exact(Z, v, rows, window, min_periods, alpha, positional, want):
    """Rolling ridge (alpha > 0) of Z = [y | x] [G, R, 1 + K] over the valid
    rows v [G, R] (numpy) solved without rounding to speak of: each window's
    coefficients in the dual form x_w' (X_w X_w' + alpha I)^-1 y_w, its m x m
    system (m <= window rows) eliminated in long double; the windows as the
    plain version defines them (positional: the valid rows of the last
    ``window``; else the last ``window`` valid rows), carried across rows
    that do not refresh, NaN before the first. Coefficients [G, R, K] or
    predictions [G, R], float64."""
    G, R, C = Z.shape
    K = C - 1
    mp = min(K, window) if min_periods is None else min_periods
    ld = np.longdouble
    out = np.full((G, R, K) if want == "coefficients" else (G, R), np.nan)
    for g in range(G):
        beta, rank = None, 0
        valid = np.flatnonzero(v[g, : rows[g]])
        for t in range(rows[g]):
            rank += int(v[g, t])
            if positional:
                w = valid[(valid > t - window) & (valid <= t)]
                solve = len(w) >= mp
            else:
                w = valid[max(0, rank - window): rank]
                solve = bool(v[g, t]) and rank >= mp
            if solve:
                Xw, yw = Z[g, w, 1:].astype(ld), Z[g, w, 0].astype(ld)
                A = np.concatenate([Xw @ Xw.T + ld(alpha) * np.eye(len(w), dtype=ld), yw[:, None]], axis=1)
                m = len(w)
                for c in range(m):
                    A[c + 1:] -= np.outer(A[c + 1:, c] / A[c, c], A[c])
                u = np.zeros(m, dtype=ld)
                for r in range(m - 1, -1, -1):
                    u[r] = (A[r, m] - A[r, r + 1: m] @ u[r + 1:]) / A[r, r]
                beta = Xw.T @ u
            if beta is not None:
                out[g, t] = beta if want == "coefficients" else Z[g, t, 1:].astype(ld) @ beta
    return out


def _max_abs_diff(out, ref, rows):
    """Max abs difference of two moving results over each group's own rows
    where both have a value."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    worst = 0.0
    for g, n in enumerate(rows):
        a, b = out[g, :n], ref[g, :n]
        m = ~np.isnan(a) & ~np.isnan(b)
        if m.any():
            worst = max(worst, float(np.abs(a[m] - b[m]).max()))
    return worst


def _register_digests(moving, torch, device="cuda"):
    """{K: digest} of the register form's outputs at K = 1 .. 8: rls (with
    and without forgetting) and rolling (both window semantics) in both
    output forms, at the planner's rows a range and at 32 and 2, on
    _moving_batch's groups (seed 500 + K); each output's bytes over the
    groups' own rows are hashed, and the K's hashes in turn."""
    out = {}
    for k in range(1, 9):
        Z, v, rows_t, rows = _moving_batch(np.random.default_rng(500 + k), k, torch, device=device)
        parts = []
        for want in moving.WANTS:
            for chunk in (None, 32, 2):
                for run in (
                    lambda: moving.recursive_least_squares(Z, v, rows_t, 20.0, 10.0, 0.5, want=want, chunk=chunk),
                    lambda: moving.recursive_least_squares(Z, v, rows_t, None, 10.0, None, want=want, chunk=chunk),
                    lambda: moving.rolling_ols(Z, v, rows_t, 30, None, 0.0, True, want=want, chunk=chunk),
                    lambda: moving.rolling_ols(Z, v, rows_t, 30, 2, 0.1, False, want=want, chunk=chunk),
                ):
                    o = run()
                    h = hashlib.sha256()
                    for g, n in enumerate(rows):
                        h.update(o[g, :n].contiguous().cpu().numpy().tobytes())
                    parts.append(h.hexdigest()[:16])
        out[k] = hashlib.sha256("".join(parts).encode()).hexdigest()[:16]
    return out


def _plain_groups(G, R, K):
    """Groups of R padded rows on which the plain moving versions run:
    PLAIN_COPIES tensors of [G, R, K, K] f64 kept under PLAIN_STATE_BYTES."""
    return int(min(G, max(1, PLAIN_STATE_BYTES // (PLAIN_COPIES * R * K * K * 8))))


def _check_moving(moving, recursive, rolling, torch):
    """csrc/moving.cu against the plain versions on the card: rls with and
    without forgetting and prior mean, rolling in both window semantics, at
    K = 5, 8 (the register form), 9, 16, 17, 32, 33, 40, 100 and 160 (the
    shared form; K = 33 where the JAX engine leaves exact moments, 160
    where its state and factor sit in the device-memory workspace; in the
    shared form the ridge windows of 5 rows, fewer than the features, are
    systems of condition ~1e4 whose rounding in the plain version alone
    can pass the tolerance at a prediction near zero, so they are held to
    each window solved in long double, ``_ridge_exact``, and to the plain
    version's NaN pattern, with the plain version's own distance from the
    long-double answer printed),
    coefficients and predictions, the rows a range chosen
    (one range a group) and forced to 32 rows (several ranges a group: the
    summary pass, the prefix and the fill) and to 2 rows (the prefix over a
    group's ranges in segments), on groups that are
    full, shorter than the window, empty and of one row. Returns the
    number of cases and the largest difference."""
    rng = np.random.default_rng(3)
    cases, worst = 0, 0.0
    short = {"kernel_vs_plain": 0.0, "kernel_vs_exact": 0.0, "plain_vs_exact": 0.0}
    for K in (5, 8, 9, 16, 17, 32, 33, 40, 100, 160):
        Z, v, rows_t, rows = _moving_batch(rng, K, torch)
        X, y, vn = Z[..., 1:], Z[..., 0], v.cpu().numpy()
        for half_life, mean in ((HALF_LIFE, None), (None, None), (HALF_LIFE, 0.5),
                                (None, list(np.linspace(-1.0, 1.0, K)))):
            coefs = recursive.solve_recursive_least_squares(X, y, v, half_life, 10.0, mean)
            for want in moving.WANTS:
                for chunk in (None, 32, 2):
                    out = moving.recursive_least_squares(
                        Z, v, rows_t, half_life, 10.0, mean, want=want, chunk=chunk
                    )
                    worst = max(worst, _moving_diff(out, moving._from_coefs(coefs, Z, want), rows))
                    cases += 1
        for window, min_periods, alpha in ((WINDOW, None, 0.0), (WINDOW, 2, 0.1), (5, None, 0.1), (5, 2, 0.0)):
            for positional in (True, False):
                coefs = rolling.solve_rolling_ols(X, y, v, window, min_periods, alpha, positional)
                settled = None
                if alpha == 0.0:
                    settled = _window_counts(vn, window, positional) >= K + SETTLED_EXTRA
                for want in moving.WANTS:
                    ref = moving._from_coefs(coefs, Z, want)
                    exact = None
                    if K > 8 and window == 5 and alpha > 0:
                        exact = torch.as_tensor(_ridge_exact(
                            Z.cpu().numpy(), vn, rows, window, min_periods, alpha, positional, want
                        ))
                        short["plain_vs_exact"] = max(short["plain_vs_exact"], _max_abs_diff(ref, exact, rows))
                    for chunk in (None, 32, 2):
                        out = moving.rolling_ols(
                            Z, v, rows_t, window, min_periods, alpha, positional, want=want, chunk=chunk
                        )
                        if exact is None:
                            d = _moving_diff(out, ref, rows, settled)
                        else:  # the plain version's NaN pattern, the long-double answer's values
                            _moving_diff(out, ref, rows, np.zeros(vn.shape, dtype=bool))
                            d = _moving_diff(out, exact, rows)
                            short["kernel_vs_exact"] = max(short["kernel_vs_exact"], d)
                            short["kernel_vs_plain"] = max(short["kernel_vs_plain"], _max_abs_diff(out, ref, rows))
                        worst = max(worst, d)
                        cases += 1
    torch.cuda.synchronize()
    print(
        f"kernel moving: {cases} cases (rls / rolling x K 5..160 x coefficients / predictions x "
        f"rows a range) equal their plain versions at {MOVING_KERNEL_TOL}, equal NaN patterns, "
        f"max_abs_err={worst!r}; flagged rows re-solved by eigh: {moving.moving_flagged_rows}"
    )
    print(
        "kernel moving, the shared form's ridge windows of 5 rows (K = 9 .. 160; condition ~1e4): the kernel within "
        f"{MOVING_KERNEL_TOL} of each window solved in long double; max abs differences {json.dumps(short)} "
        "(the plain version's and the kernel's own rounding: neither pair is held to the tolerance "
        "against the other, which predictions near zero can pass)"
    )
    return cases, worst


def _moving_kernel_bound(args, counts, K, model, torch):
    """``_moving_bound`` of one moving-kernel launch on these inputs: the
    group's own rows, their valid, refresh and leaving rows; beside it
    (``bound_rank1_ms``) the bound of the same function without a fresh
    factorisation a solved row."""
    Z, v, rows_t, refresh, leaving = args[:5]
    live = torch.arange(Z.shape[1], device=Z.device) < rows_t[:, None]
    n_refresh = int((refresh & live).sum())
    n_leaving = 0 if leaving is None else int(((leaving >= 0) & live).sum())
    counted = (int(counts.sum()), int((v & live).sum()), n_refresh, n_leaving, K, model == "rolling",
               model == "rls", False, len(counts))
    return {**_moving_bound(*counted), "bound_rank1_ms": _moving_bound(*counted, fresh=False)["bound_ms"]}


def _moving_shape(moving, Z, counts, rolling, dev):
    """The planner's cut of a frame for the moving kernel's predictions:
    rows a lane (T), rows a range, the ranges of the groups longer than
    that, and the warps the card holds."""
    K = Z.shape[2] - 1
    T = moving.stretch_rows(K, rolling)
    resident = moving._resident_warps(dev, K, rolling, T, False)
    plan = moving.plan_ranges(counts, moving.plan_unit(K, rolling, T), resident, None, moving.plan_waves(K))
    return {
        "stretch_rows": T, "range_rows": plan.L, "long_groups": len(plan.grp_seg) - 1,
        "ranges_of_long_groups": plan.M, "resident_warps": resident,
        "walker_threads": moving.shared_layout(K, rolling, T)[2],
    }


def _skewed_counts(rng, n_rows, n_groups, sigma, cap):
    """Group sizes from a lognormal (sigma), scaled so that, capped at
    ``cap``, they hold ``n_rows`` rows in all."""
    raw = rng.lognormal(0.0, sigma, n_groups)
    lo, hi = 0.0, 100.0 * n_rows / raw.sum()
    for _ in range(200):
        mid = (lo + hi) / 2
        if np.minimum(raw * mid, cap).sum() < n_rows:
            lo = mid
        else:
            hi = mid
    counts = np.minimum(np.floor(raw * hi), cap).astype(np.int64)
    short = n_rows - int(counts.sum())
    counts[np.flatnonzero(counts < cap)[:short]] += 1
    if counts.sum() != n_rows or counts.max() > cap:
        raise AssertionError(f"skewed sizes: {counts.sum()} rows, longest {counts.max()}")
    return counts


def main_frame_counts():
    """The main frame's group sizes: main()'s draws of seed 0 (x, y, then
    the group of each row), without the frame."""
    rng = np.random.default_rng(0)
    rng.normal(size=(N_ROWS, N_FEATURES))
    rng.normal(size=N_ROWS)
    return np.bincount(rng.integers(N_GROUPS, size=N_ROWS), minlength=N_GROUPS).astype(np.int64)


def largek_counts():
    """The group sizes of "grouped_largek" (_suite_frame's draws of seed 0
    at LARGEK_SHAPE), without the frame."""
    n, k, groups = LARGEK_SHAPE
    rng = np.random.default_rng(0)
    rng.normal(size=(n, k))
    rng.normal(size=n)
    rng.normal(size=k)
    rng.normal(size=n)
    rng.random(n)
    return np.bincount(rng.integers(groups, size=n), minlength=groups).astype(np.int64)


def _moving_args(counts, R, K, rolling, ff, torch, seed):
    """model -> the moving kernel's arguments (``ops/moving.py:_launch``'s
    before ``want``) on a frame of random rows made on the card from
    ``seed``, in groups of ``counts`` rows padded to R: rls (half-life
    HALF_LIFE, prior variance 10) and rolling (WINDOW rows, positional)."""
    dev = torch.device("cuda")
    G = len(counts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows_t = torch.as_tensor(counts, device=dev)
    live = torch.arange(R, device=dev) < rows_t[:, None]
    X = torch.randn((G, R, K), generator=gen, device=dev, dtype=torch.float64)
    y = X.sum(-1) + 0.1 * torch.randn((G, R), generator=gen, device=dev, dtype=torch.float64)
    Z = torch.where(live[..., None], torch.cat([y[..., None], X], dim=-1), 0.0).contiguous()
    del X, y
    v = live.contiguous()
    idx = rolling.rolling_indices(v, WINDOW, K, True)
    zero = [0.0] * K
    return {
        "rls": (Z, v, rows_t, v, None, False, ff, 0.1, zero),
        "rolling": (Z, v, rows_t, idx[1].contiguous(), idx[0].contiguous(), True, 1.0, 0.0, zero),
    }


# the shared form's phases: its walk stopped after the update, the LDL'
# and the back substitution, and the whole walk (``pols_moving``'s phase)
MOVING_PHASES = {"update": 1, "ldl": 2, "back_substitution": 3, "all": 0}


def _moving_phases(label, counts, args, moving, torch, smi):
    """Device ms per launch of the shared form's predictions stopped after
    each of MOVING_PHASES, in turns, for each model of ``args``
    (``_moving_args``): the update, the factorisation and the back
    substitution apart. Returns {model: {phase: ms}}."""
    out = {}
    for model, a in args.items():
        times = _in_turns({
            name: (lambda a=a, ph=ph: moving._launch_kernels(*a, "predictions", None, counts, None, ph))
            for name, ph in MOVING_PHASES.items()
        }, 1, torch)
        out[model] = {name: t[0] for name, t in times.items()}
        print(f"kernel moving phases, {model} on the {label} frame (K={len(a[8])}): ms per launch "
              f"{json.dumps(out[model])} ({smi})")
    return out


def _moving_frame(label, counts, R, K, n_checked, moving, recursive, rolling, ff, torch, smi, seed,
                  sweep=None, phases=False):
    """The moving kernel on a frame of random rows (made on the card from
    ``seed``) in groups of ``counts`` rows padded to R: rls and rolling
    against their plain versions on ``n_checked`` groups (all where that is
    every group; else the longest half of them and the first others),
    timed per launch beside the plain version's one call on those groups,
    with the bound, and in turns with each shape of ``sweep`` (label ->
    rows a range, rows a lane; None: the planner's); with ``phases``
    also the shared form's phases (``_moving_phases``). Returns the
    kernels-line fields of each model."""
    dev = torch.device("cuda")
    G = len(counts)
    args = _moving_args(counts, R, K, rolling, ff, torch, seed)
    Z, v = args["rls"][:2]
    if n_checked >= G:
        sel = np.arange(G)
    else:
        longest = np.argsort(counts, kind="stable")[-(n_checked // 2):]
        sel = np.unique(np.concatenate([longest, np.arange(n_checked - len(longest))]))
    sel_t = torch.as_tensor(sel, device=dev)
    Zs, vs = Z[sel_t], v[sel_t]
    plain = {
        "rls": lambda: recursive.solve_recursive_least_squares(Zs[..., 1:], Zs[..., 0], vs, HALF_LIFE),
        "rolling": lambda: rolling.solve_rolling_ols(Zs[..., 1:], Zs[..., 0], vs, WINDOW, None, 0.0, True),
    }
    settled = {"rls": None, "rolling": _window_counts(vs.cpu().numpy(), WINDOW, True) >= K + SETTLED_EXTRA}
    n_launches = MOVING_LAUNCHES if K <= 8 else 1
    phase_ms = _moving_phases(label, counts, args, moving, torch, smi) if phases else {}
    fields = {}
    for model, a in args.items():
        out = moving._launch(*a, "coefficients", None, counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain[model]()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _moving_diff(out[sel_t], ref, counts[sel], settled[model])
        del out, ref
        fns = {"kernel": lambda a=a: moving._launch_kernels(*a, "predictions", None, counts)}
        for shape, (L, T) in (sweep or {}).items():
            fns[shape] = lambda a=a, L=L, T=T: moving._launch_kernels(*a, "predictions", L, counts, T)
        times = _in_turns(fns, n_launches, torch)
        t = times["kernel"]
        fields[model] = {
            "ms": t[0], "host_us": t[1], "plain_ms": plain_ms, "plain_groups": len(sel),
            **({"sweep_ms": {shape: times[shape][0] for shape in sweep}} if sweep else {}),
            **({"phases_ms": phase_ms[model]} if phases else {}),
            "max_abs_err": err, **_moving_kernel_bound(a, counts, K, model, torch),
            **_moving_shape(moving, Z, counts, model == "rolling", dev),
        }
        print(
            f"kernel moving {model} on the {label} frame: padded [{G}, {R}, {K + 1}], "
            f"{int(counts.sum())} rows, longest group {int(counts.max())}; "
            f"{json.dumps(fields[model])} (ms per launch of the predictions; plain_ms: one call on "
            f"{len(sel)} groups, host syncs inside; max_abs_err on the coefficients of those groups) "
            f"({smi})"
        )
    return fields


def _closed_form_discounted(X, y, v, ff, c, t):
    """The RLS coefficient after row t in closed form: the discounted normal
    equations over the valid rows up to t, with the prior I / c discounted
    by all of them."""
    idx = np.flatnonzero(v[: t + 1])
    wgt = ff ** np.arange(len(idx) - 1, -1, -1, dtype=np.float64)
    Xw = X[idx] * wgt[:, None]
    A = Xw.T @ X[idx] + (ff ** len(idx) / c) * np.eye(X.shape[1])
    return np.linalg.solve(A, Xw.T @ y[idx])


def _cd_numpy(XtX, Xty, n, alpha, l1_ratio, positive=False, active_set=False,
              max_iter=1000, tol=1e-5):
    """A literal covariance-form cyclic coordinate descent of one group (the
    reference's src/least_squares.rs:386-492 on the moments)."""
    K = len(Xty)
    a = alpha * max(n, 1.0)
    a_l1, a_l2 = a * l1_ratio, a * (1.0 - l1_ratio)
    w = np.zeros(K)
    active = np.ones(K, dtype=bool)
    for _ in range(max_iter):
        w_old = w.copy()
        for j in range(K):
            rho = Xty[j] - XtX[j] @ w + XtX[j, j] * w[j]
            wj = np.sign(rho) * max(abs(rho) - a_l1, 0.0)
            if positive:
                wj = max(wj, 0.0)
            d = XtX[j, j] + a_l2
            wj = wj / (d if d > 0 else 1.0)
            if active_set:
                wj = wj if active[j] else w[j]
                active[j] = active[j] and abs(wj) >= tol
            w[j] = wj
        if np.linalg.norm(w - w_old) < tol:
            break
    return w


def _stats_numpy(X, y, alpha, beta=None):
    """numpy statistics of one group (tests/oracles.py:ols_statistics /
    ridge_statistics): coefficients, r2 / mae / mse of ``beta`` (default
    the normal-equation or lstsq solution), se / t / p from the normal
    equations with df = n - tr((X'X + alpha I)^-1) when alpha > 0, else
    n - K, and p = 2 sf(|t|)."""
    from scipy import stats

    n, k = X.shape
    A_inv = np.linalg.inv(X.T @ X + alpha * np.eye(k))
    beta_ne = _lstsq(X, y) if alpha == 0 else A_inv @ (X.T @ y)
    beta = beta_ne if beta is None else beta
    r_ne = y - X @ beta_ne
    df = n - (float(np.trace(A_inv)) if alpha > 0 else k)
    se = np.sqrt(float(r_ne @ r_ne) / df * np.abs(np.diag(A_inv)))
    t = (A_inv @ (X.T @ y)) / se
    r = y - X @ beta
    return {
        "coefficients": beta,
        "standard_errors": se,
        "t_values": t,
        "p_values": 2.0 * stats.t.sf(np.abs(t), df),
        "r2": 1.0 - float(r @ r) / float(((y - y.mean()) ** 2).sum()),
        "mse": float(r @ r) / n,
        "mae": float(np.abs(r).sum()) / n,
    }


# the reference suite's two wide configurations (benchmarks/suite.py:274-288,
# its frame _make_df :67), not cut in size: "large", one group of 10,000 rows
# x 100 features, and "grouped_largek", 500,000 rows x 40 features x 1,000
# groups; the latter also with the multi-target fault query (40 seeded
# targets on 3 features: blocks of 43 columns)
FRAME_DROPPED = 3.0  # the group the frame workflow filters out before its fits
FRAME_PROFILE_QUERIES = 1  # profiled queries a frame step (each is host-heavy)
FRAME_TOL = dict(rtol=1e-12, atol=1e-12)  # frame aggregations against numpy
STAT_FIELDS = ["feature_names", "coefficients", "standard_errors", "t_values", "p_values"]


def frame_steps(pt, df):
    """The reference suite's workflow (tests/test_ols.py) on ``df`` (``y``,
    features ``x1 ..``, ``group``) through the public API: an ordered
    {step: fn(outputs of the steps before it) -> frame}. The features are
    the selector ``starts_with("x")``."""
    col = pt.col
    feats = pt.selectors.starts_with("x")
    coef = col("y").least_squares.ols(feats, mode="coefficients")
    kept = col("group") != FRAME_DROPPED
    return {
        "lazy": lambda o: (
            df.lazy().filter(kept).with_row_index()
            .with_columns(coef.over("group"), col("y").least_squares.ols(feats).over("group").alias("pred"))
            .with_columns(((col("y") - col("pred")) / (col("x1") * col("x1") + 1.0)).alias("scaled"))
            .collect()
        ),
        "agg": lambda o: o["lazy"].group_by("group").agg(
            col("y").mean().alias("y_mean"), col("y").std().alias("y_std"), col("y").count().alias("n"),
            col("coefficients"),
        ),
        "last": lambda o: o["lazy"].group_by("group").last(),
        "unique": lambda o: df.filter(kept).select("group", coef.over("group")).unique(),
        "join_predict": lambda o: df.join(o["unique"], on="group", how="left").select(
            "group", col("coefficients").least_squares.predict(feats, name="p"),
        ),
        "sort": lambda o: o["lazy"].sort(["group", "index"], descending=[True, False]),
        "explode": lambda o: (
            df.select("group", col("y").least_squares.ols(feats, mode="statistics").over("group"))
            .unique().unnest("statistics").explode(STAT_FIELDS)
        ),
    }


def run_frame_steps(pt, df):
    """{step: output frame} of one pass of ``frame_steps``."""
    out = {}
    for step, fn in frame_steps(pt, df).items():
        out[step] = fn(out)
    return out


def frame_value_devices(frame):
    """The device types of a frame's value tensors (object columns, which
    live on the host by design, left out)."""
    kinds = set()
    for c in frame._columns.values():
        for t in (getattr(c, "_values", None), getattr(c, "validity", None)):
            t = getattr(t, "flat", t)
            if hasattr(t, "device"):
                kinds.add(t.device.type)
        if type(c).__name__ == "StructSeries":
            kinds.add(c.values.device.type)
        if type(c).__name__ == "StatisticsSeries":
            kinds.update(v.device.type for v in c.arrays.values())
    return kinds


def _check_frame(out, x, y, g, checked, device="cuda"):
    """Every step of the frame workflow against numpy: row selections and
    orders exactly, aggregations at FRAME_TOL, fits at the main path's
    tolerances on the sampled groups, every value column on ``device``.
    Returns {step: shape}."""
    keep = g != FRAME_DROPPED
    kept = np.flatnonzero(keep)
    gk = g[keep].astype(np.int64)
    lazy = out["lazy"]
    if lazy.height != len(kept):
        raise AssertionError(f"frame lazy: {lazy.height} rows, expected {len(kept)}")
    np.testing.assert_array_equal(lazy["index"].to_numpy(), np.arange(len(kept), dtype=float))
    np.testing.assert_array_equal(lazy["y"].to_numpy(), y[kept])
    np.testing.assert_array_equal(lazy["group"].to_numpy(), g[kept])
    coefs = lazy["coefficients"].to_numpy()
    pred = lazy["pred"].to_numpy()
    x1 = x[kept, 0]
    np.testing.assert_allclose(lazy["scaled"].to_numpy(), (y[kept] - pred) / (x1 * x1 + 1.0), rtol=1e-14, atol=0)
    groups = [k for k in checked if k != int(FRAME_DROPPED)]
    xk = x[kept]
    for _, rows, beta in _groupwise_lstsq(xk, y[kept], gk, groups):
        np.testing.assert_allclose(coefs[rows[0]], beta, **COEF_TOL)
        np.testing.assert_allclose(pred[rows], xk[rows] @ beta, **PRED_TOL)
    # group_by: one row per group in sorted key order
    keys, first_pos, counts = np.unique(gk, return_index=True, return_counts=True)
    agg = out["agg"]
    np.testing.assert_array_equal(agg["group"].to_numpy(), keys.astype(float))
    dense = np.searchsorted(keys, gk)
    mean = np.bincount(dense, y[kept]) / counts
    std = np.sqrt(np.bincount(dense, (y[kept] - mean[dense]) ** 2) / (counts - 1))
    np.testing.assert_allclose(agg["y_mean"].to_numpy(), mean, **FRAME_TOL)
    np.testing.assert_allclose(agg["y_std"].to_numpy(), std, **FRAME_TOL)
    np.testing.assert_array_equal(agg["n"].to_numpy(), counts.astype(float))
    np.testing.assert_array_equal(agg["coefficients"].to_numpy(), coefs[first_pos])
    order = np.argsort(gk, kind="stable")
    last_pos = order[np.cumsum(counts) - 1]
    np.testing.assert_array_equal(out["last"]["index"].to_numpy(), last_pos.astype(float))
    # unique: one row per kept group, in the order of first appearance
    uniq = out["unique"]
    appear = np.sort(first_pos)
    np.testing.assert_array_equal(uniq["group"].to_numpy(), g[kept][appear])
    ucoef = uniq["coefficients"].to_numpy()
    np.testing.assert_allclose(ucoef, coefs[appear], **COEF_TOL)
    # join then predict: NaN exactly on the dropped group
    jp = out["join_predict"]
    np.testing.assert_array_equal(jp["group"].to_numpy(), g)
    p = jp["p"].to_numpy()
    if not (np.isnan(p[~keep]).all() and np.isfinite(p[keep]).all()):
        raise AssertionError("frame join_predict: NaN predictions are not exactly the dropped group's rows")
    np.testing.assert_allclose(p[kept], pred, **PRED_TOL)
    # sort: group descending, index ascending
    order = np.lexsort((np.arange(len(kept)), -g[kept]))
    srt = out["sort"]
    np.testing.assert_array_equal(srt["index"].to_numpy(), order.astype(float))
    np.testing.assert_array_equal(srt["group"].to_numpy(), g[kept][order])
    # statistics, one row per group in the order of first appearance, exploded
    ex = out["explode"]
    K = x.shape[1]
    all_keys, all_first = np.unique(g.astype(np.int64), return_index=True)
    groups_in_order = g[np.sort(all_first)].astype(np.int64)
    if ex.height != len(all_keys) * K:
        raise AssertionError(f"frame explode: {ex.height} rows, expected {len(all_keys) * K}")
    if ex["feature_names"].to_list()[: 2 * K] != [f"x{i + 1}" for i in range(K)] * 2:
        raise AssertionError("frame explode: feature names out of order")
    ecoef = ex["coefficients"].to_numpy().reshape(-1, K)
    at = {int(k): i for i, k in enumerate(groups_in_order)}
    for k, _, beta in _groupwise_lstsq(x, y, g.astype(np.int64), checked):
        np.testing.assert_allclose(ecoef[at[int(k)]], beta, **COEF_TOL)
    for step, frame in out.items():
        kinds = frame_value_devices(frame)
        if kinds != {device}:
            raise AssertionError(f"frame {step}: value columns on {sorted(kinds)}, not only {device}")
    return {step: frame.shape for step, frame in out.items()}


def _frame_phase(pt, torch, smi, columns, x, y, g, checked, mods):
    """The frame substrate at the main frame (``columns``: y, x1 .. on the
    card; ``g`` the host group keys): the reference suite's workflow
    (frame_steps) through the public API, every step checked against numpy
    (_check_frame), timed (median of TIMING_REPS after a warm call) and
    profiled; then warmup() at the main frame's shape, twice, and trace()
    around one query, whose file must hold CUDA kernel events. Returns the
    kernel launches of the workflow's first pass."""
    from polars_ols_tpu_torch.utils import trace

    moments, special, cd, householder, jacobi, moving = mods
    col = pt.col
    fdf = pt.DataFrame({**columns, "group": g})
    counters = {
        "grouped_moments": (moments, "moments_kernel_launches"),
        "t_pvalue": (special, "t_pvalue_kernel_launches"),
        "cd_cov": (cd, "cd_kernel_launches"),
        "householder": (householder, "householder_kernel_launches"),
        "jacobi_svd": (jacobi, "jacobi_kernel_launches"),
        "moving": (moving, "moving_kernel_launches"),
    }
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    frame_out = run_frame_steps(pt, fdf)
    torch.cuda.synchronize()
    frame_first_s = time.perf_counter() - t0
    frame_launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if frame_launches["grouped_moments"] == 0 or frame_launches["t_pvalue"] == 0:
        raise AssertionError(f"frame workflow: kernel launches {frame_launches}")
    frame_shapes = _check_frame(frame_out, x, y, g, checked)
    print(
        f"frame: {len(frame_shapes)} steps at {N_ROWS} rows x {N_FEATURES} features x {N_GROUPS} groups "
        f"(group {FRAME_DROPPED} filtered out), shapes {json.dumps(frame_shapes)}, every value column on "
        f"cuda, each step matches numpy (orders exactly, aggregations at {FRAME_TOL}, fits at {COEF_TOL} on "
        f"{N_CHECK_GROUPS} groups); first pass {frame_first_s!r} s, kernel launches {json.dumps(frame_launches)}"
    )
    for step, fn in frame_steps(pt, fdf).items():
        def call(fn=fn):
            return fn(frame_out)

        med = _timed_median(call, torch)
        prof = _profile(call, torch, queries=FRAME_PROFILE_QUERIES, warm=False)
        if prof is None:
            print(f"frame {step}: wall median {med * 1e3!r} ms; profile not measured ({smi})")
            continue
        print(
            f"frame {step}: wall median {med * 1e3!r} ms ({TIMING_REPS} after a warm call); device busy "
            f"{prof['busy_ms']!r} ms, {prof['launches']!r} launches, {prof['host_syncs']!r} host syncs a "
            f"call ({FRAME_PROFILE_QUERIES} profiled; idle share <= {prof['idle_share']!r}) ({smi})"
        )
    del frame_out
    t0 = time.perf_counter()
    warm_1 = pt.warmup(N_ROWS, N_FEATURES, n_groups=N_GROUPS)
    warm_1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_2 = pt.warmup(N_ROWS, N_FEATURES, n_groups=N_GROUPS)
    warm_2_s = time.perf_counter() - t0
    print(
        f"warmup({N_ROWS}, {N_FEATURES}, n_groups={N_GROUPS}): first call {warm_1_s!r} s "
        f"{json.dumps(warm_1)}; second call at the same shape {warm_2_s!r} s {json.dumps(warm_2)} ({smi})"
    )
    trace_dir = Path(__file__).resolve().parent / "chiprun_out" / "frame_trace"
    with trace(str(trace_dir)):
        fdf.select(col("y").least_squares.ols(pt.selectors.starts_with("x")).over("group"))
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"trace: {trace_dir / 'trace.json'} holds no CUDA kernel events")
    launched = sum(e.get("name") in ("cudaLaunchKernel", "cuLaunchKernel") for e in events)
    own = sorted({k.split("(")[0] for k in kernels if "at::" not in k})
    print(
        f"trace: {trace_dir / 'trace.json'} holds {len(kernels)} CUDA kernel events of "
        f"{len(set(kernels))} kernels for {launched} launch calls; the port's own: {own or 'none recorded'}"
    )
    return frame_launches


FUSED_ALPHAS = (1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0)  # the sweep's ridge alphas, beside ols
FUSED_LASSO_ALPHA = 1e-3
FUSED_TOL = 1e-12  # fused against eager, every column (tests/test_fused_select.py:32-50)
FUSED_LARGE = ("ols_qr", "ols_svd", "ridge_chol", "ridge_svd", "wls", "ols", "statistics")
FUSED_COLLINEAR, FUSED_ILL = 0, 1  # the flagged frame's groups: x5 = x4, and x5 = x4 + 1e-5 noise
FUSED_ILL_NOISE = 1e-5
FUSED_PROFILE_QUERIES = 2  # profiled selects of each (a mixed select launches ~1,000 kernels)
# host syncs a fused select on the common path: its one read, and the
# profile window's own untraced one spread over its selects
FUSED_SYNCS = 1.0 + 1.0 / FUSED_PROFILE_QUERIES


def fused_selects(pt, k, key="group"):
    """{name: expressions} of the fused select's phase on a frame with y,
    y2, w, x1..xk, the nulled copies yn, x1n..xkn and the key column:
    "sweep", ols and ridge at FUSED_ALPHAS, predictions under .over; and
    "mixed", the JAX suite's mix (tests/test_fused_select.py) at this
    width, with a fit on the nulled columns under 'drop' and a multi-target
    fit (which runs eagerly in its place)."""
    col = pt.col
    xv = [col(f"x{i + 1}") for i in range(k)]
    xn = [col(f"x{i + 1}n") for i in range(k)]
    ls = col("y").least_squares
    sweep = [ls.ols(*xv).over(key).alias("ols")] + [
        ls.ridge(*xv, alpha=a).over(key).alias(f"ridge_{a!r}") for a in FUSED_ALPHAS
    ]
    mixed = [
        col(key),
        ls.ols(*xv).over(key).alias("ols"),
        ls.wls(*xv, sample_weights="w").over(key).alias("wls"),
        ls.ridge(*xv, alpha=RIDGE_ALPHA, mode="residuals").over(key).alias("ridge_residuals"),
        ls.ols(*xv, mode="coefficients").over(key),
        ls.ols(*xv, mode="statistics").over(key),
        ls.lasso(*xv, alpha=FUSED_LASSO_ALPHA).over(key).alias("lasso"),
        ls.rls(*xv, half_life=HALF_LIFE).over(key).alias("rls"),
        ls.rolling_ols(*xv, window_size=WINDOW).over(key).alias("rolling"),
        col("yn").least_squares.ols(*xn, null_policy="drop").over(key).alias("drop"),
        pt.struct(col("y"), col("y2")).least_squares.multi_target_ols(*xv).over(key).alias("multi_target"),
    ]
    return {"sweep": sweep, "mixed": mixed}


def flagged_x5(x, g, seed=12):
    """x5 of the flagged frame: x4 in group FUSED_COLLINEAR (its Cholesky
    fails at alpha 0: the eigh solve of the failed lanes) and x4 plus
    FUSED_ILL_NOISE noise in group FUSED_ILL (cond(X'X) > 1e6: the CSNE
    sweeps)."""
    x5 = x[:, 4].copy()
    collinear, ill = g == FUSED_COLLINEAR, g == FUSED_ILL
    x5[collinear] = x[collinear, 3]
    x5[ill] = x[ill, 3] + FUSED_ILL_NOISE * np.random.default_rng(seed).normal(size=int(ill.sum()))
    return x5


def fused_fields(c):
    """{field: (values, valid)} device tensors of a result column."""
    if hasattr(c, "arrays"):  # statistics: NaN where a group has no finite factor
        return {key: (v, ~v.isnan()) for key, v in c.arrays.items()}
    if hasattr(c, "field_names"):  # struct
        return {"": (c.values, c.values == c.values if c.validity is None else c.validity)}
    return {"": (c.f64(), c.valid_mask())}


def fused_diff(fused, eager) -> float:
    """The largest |fused - eager| over every column and field where valid;
    raises where the names, shapes or nulls differ."""
    import torch

    if fused.columns != eager.columns:
        raise AssertionError(f"fused columns {fused.columns} != eager {eager.columns}")
    worst = 0.0
    for name in fused.columns:
        a, b = fused_fields(fused[name]), fused_fields(eager[name])
        if a.keys() != b.keys():
            raise AssertionError(f"{name}: fields {list(a)} != {list(b)}")
        for key in a:
            (av, am), (bv, bm) = a[key], b[key]
            if av.shape != bv.shape or not torch.equal(am, bm):
                raise AssertionError(f"{name} {key}: shapes or nulls differ between fused and eager")
            if am.any():
                worst = max(worst, float((av[am] - bv[am]).abs().max()))
    return worst


def _fused_numpy(label, out, x, y, y2, w, valid, group_rows, sel, first_t):
    """The selects' columns on the sampled groups against numpy: lstsq and
    ridge solves (predictions PRED_TOL, coefficients COEF_TOL), the
    weighted and 'drop' fits, the residuals, statistics against
    scipy.stats.t, the lasso against a literal numpy CD (CD_TOL) and the
    multi-target fit per target. rls / rolling are held to fused == eager
    here; the moving phase holds the eager queries to their oracles."""
    host = {c: _picked(out[c], sel) for c in out.columns
            if c not in ("statistics", "group", "rls", "rolling")}
    stats = None
    if "statistics" in out.columns:
        stats = {key: v.cpu().numpy() for key, v in out["statistics"].gather(first_t).arrays.items()}
    at = 0
    for i, (_, rows) in enumerate(group_rows):
        here = slice(at, at + len(rows))
        at += len(rows)
        Xg, yg = x[rows], y[rows]
        XtX, Xty = Xg.T @ Xg, Xg.T @ yg
        for c, got in host.items():
            got = got[here]
            if c == "ols":
                want = Xg @ _lstsq(Xg, yg)
            elif c.startswith("ridge_") and c != "ridge_residuals":
                want = Xg @ np.linalg.solve(XtX + float(c[6:]) * np.eye(Xg.shape[1]), Xty)
            elif c == "ridge_residuals":
                want = yg - Xg @ np.linalg.solve(XtX + RIDGE_ALPHA * np.eye(Xg.shape[1]), Xty)
            elif c == "wls":
                sq = np.sqrt(w[rows])
                want = Xg @ _lstsq(Xg * sq[:, None], yg * sq)
            elif c == "coefficients":
                np.testing.assert_allclose(got[0], _lstsq(Xg, yg), err_msg=f"{label} {c}", **COEF_TOL)
                continue
            elif c == "lasso":
                want = Xg @ _cd_numpy(XtX, Xty, float(len(rows)), FUSED_LASSO_ALPHA, 1.0)
                np.testing.assert_allclose(got, want, err_msg=f"{label} {c}", **CD_TOL)
                continue
            elif c == "drop":
                _, want, shown = _policy_expected("drop", Xg, yg, valid[rows, 1:], valid[rows, 0])
                np.testing.assert_array_equal(np.isnan(got), ~shown, err_msg=f"{label} {c}")
                got, want = got[shown], want[shown]
            elif c == "multi_target":
                Yg = np.stack([yg, y2[rows]], axis=1)
                want = Xg @ _lstsq(Xg, Yg)
            else:
                raise AssertionError(f"{label}: no numpy reference for column {c}")
            np.testing.assert_allclose(got, want, err_msg=f"{label} {c}", **PRED_TOL)
        if stats is not None:
            ref = _stats_numpy(Xg, yg, 0.0)
            np.testing.assert_allclose(stats["coefficients"][i], ref["coefficients"], **COEF_TOL)
            for key in ("standard_errors", "t_values"):
                np.testing.assert_allclose(stats[key][i], ref[key], err_msg=f"{label} {key}", **SE_T_TOL)
            np.testing.assert_allclose(stats["p_values"][i], ref["p_values"], **P_TOL)
            for key in ("r2", "mse", "mae"):
                np.testing.assert_allclose(stats[key][i], ref[key], err_msg=f"{label} {key}", **METRIC_TOL)


def _fused_phase(pt, torch, smi, df, arrays, checked, mods):
    """The fused select (engine/batch.py) at the main frame and at "large":
    the sweep, the mix, the sweep on a frame with a collinear and an
    ill-conditioned group ("flagged"), and the suite's seven "large"
    queries in one select. For each, fused beside eager: every column
    within FUSED_TOL with identical nulls, sampled groups against numpy,
    moment-kernel launches, wall ms (median of TIMING_REPS after a warm
    call) and the profile's device busy ms, launches and host syncs; the
    gathers of a repeated mixed select. Returns the kernels' launches of
    the fused selects' first pass."""
    from polars_ols_tpu_torch import CONFIG
    from polars_ols_tpu_torch.engine import batch, fit

    moments, special, cd, householder, jacobi, moving = mods
    counters = {
        "grouped_moments": (moments, "moments_kernel_launches"),
        "t_pvalue": (special, "t_pvalue_kernel_launches"),
        "cd_cov": (cd, "cd_kernel_launches"),
        "householder": (householder, "householder_kernel_launches"),
        "jacobi_svd": (jacobi, "jacobi_kernel_launches"),
        "moving": (moving, "moving_kernel_launches"),
    }
    x, y, y2, w, g, valid = (arrays[key] for key in ("x", "y", "y2", "w", "g", "valid"))
    col = pt.col
    t_phase = time.perf_counter()
    selects = fused_selects(pt, N_FEATURES)
    x5 = flagged_x5(x, g)
    df_flag = df.with_columns(pt.Series("x5", torch.as_tensor(x5, device="cuda")))
    x_flag = np.column_stack([x[:, :4], x5])
    large_df, xl, yl, _, wl, _ = _suite_frame(pt, torch, *LARGE_SHAPE)
    large_q = _wide_queries(pt, col, LARGE_SHAPE[1], False)
    large_exprs = [large_q[label][0].alias(label) for label in FUSED_LARGE]
    cases = {
        "sweep": (df, selects["sweep"]),
        "mixed": (df, selects["mixed"]),
        "flagged": (df_flag, selects["sweep"]),
        "large": (large_df, large_exprs),
    }
    CONFIG.lazy_row_order = False
    # the layout caches over a repeated mix, eager first (three partitions
    # and the multi-target's: more than the two a layout keeps of a kind;
    # a fused select holds its own while it runs)
    gathers = {}
    for key, on in (("eager", False), ("fused", True)):
        CONFIG.fused_select = on
        df.select(*selects["mixed"])
        fit.layout_gathers = 0
        df.select(*selects["mixed"])
        torch.cuda.synchronize()
        gathers[key] = fit.layout_gathers
    if gathers["fused"]:
        raise AssertionError(f"a repeated fused mix rebuilt {gathers['fused']} partitions")
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    batch.flag_reads = batch.flagged_plans = 0
    first_s = {}
    for label, (frame, exprs) in cases.items():
        t0 = time.perf_counter()
        frame.select(*exprs)
        torch.cuda.synchronize()
        first_s[label] = time.perf_counter() - t0
    fused_launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if batch.flag_reads != len(cases):
        raise AssertionError(f"fused selects read their flags {batch.flag_reads} times for {len(cases)} selects")
    if fused_launches["moving"] != 2 or fused_launches["cd_cov"] != 1:
        raise AssertionError(f"fused selects: kernel launches {fused_launches}")

    group_rows = _group_rows(g.astype(np.int64), checked)
    sel = torch.as_tensor(np.concatenate([rows for _, rows in group_rows]), device="cuda")
    first_t = torch.as_tensor(np.asarray([rows[0] for _, rows in group_rows]), device="cuda")
    special_rows = _group_rows(g.astype(np.int64), [FUSED_COLLINEAR, FUSED_ILL])
    report = {}
    for label, (frame, exprs) in cases.items():
        t_checks = time.perf_counter()
        row = {"first_s": first_s[label]}
        CONFIG.fused_select = False
        moments.moments_kernel_launches = 0
        eager = frame.select(*exprs)
        torch.cuda.synchronize()
        row["eager_moment_launches"] = moments.moments_kernel_launches
        CONFIG.fused_select = True
        moments.moments_kernel_launches = 0
        reads, flagged = batch.flag_reads, batch.flagged_plans
        fused = frame.select(*exprs)
        torch.cuda.synchronize()
        row["moment_launches"] = moments.moments_kernel_launches
        row["flagged_plans"] = batch.flagged_plans - flagged
        if batch.flag_reads != reads + 1:
            raise AssertionError(f"fused {label}: {batch.flag_reads - reads} flag reads, not one")
        row["max_abs_diff_eager"] = fused_diff(fused, eager)
        if row["max_abs_diff_eager"] > FUSED_TOL:
            raise AssertionError(f"fused {label}: {row['max_abs_diff_eager']!r} from eager (> {FUSED_TOL})")
        del eager
        if label == "large":
            stats = {key: v.cpu().numpy()[0] for key, v in fused["statistics"].arrays.items()}
            for c in FUSED_LARGE[:-1]:
                want = xl @ _wide_expected(c, xl, yl, wl)
                np.testing.assert_allclose(fused[c].to_numpy(), want, err_msg=f"fused large {c}", **PRED_TOL)
            ref = _stats_numpy(xl, yl, 0.0)
            for key, tol in (("coefficients", COEF_TOL), ("standard_errors", SE_T_TOL), ("t_values", SE_T_TOL),
                             ("p_values", P_TOL)):
                np.testing.assert_allclose(stats[key], ref[key], err_msg=f"fused large {key}", **tol)
        else:
            xs = x_flag if label == "flagged" else x
            _fused_numpy(label, fused, xs, y, y2, w, valid, group_rows, sel, first_t)
            if label == "flagged":  # the collinear and the ill-conditioned group
                sel_f = torch.as_tensor(np.concatenate([rows for _, rows in special_rows]), device="cuda")
                _fused_numpy(label, fused, xs, y, y2, w, valid, special_rows, sel_f, None)
        fn_f = lambda frame=frame, exprs=exprs: frame.select(*exprs)  # noqa: E731

        def fn_e(frame=frame, exprs=exprs):
            CONFIG.fused_select = False
            try:
                return frame.select(*exprs)
            finally:
                CONFIG.fused_select = True

        row["wall_ms"] = _timed_median(fn_f, torch) * 1e3
        row["eager_wall_ms"] = _timed_median(fn_e, torch) * 1e3
        for key, fn in (("", fn_f), ("eager_", fn_e)):
            prof = _profile(fn, torch, queries=FUSED_PROFILE_QUERIES)
            if prof is None:
                row[f"{key}profile"] = "not measured"
                continue
            row.update({f"{key}busy_ms": prof["busy_ms"], f"{key}launches": prof["launches"],
                        f"{key}host_syncs": prof["host_syncs"], f"{key}idle_share_max": prof["idle_share"]})
        row["checks_s"] = time.perf_counter() - t_checks
        report[label] = row
        del fused
    for label in ("sweep", "flagged"):
        if report[label]["moment_launches"] != 1 or report[label]["eager_moment_launches"] != 1 + len(FUSED_ALPHAS):
            raise AssertionError(f"fused {label}: moment launches {report[label]}")
    for label in ("sweep", "mixed", "large"):
        syncs = report[label].get("host_syncs")
        if report[label]["flagged_plans"] or (syncs is not None and syncs > FUSED_SYNCS):
            raise AssertionError(f"fused {label}: the common path read the host more than once: {report[label]}")
    if not report["flagged"]["flagged_plans"]:
        raise AssertionError("fused flagged: no plan took the eigh or CSNE continuation")
    for label, row in report.items():
        print(f"fused {label}: " + json.dumps(row) + f" ({smi})")
    print(
        f"fused: {len(cases)} selects ({', '.join(cases)}) at {N_ROWS} rows x {N_FEATURES} features x "
        f"{N_GROUPS} groups and at large {LARGE_SHAPE[:2]}; fused equals eager within {FUSED_TOL} with identical "
        f"nulls, {N_CHECK_GROUPS} sampled groups (and the flagged frame's two) match numpy; one flag read a "
        f"select; kernel launches of the first pass {json.dumps(fused_launches)}; partitions rebuilt by a "
        f"repeated mix {json.dumps(gathers)}; phase {time.perf_counter() - t_phase:.1f} s ({smi})"
    )
    del df_flag, large_df
    return fused_launches


SHARDED_SHARDS = 4  # virtual shards of the one card (CONFIG.virtual_devices)
SHARDED_TOL = dict(rtol=1e-8, atol=1e-10)  # sharded against one device (tests/test_autoshard.py)
SHARDED_P_TOL = dict(rtol=1e-6, atol=1e-12)
SHARDED_REPS = 3  # timed queries each way, after the first
SHARDED_PROFILE_QUERIES = 1
SHARDED_COLLINEAR_NOISE = 1e-5  # the near-collinear case (cond(X'X) past 1e6: the CSNE sweeps)
# the port's kernels of the main query (csrc/moments.cu), which a Chrome
# trace names "void (anonymous namespace)::block_moments<...>(...)" and
# "(anonymous namespace)::group_sums(...)"
PORT_TRACE_KERNELS = ("block_moments", "group_sums")


def sharded_queries(pt, k, key="group"):
    """{label: (expression, output column)} of the sharded phase on a frame
    with y, y2, w, x1..xk, the nulled yn, x1n..xkn and the key column: the
    families of tests/test_autoshard.py at the smoke's parameters,
    statistics (also by coordinate descent), coefficients, 'svd' and
    multi-target."""
    col = pt.col
    xv = [col(f"x{i + 1}") for i in range(k)]
    xn = [col(f"x{i + 1}n") for i in range(k)]
    ls = col("y").least_squares
    return {
        "ols": (ls.ols(*xv).over(key), "y"),
        "ols_lu": (ls.ols(*xv, solve_method="lu").over(key), "y"),
        "ols_nulls_drop": (col("yn").least_squares.ols(*xn, null_policy="drop").over(key), "yn"),
        "ridge": (ls.ridge(*xv, alpha=RIDGE_ALPHA).over(key), "y"),
        "wls": (ls.wls(*xv, sample_weights="w").over(key), "y"),
        "lasso": (ls.lasso(*xv, alpha=LASSO_ALPHA).over(key), "y"),
        "elastic_net": (ls.elastic_net(*xv, alpha=ENET_ALPHA, l1_ratio=0.5).over(key), "y"),
        "rls": (ls.rls(*xv, half_life=HALF_LIFE).over(key), "y"),
        "rolling": (ls.rolling_ols(*xv, window_size=WINDOW).over(key), "y"),
        "expanding": (ls.expanding_ols(*xv).over(key), "y"),
        "coefficients": (ls.ols(*xv, mode="coefficients").over(key), "coefficients"),
        "statistics": (ls.ols(*xv, mode="statistics").over(key), "statistics"),
        "lasso/statistics": (ls.lasso(*xv, alpha=LASSO_ALPHA, mode="statistics").over(key), "statistics"),
        "svd": (ls.ols(*xv, solve_method="svd").over(key), "y"),
        "multi_target": (
            pt.struct(col("y"), col("y2")).least_squares.multi_target_ols(*xv).over(key).alias("p"), "p"
        ),
    }


def _sharded_close(label, out, ref, settled, torch):
    """``out`` (sharded) against ``ref`` (one device), field by field on the
    card: the same nulls, values within SHARDED_TOL (p-values
    SHARDED_P_TOL); a moving model's values and NaN pattern from the row on
    where its group holds K + 3 rows (``settled``: a window with fewer rows
    than features is singular, and round-off picks its branch). Returns
    the largest |out - ref| compared."""
    a, b = fused_fields(out), fused_fields(ref)
    if a.keys() != b.keys():
        raise AssertionError(f"sharded {label}: fields {list(a)} != {list(b)}")
    moving = label in ("rls", "rolling", "expanding")
    worst = 0.0
    for key in a:
        (av, am), (bv, bm) = a[key], b[key]
        if av.shape != bv.shape:
            raise AssertionError(f"sharded {label} {key}: shape {tuple(av.shape)} != {tuple(bv.shape)}")
        if moving:
            am, bm = am & settled, bm & settled
        if not torch.equal(am, bm):
            raise AssertionError(f"sharded {label} {key}: nulls differ from one device")
        tol = SHARDED_P_TOL if key == "p_values" else SHARDED_TOL
        d = (av[am] - bv[am]).abs()
        if d.numel():
            bad = d > tol["atol"] + tol["rtol"] * bv[am].abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"sharded {label} {key}: {int(bad.sum())} values past {tol} of one device "
                    f"(largest difference {float(d.max())!r})"
                )
            worst = max(worst, float(d.max()))
    return worst


def _sharded_cases(pt, torch, sharded_mod):
    """The three cases of the JAX tests at their shapes, on SHARDED_SHARDS
    virtual shards of the card: one heavy group spanning every shard
    (tests/test_parallel.py:58-76) against numpy lstsq and one shard; the
    all-to-all shuffle (:218-250) against the host-built layout bit for
    bit; a near-collinear frame (tests/test_autoshard.py:154, noise
    SHARDED_COLLINEAR_NOISE) through the public API, which must take the
    CSNE sweeps and match numpy lstsq and the one-device result."""
    from polars_ols_tpu_torch import CONFIG
    from polars_ols_tpu_torch.parallel import fit_moments_sharded, make_mesh, shuffle_rows_to_groups

    dev = torch.device("cuda")
    out = {}
    rng = np.random.default_rng(1)
    n, k = 8_192, 4
    X = rng.normal(size=(n, k))
    gids = np.zeros(n, dtype=np.int64)
    gids[: n // 64] = np.arange(n // 64) % 7 + 1  # 7 tiny groups and 1 heavy one
    y = X.sum(1) + rng.normal(size=n) * 0.1
    args = [torch.as_tensor(a, device=dev) for a in (X, y, np.ones(n, dtype=bool), gids)]
    beta = fit_moments_sharded(make_mesh(SHARDED_SHARDS), *args, num_groups=8)[0].cpu().numpy()
    one = fit_moments_sharded(make_mesh(1), *args, num_groups=8)[0].cpu().numpy()
    for gi in range(8):
        m = gids == gi
        np.testing.assert_allclose(beta[gi], _lstsq(X[m], y[m]), rtol=1e-8, atol=1e-8, err_msg=f"heavy {gi}")
    np.testing.assert_allclose(beta, one, err_msg="heavy group: sharded against one shard", **SHARDED_TOL)
    out["heavy_group"] = float(np.abs(beta - one).max())

    rng = np.random.default_rng(7)
    N, K, G = 501, 3, 13
    X, y = rng.normal(size=(N, K)), rng.normal(size=N)
    w, gids = rng.random(N) > 0.1, rng.integers(G, size=N)
    Xg, yg, vg, _ = shuffle_rows_to_groups(
        make_mesh(SHARDED_SHARDS), *[torch.as_tensor(a, device=dev) for a in (X, y, w, gids)], num_groups=G
    )
    Xg, yg, vg = Xg.cpu().numpy(), yg.cpu().numpy(), vg.cpu().numpy()
    for gi in range(G):
        rows = np.flatnonzero(gids == gi)
        np.testing.assert_array_equal(Xg[gi, : len(rows)], X[rows])
        np.testing.assert_array_equal(yg[gi, : len(rows)], y[rows])
        np.testing.assert_array_equal(vg[gi, : len(rows)], w[rows])
        if vg[gi, len(rows):].any() or Xg[gi, len(rows):].any() or yg[gi, len(rows):].any():
            raise AssertionError(f"shuffle: group {gi} has padding slots that are valid or not zero")
    if vg[G:].any() or Xg[G:].any() or yg[G:].any():
        raise AssertionError("shuffle: the padding groups are not invalid and zero")
    out["shuffle"] = "bit for bit"

    rng = np.random.default_rng(32)
    n = 5_000
    x1 = rng.normal(size=n)
    x2 = x1 + SHARDED_COLLINEAR_NOISE * rng.normal(size=n)
    y = 1.5 * x1 - 0.5 * x2 + rng.normal(size=n) * 0.1
    g = rng.integers(20, size=n).astype(float)
    df = pt.DataFrame({"y": y, "x1": x1, "x2": x2, "g": g})
    e = pt.col("y").least_squares.ols("x1", "x2").over("g")
    runs = sharded_mod.csne_runs
    CONFIG.auto_shard = True
    got = df.select(e)["y"].to_numpy()
    CONFIG.auto_shard = False
    if sharded_mod.csne_runs != runs + 1:
        raise AssertionError("near-collinear: the sharded fit did not take the CSNE sweeps")
    single = df.select(e)["y"].to_numpy()
    x = np.stack([x1, x2], axis=1)
    for gid in range(20):
        m = g == gid
        np.testing.assert_allclose(got[m], x[m] @ _lstsq(x[m], y[m]), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got, single, err_msg="near-collinear", **SHARDED_TOL)
    out["near_collinear"] = float(np.abs(got - single).max())
    return out


def _sharded_phase(pt, torch, smi, df, g, mods):
    """The sharded engine (parallel/sharded.py) over SHARDED_SHARDS virtual
    shards of the card (``CONFIG.virtual_devices``, ``CONFIG.auto_shard``
    on; both restored after): every query of ``sharded_queries`` at the
    main frame through the public API, held to the same query on one
    device (``_sharded_close``), each timed both ways (wall median of
    SHARDED_REPS after the first) and profiled (device busy ms, launches,
    host syncs a query); then ``_sharded_cases``; and, where the host has
    more than one card, the queries again over the real cards. Returns the
    kernels' launches of the sharded queries' first pass."""
    from polars_ols_tpu_torch import CONFIG
    from polars_ols_tpu_torch.parallel import sharded as sharded_mod

    moments, special, cd, householder, jacobi, moving = mods
    counters = {
        "grouped_moments": (moments, "moments_kernel_launches"),
        "t_pvalue": (special, "t_pvalue_kernel_launches"),
        "cd_cov": (cd, "cd_kernel_launches"),
        "householder": (householder, "householder_kernel_launches"),
        "jacobi_svd": (jacobi, "jacobi_kernel_launches"),
        "moving": (moving, "moving_kernel_launches"),
    }
    t_phase = time.perf_counter()
    queries = sharded_queries(pt, N_FEATURES)
    gi = g.astype(np.int64)
    rank = np.zeros(len(gi), dtype=np.int64)
    order = np.argsort(gi, kind="stable")
    starts = np.searchsorted(gi[order], np.arange(N_GROUPS))
    rank[order] = np.arange(len(gi)) - np.repeat(starts, np.bincount(gi, minlength=N_GROUPS))
    settled = torch.as_tensor(rank >= N_FEATURES + SETTLED_EXTRA, device="cuda")
    saved = (CONFIG.virtual_devices, CONFIG._auto_shard, CONFIG.lazy_row_order)
    CONFIG.lazy_row_order = False
    try:
        CONFIG.virtual_devices, CONFIG.auto_shard = SHARDED_SHARDS, False
        ref = {}
        for label, (q, column) in queries.items():
            ref[label] = df.select(q)[column]
        CONFIG.auto_shard = True
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        calls0 = dict(sharded_mod.calls)
        out, first_s = {}, {}
        for label, (q, column) in queries.items():
            t0 = time.perf_counter()
            out[label] = df.select(q)[column]
            torch.cuda.synchronize()
            first_s[label] = time.perf_counter() - t0
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        calls = {k: sharded_mod.calls[k] - calls0[k] for k in calls0}
        if calls["fit_moments"] != 8 or calls["statistics_moments"] != 2 or calls["groups"] != 5:
            raise AssertionError(f"sharded queries: entry point calls {calls}")
        if any(v == 0 for v in launches.values()):
            raise AssertionError(f"sharded queries: kernel launches {launches}")
        report = {}
        for label in queries:
            report[label] = {
                "max_abs_diff_one_device": _sharded_close(label, out[label], ref[label], settled, torch),
                "first_s": first_s[label],
            }
        del out, ref
        for label, (q, column) in queries.items():
            row = report[label]
            for key, shard in (("", True), ("one_device_", False)):
                CONFIG.auto_shard = shard

                def fn(q=q):
                    return df.select(q)

                row[f"{key}wall_ms"] = _timed_median(fn, torch, SHARDED_REPS) * 1e3
                prof = _profile(fn, torch, queries=SHARDED_PROFILE_QUERIES)
                if prof is None:
                    row[f"{key}profile"] = "not measured"
                    continue
                row.update({f"{key}busy_ms": prof["busy_ms"], f"{key}launches": prof["launches"],
                            f"{key}host_syncs": prof["host_syncs"]})
            print(f"sharded {label}: " + json.dumps(row) + f" ({smi})")
        CONFIG.auto_shard = False
        cases = _sharded_cases(pt, torch, sharded_mod)
        real = "one card: not run"
        if torch.cuda.device_count() > 1:
            CONFIG.virtual_devices = 0
            worst = {}
            for label, (q, column) in queries.items():
                CONFIG.auto_shard = False
                r = df.select(q)[column]
                CONFIG.auto_shard = True
                worst[label] = _sharded_close(label, df.select(q)[column], r, settled, torch)
            real = json.dumps(worst)
    finally:
        CONFIG.virtual_devices, CONFIG._auto_shard, CONFIG.lazy_row_order = saved
    print(
        f"sharded: {len(queries)} queries ({', '.join(queries)}) at {N_ROWS} rows x {N_FEATURES} features x "
        f"{N_GROUPS} groups over {SHARDED_SHARDS} virtual shards of the card, each within {SHARDED_TOL} of one "
        f"device (p-values {SHARDED_P_TOL}; the moving models from the row on where a group holds K + "
        f"{SETTLED_EXTRA}); entry point calls {json.dumps(calls)}; kernel launches of the first pass "
        f"{json.dumps(launches)}; cases {json.dumps(cases)}; over the host's real cards: {real}; "
        f"phase {time.perf_counter() - t_phase:.1f} s ({smi})"
    )
    return launches


def _trace_fresh(torch, smi):
    """One ``utils.trace`` of the main query in a fresh process (this script
    with ``--trace-main``): whether the port's kernels (csrc/moments.cu's
    ``block_moments`` and ``group_sums``) are in the Chrome trace."""
    trace_dir = Path(__file__).resolve().parent / "chiprun_out" / "fresh_trace"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--trace-main", str(trace_dir)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"the fresh trace process failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(
        f"trace (fresh process): {trace_dir / 'trace.json'} holds {got['kernel_events']} CUDA kernel events; "
        f"the port's kernels in it: {got['port_kernels'] or 'none'}; csrc kernels present: "
        f"{bool(got['port_kernels'])}; {time.perf_counter() - t0:.1f} s ({smi})"
    )
    return got


def trace_main(out_dir: str) -> int:
    """``--trace-main``: the main query once warm, then once inside
    ``utils.trace(out_dir)``; prints the trace's kernel events and the
    port's kernels among them as the last line (JSON)."""
    import torch

    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG, col
    from polars_ols_tpu_torch.utils import trace

    CONFIG.device = "cuda"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_ROWS, N_FEATURES))
    y = x.sum(axis=1) + rng.normal(size=N_ROWS) * 0.1
    g = rng.integers(N_GROUPS, size=N_ROWS).astype(float)
    df = pt.DataFrame({"y": y, **{f"x{i + 1}": x[:, i] for i in range(N_FEATURES)}, "group": g})
    expr = col("y").least_squares.ols(*[col(f"x{i + 1}") for i in range(N_FEATURES)]).over("group")
    df.select(expr)
    torch.cuda.synchronize()
    with trace(out_dir):
        df.select(expr)
    events = json.loads((Path(out_dir) / "trace.json").read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    own = sorted({name for name in PORT_TRACE_KERNELS if any(name in k for k in kernels)})
    print(json.dumps({"kernel_events": len(kernels), "port_kernels": own}))
    return 0

LARGE_SHAPE = (10_000, 100, None)
LARGEK_SHAPE = (500_000, 40, 1_000)
FAULT_TARGETS, FAULT_K = 40, 3
WIDE_ALPHA = 0.1  # the suite's ridge alpha
WIDE_CHECK_GROUPS = 50
# the coordinate-descent queries of the two configurations, at the suite's
# alpha: label -> (l1_ratio, positive, solve method, max_iter); the suite's
# elastic_net (benchmarks/suite.py:132-133) first. Each also runs in
# coefficients mode (label + "/coef", checked, not timed), and the elastic
# net in statistics mode.
WIDE_CD = {
    "elastic_net": (0.5, False, "cd", 200),
    "lasso": (1.0, False, "cd", 1000),
    "nnls": (1.0, True, "cd", 1000),
    "lasso_active_set": (1.0, False, "cd_active_set", 1000),
}
WIDE_CD_CHECK_GROUPS = 20
# the wide kernels against their plain versions beyond the configurations'
# moments: (K, G, rows a group, settings) on moments drawn on the card;
# FISTA with XtX in shared memory up to K = 161, in device memory at 200
FISTA_CHECKS = (
    (33, 10_000, 66, dict(alpha=0.05, l1_ratio=0.5, max_iter=200)),
    (40, 10_000, 80, dict(alpha=0.05, l1_ratio=1.0, positive=True, max_iter=1000)),
    (64, 1_000, 128, dict(alpha=0.05, l1_ratio=0.0, max_iter=200)),
    (100, 1_000, 200, dict(alpha=0.05, l1_ratio=0.5, positive=True, max_iter=1000)),
    (100, 1, 200, dict(alpha=0.05, l1_ratio=1.0, max_iter=200)),
    (160, 1_000, 320, dict(alpha=0.05, l1_ratio=1.0, max_iter=1000)),
    (200, 1_000, 400, dict(alpha=0.05, l1_ratio=0.5, max_iter=200)),
)
CYCLIC_WIDE_CHECKS = (
    (33, 1_000, 66, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    (40, 1_000, 80, dict(alpha=0.02, l1_ratio=0.6, positive=True, active_set=True)),
    (100, 1_000, 200, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
)
# the JAX suite's test_fit_wide lasso (tests/test_ols.py:243-267): one
# group of 10 rows x 1,000 features
FIT_WIDE = (10, 1_000, dict(alpha=1e-6, l1_ratio=1.0, tol=1e-8, max_iter=3_000))
WIDE_CD_TIGHT_TOL = 1e-13  # the numpy coordinate descent that stands for the optimum
# against the optimum (the KKT conditions, relative to a_l1, and the tight
# numpy descent): the JAX suite's tolerance for its CD against an
# independent solver (sklearn, tests/test_ols.py:352-387). Every route
# stops at tol 1e-5, and FISTA's polished solve is kept only where its
# objective is no higher than the iterate's, which rounding can decide
# (as in the JAX engine), so an answer may be FISTA's iterate; the worst
# errors are printed
OPTIMUM_RTOL = 1e-4
WIDE_WINDOW_STEP = 7  # rows of a sampled group whose rolling window numpy solves


def _suite_frame(pt, torch, n, k, groups, seed=0):
    """benchmarks/suite.py:_make_df(n, k, groups, seed) on the card (its
    draws in its order): y = sum x + noise, y2, w, and g where grouped.
    Returns (frame, x, y, y2, w, g)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    y2 = x @ rng.normal(size=k) + rng.normal(size=n, scale=0.1)
    w = rng.random(n) + 0.1
    g = rng.integers(groups, size=n).astype(float) if groups else None
    dev = torch.device("cuda")
    cols = {"y": y, **{f"x{i + 1}": x[:, i] for i in range(k)}, "y2": y2, "w": w}
    frame = {name: torch.as_tensor(v, dtype=torch.float64, device=dev) for name, v in cols.items()}
    if g is not None:
        frame["g"] = g
    return pt.DataFrame(frame), x, y, y2, w, g


def _wide_queries(pt, col, k, grouped, fault=None):
    """label -> (expression, output column) of the suite's static and
    moving queries (benchmarks/suite.py:119-157) at k features, under
    .over("g") where grouped, with the multi-target struct(y, y2) and
    ``fault``'s targets."""
    feats = [col(f"x{i + 1}") for i in range(k)]
    ls = col("y").least_squares
    q = {
        "ols_qr": ls.ols(*feats, solve_method="qr"),
        "ols_svd": ls.ols(*feats, solve_method="svd"),
        "ridge_chol": ls.ridge(*feats, alpha=WIDE_ALPHA),
        "ridge_svd": ls.ridge(*feats, alpha=WIDE_ALPHA, solve_method="svd"),
        "wls": ls.wls(*feats, sample_weights="w"),
        "ols": ls.ols(*feats),
        "statistics": ls.ols(*feats, mode="statistics"),
        "rls": ls.rls(*feats, half_life=HALF_LIFE),
        "rolling": ls.rolling_ols(*feats, window_size=WINDOW),
    }
    for label, (l1, positive, method, max_iter) in WIDE_CD.items():
        for mode, suffix in (("predictions", ""), ("coefficients", "/coef")):
            q[label + suffix] = ls.elastic_net(*feats, alpha=WIDE_ALPHA, l1_ratio=l1, positive=positive,
                                               solve_method=method, max_iter=max_iter, mode=mode)
    q["elastic_net_statistics"] = ls.elastic_net(*feats, alpha=WIDE_ALPHA, l1_ratio=0.5, max_iter=200,
                                                 mode="statistics")
    if grouped:
        q["multi_target"] = pt.struct(col("y"), col("y2")).least_squares.multi_target_ols(*feats)
    if fault is not None:
        q["fault_multi_target"] = pt.struct(*[col(t) for t in fault]).least_squares.multi_target_ols(
            *feats[:FAULT_K]
        )
    out = {}
    for label, e in q.items():
        e = e.over("g") if grouped else e
        column = ("statistics" if label.endswith("statistics") else "coefficients" if label.endswith("/coef")
                  else "p" if "multi_target" in label else "y")
        out[label] = (e.alias("p") if column == "p" else e, column)
    return out


def _wide_expected(label, X, y, w):
    """numpy's coefficients of one group for a _wide_queries label."""
    if label.startswith("ridge"):
        return np.linalg.solve(X.T @ X + WIDE_ALPHA * np.eye(X.shape[1]), X.T @ y)
    if label == "wls":
        sq = np.sqrt(w)
        return _lstsq(X * sq[:, None], y * sq)
    return _lstsq(X, y)


def _wide_config(name, shape, pt, col, torch, smi, kernels_mod):
    """One wide configuration through the public API: every query once with
    the counts of the moment, Householder, Jacobi and moving kernels set to
    0 just before and read just after (the fault query's Jacobi launches
    apart: at K = 3 it takes the thread form), checked on sampled groups
    against numpy lstsq and scipy.stats.t (the moving queries against a
    literal Kalman recursion and a numpy lstsq per window, on every
    WIDE_WINDOW_STEP-th row and the last few), then timed (median of
    TIMING_REPS) and profiled. Returns the frame and its shape for the
    kernel checks, and the counts."""
    moments, householder, jacobi, moving, recursive, cd = kernels_mod
    n, k, groups = shape
    t0 = time.perf_counter()
    frame, x, y, y2, w, g = _suite_frame(pt, torch, n, k, groups)
    fault = None
    if groups:
        rng_f = np.random.default_rng(11)
        T = x[:, :FAULT_K] @ rng_f.normal(size=(FAULT_K, FAULT_TARGETS)) + 0.1 * rng_f.normal(
            size=(n, FAULT_TARGETS)
        )
        fault = [f"t{j}" for j in range(FAULT_TARGETS)]
        frame = frame.with_columns(**{
            t: pt.Series(t, torch.as_tensor(T[:, j], device="cuda")) for j, t in enumerate(fault)
        })
    setup_s = time.perf_counter() - t0
    queries = _wide_queries(pt, col, k, bool(groups), fault)
    moments.moments_kernel_launches = householder.householder_kernel_launches = 0
    jacobi.jacobi_kernel_launches = moving.moving_kernel_launches = 0
    cd.cd_kernel_launches = cd.fista_kernel_launches = cd.cyclic_wide_kernel_launches = 0
    out, first_s = {}, {}
    fault_jacobi = 0
    for label, (q, column) in queries.items():
        before = jacobi.jacobi_kernel_launches
        t1 = time.perf_counter()
        out[label] = frame.select(q)[column]
        torch.cuda.synchronize()
        first_s[label] = time.perf_counter() - t1
        if label == "fault_multi_target":
            fault_jacobi = jacobi.jacobi_kernel_launches - before
    launches = {
        "grouped_moments": moments.moments_kernel_launches,
        "householder": householder.householder_kernel_launches,
        "jacobi_svd": jacobi.jacobi_kernel_launches - fault_jacobi,
        "jacobi_svd (thread form, the fault query's K = 3)": fault_jacobi,
        "moving (shared form)": moving.moving_kernel_launches,
        "cd_fista": cd.fista_kernel_launches,
        "cd_cyclic_wide": cd.cyclic_wide_kernel_launches,
        "cd_cov (K <= 32)": cd.cd_kernel_launches,
    }
    for kname in ("grouped_moments", "householder", "jacobi_svd", "moving (shared form)", "cd_fista",
                  "cd_cyclic_wide"):
        if launches[kname] < 1:
            raise AssertionError(f"{name}: the {kname} kernel's wide form launched no time")
    n_fista = 2 * sum(m == "cd" for _, _, m, _ in WIDE_CD.values()) + 1
    if launches["cd_fista"] != n_fista or launches["cd_cyclic_wide"] != 2 or launches["cd_cov (K <= 32)"]:
        raise AssertionError(f"{name}: coordinate-descent launches {launches}, want {n_fista} FISTA and 2 cyclic")

    # the sampled groups (one group: all of it) against numpy and scipy
    gid = np.zeros(n, dtype=np.int64) if g is None else g.astype(np.int64)
    n_groups = groups or 1
    pick = np.random.default_rng(5).choice(n_groups, size=min(WIDE_CHECK_GROUPS, n_groups), replace=False)
    group_rows = _group_rows(gid, pick)
    first = torch.as_tensor(np.asarray([rows[0] for _, rows in group_rows]), device="cuda")
    stats = out["statistics"]
    stats = stats.gather(first) if groups else stats
    got_stats = {key: v.cpu().numpy() for key, v in stats.arrays.items()}
    for i, (_, rows) in enumerate(group_rows):
        Xg, yg = x[rows], y[rows]
        sel = torch.as_tensor(rows, device="cuda")
        for label, s in out.items():
            if label in ("statistics", "rls", "rolling") or label.split("/")[0] in WIDE_CD or label.startswith(
                    "elastic_net"):
                continue
            if label == "multi_target":
                got = _picked(s, sel)
                for j, yt in enumerate((yg, y2[rows])):
                    np.testing.assert_allclose(got[:, j], Xg @ _lstsq(Xg, yt), err_msg=label, **PRED_TOL)
            elif label == "fault_multi_target":
                got = _picked(s, sel)
                Tg = T[rows]
                want = x[rows, :FAULT_K] @ np.linalg.lstsq(x[rows, :FAULT_K], Tg, rcond=None)[0]
                np.testing.assert_allclose(got, want, err_msg=label, **PRED_TOL)
            else:
                want = Xg @ _wide_expected(label, Xg, yg, w[rows])
                np.testing.assert_allclose(_picked(s, sel), want, err_msg=f"{name} {label}", **PRED_TOL)
        ref = _stats_numpy(Xg, yg, 0.0)
        np.testing.assert_allclose(got_stats["coefficients"][i], ref["coefficients"], **COEF_TOL)
        for key in ("standard_errors", "t_values"):
            np.testing.assert_allclose(got_stats[key][i], ref[key], err_msg=key, **SE_T_TOL)
        np.testing.assert_allclose(got_stats["p_values"][i], ref["p_values"], **P_TOL)
        for key in ("r2", "mse", "mae"):
            np.testing.assert_allclose(got_stats[key][i], ref[key], err_msg=key, **METRIC_TOL)
        # the moving queries: rls against the Kalman recursion on every row,
        # rolling against lstsq per window on a subset of rows
        every = np.ones(len(rows), dtype=bool)
        kal = _kalman_numpy(Xg, yg, every, recursive.forgetting_factor(HALF_LIFE))
        np.testing.assert_allclose(_picked(out["rls"], sel), (Xg * kal).sum(1), err_msg=f"{name} rls", **PRED_TOL)
        some = np.unique(np.concatenate([np.arange(0, len(rows), WIDE_WINDOW_STEP), np.arange(len(rows))[-5:]]))
        win, cnt = _window_numpy(Xg, yg, every, WINDOW, min(k, WINDOW), True, rows=some)
        got = _picked(out["rolling"], sel)[some]
        np.testing.assert_array_equal(np.isnan(got), cnt[some] < min(k, WINDOW), err_msg=f"{name} rolling")
        m = cnt[some] >= k + SETTLED_EXTRA
        np.testing.assert_allclose(got[m], (Xg[some] * win[some]).sum(1)[m], err_msg=f"{name} rolling", **PRED_TOL)
    cd_checked = _wide_cd_checks(name, out, x, y, gid, n_groups, k, torch)
    print(
        f"wide {name}: {n} rows x {k} features x {n_groups} groups (set-up {setup_s!r} s), "
        f"{len(queries)} queries ({', '.join(queries)}), launches {json.dumps(launches)}; "
        f"{len(group_rows)} sampled groups match numpy lstsq and scipy.stats.t, rls the Kalman "
        f"recursion and rolling lstsq per window "
        f"(predictions {PRED_TOL}, statistics {COEF_TOL} / {SE_T_TOL} / {P_TOL}); {cd_checked}"
    )
    print(f"wide {name} first-query s: " + json.dumps({key: round(v, 4) for key, v in first_s.items()}))
    for label, (q, column) in queries.items():
        if label.endswith("/coef"):
            continue
        fn = (lambda q=q, column=column: frame.select(q)[column].arrays) if column == "statistics" else (
            lambda q=q: frame.select(q))
        med = _timed_median(fn, torch)
        prof = _profile(fn, torch, MOVING_KERNEL_NAMES if label in ("rls", "rolling") else None)
        print(
            f"timing wide {name} {label}: median {med * 1e3!r} ms, {n / med!r} rows/s; "
            + (f"device busy {prof['busy_ms']!r} ms, {prof['launches']!r} launches, {prof['host_syncs']!r} "
               f"host syncs a query, idle share <= {prof['idle_share']!r}" if prof else "profile not measured")
            + (f"; device ms by kernel {json.dumps(prof['kernels_ms'])}" if prof and label in ("rls", "rolling")
               else "")
            + f" ({smi})"
        )
    return {"frame": frame, "k": k, "grouped": bool(groups), "launches": launches, "fault": fault}


def _kkt(XtX, Xty, a_l1, a_l2, w, positive, rtol, label):
    """The elastic-net optimality conditions of w on one group's moments:
    r = Xty - XtX w - a_l2 w equals a_l1 sign(w_j) on the support (within
    rtol of a_l1) and |r_j| <= a_l1 (1 + rtol) off it (r_j <= for NNLS).
    Independent of the algorithm."""
    r = Xty - XtX @ w - a_l2 * w
    on = w != 0
    np.testing.assert_allclose(r[on], a_l1 * np.sign(w[on]), rtol=0, atol=rtol * a_l1, err_msg=f"{label}: KKT on")
    off = r[~on] if positive else np.abs(r[~on])
    if (off > a_l1 * (1 + rtol)).any():
        raise AssertionError(f"{label}: KKT off the support, max {float(off.max())!r} > a_l1 {a_l1!r}")
    return float(np.abs(r[on] - a_l1 * np.sign(w[on])).max(initial=0.0)) / a_l1


def _wide_cd_checks(name, out, x, y, gid, n_groups, k, torch):
    """The coordinate-descent queries on WIDE_CD_CHECK_GROUPS sampled groups
    (one group: all of it) against two oracles that stand for the optimum,
    at OPTIMUM_RTOL: the KKT conditions and a numpy cyclic coordinate
    descent to WIDE_CD_TIGHT_TOL; cd_active_set also against the literal
    numpy active-set descent at the same tol (the same iterates, CD_TOL).
    Predictions against the rows times the query's own coefficients, and
    the elastic net's statistics against _stats_numpy. Returns a summary
    with the worst errors for the configuration's line."""
    pick = np.random.default_rng(6).choice(n_groups, size=min(WIDE_CD_CHECK_GROUPS, n_groups), replace=False)
    group_rows = _group_rows(gid, pick)
    first = torch.as_tensor(np.asarray([rows[0] for _, rows in group_rows]), device="cuda")
    stats = out["elastic_net_statistics"]
    stats = stats.gather(first) if n_groups > 1 else stats
    got_stats = {key: v.cpu().numpy() for key, v in stats.arrays.items()}
    worst = {label: {"kkt_rel": 0.0, "vs_tight_rel": 0.0} for label in WIDE_CD}
    zeros = 0
    for i, (_, rows) in enumerate(group_rows):
        Xg, yg = x[rows], y[rows]
        sel = torch.as_tensor(rows, device="cuda")
        coef_row = sel[:1] if n_groups > 1 else torch.zeros(1, dtype=torch.int64, device="cuda")
        XtX_g, Xty_g, n_g = Xg.T @ Xg, Xg.T @ yg, float(len(rows))
        for label, (l1, positive, method, max_iter) in WIDE_CD.items():
            a = WIDE_ALPHA * max(n_g, 1.0)
            a_l1, a_l2 = a * l1, a * (1.0 - l1)
            w = _picked(out[label + "/coef"], coef_row)[0]
            tight = _cd_numpy(XtX_g, Xty_g, n_g, WIDE_ALPHA, l1, positive, max_iter=1_000_000,
                              tol=WIDE_CD_TIGHT_TOL)
            where = f"{name} {label} group {i}"
            if method == "cd_active_set":
                literal = _cd_numpy(XtX_g, Xty_g, n_g, WIDE_ALPHA, l1, positive, active_set=True,
                                    max_iter=max_iter)
                np.testing.assert_allclose(w, literal, err_msg=where, **CD_TOL)
            np.testing.assert_allclose(w, tight, rtol=OPTIMUM_RTOL, atol=OPTIMUM_RTOL, err_msg=where)
            kkt = _kkt(XtX_g, Xty_g, a_l1, a_l2, w, positive, OPTIMUM_RTOL, where)
            worst[label]["kkt_rel"] = max(worst[label]["kkt_rel"], kkt)
            worst[label]["vs_tight_rel"] = max(worst[label]["vs_tight_rel"],
                                               float(np.abs(w - tight).max() / np.abs(tight).max()))
            np.testing.assert_allclose(_picked(out[label], sel), Xg @ w, err_msg=where, **PREDICT_TOL)
            zeros += int((w == 0).sum())
        w_enet = got_stats["coefficients"][i]
        np.testing.assert_allclose(w_enet, _picked(out["elastic_net/coef"], coef_row)[0],
                                   err_msg=f"{name} statistics", **PREDICT_TOL)
        ref = _stats_numpy(Xg, yg, WIDE_ALPHA, beta=w_enet)
        for key in ("standard_errors", "t_values"):
            np.testing.assert_allclose(got_stats[key][i], ref[key], err_msg=f"{name} elastic_net {key}", **SE_T_TOL)
        np.testing.assert_allclose(got_stats["p_values"][i], ref["p_values"], **P_TOL)
        for key in ("r2", "mse", "mae"):
            np.testing.assert_allclose(got_stats[key][i], ref[key], err_msg=f"{name} elastic_net {key}", **METRIC_TOL)
    return (f"the coordinate-descent queries on {len(group_rows)} groups hold the KKT conditions and a numpy "
            f"coordinate descent to tol {WIDE_CD_TIGHT_TOL} within {OPTIMUM_RTOL} (worst, relative: "
            f"{json.dumps(worst)}), cd_active_set the literal numpy active-set descent at {CD_TOL}; "
            f"{zeros} zero coefficients among them; the elastic net's statistics match _stats_numpy")


def _wide_blocks(fit, groups_mod, frame, k, grouped, m=1, targets=None):
    """(layout, Zp, wp, offsets) of the configuration's split blocks, as
    the engine builds them (targets first)."""
    layout = (groups_mod.layout_for_columns([frame["g"]]) if grouped
              else groups_mod.single_layout(len(frame["y"])))
    names = targets or (["y", "y2"][:m])
    vals, _ = fit._stack_cached(frame[names[0]], [frame[t] for t in names[1:]]
                                + [frame[f"x{i + 1}"] for i in range(k)])
    Zp, wp, _ = fit._blocks_cached(layout, vals, None, "ignore", m=len(names))
    return layout, Zp, wp, layout.device_block_offsets(Zp.shape[1])


def _householder_exact(Z, w, K):
    """The reduction of the masked blocks Z [B, R, C] (numpy) in long double
    (x86 80-bit): the plain version's reflections, each sum in long
    double; [B, K, C] as float64."""
    A = np.where(w[..., None], Z, 0.0).astype(np.longdouble)
    B, R, C = A.shape
    if R < K:
        A = np.concatenate([A, np.zeros((B, K - R, C), dtype=np.longdouble)], axis=1)
        R = K
    M = C - K
    rows = np.arange(R)
    for j in range(K):
        col = A[:, :, M + j] * (rows >= j)
        sigma = (col * col).sum(axis=-1)
        cj = A[:, j, M + j]
        alpha = -np.where(cj >= 0, 1, -1) * np.sqrt(sigma)
        v = col.copy()
        v[:, j] = cj - alpha
        denom = sigma - cj * alpha
        beta = np.where(denom > 0, 1 / np.where(denom > 0, denom, 1), 0)
        A = A - (beta[:, None] * v)[:, :, None] * np.einsum("br,brc->bc", v, A)[:, None, :]
    return A[:, :K].astype(np.float64)


def householder_shared_stream_edges():
    """The three Householder edges of _wide_kernels (R = 60 < K = 100, a
    zero feature column at K = 40, R = 2,000) as they were drawn when the
    wide moment edges that come before them (C = 48 with R = 3, C = 200, a
    C = 101 row split) still drew from the shared default_rng(7): [(label,
    Z, w, K)], numpy. The first holds a block whose 46 valid rows leave its
    46th pivot at 2.9e-5 of its column's norm, so the rows below it are
    round-off amplified ~3e4 times."""
    rng = np.random.default_rng(7)
    draws = [rng.integers(1, 4, size=300), rng.integers(1, 4, size=100), np.asarray([1]),
             np.full(40, 2), np.full(10, 2), np.asarray([3])]
    for n_blocks, R, C in zip(draws, (512, 512, 16, 3, 300, 37), (34, 64, 1001, 48, 200, 101)):
        S = int(n_blocks.sum())
        rng.normal(size=(S, R, C))
        rng.normal(size=(1, 1, C))
        rng.random((S, R))
    rng.normal(size=(120, 37, 65))
    rng.random((120, 37))
    out = []
    for label, (B, R, C, k_h, zero_col) in (
        ("R=60 < K=100", (40, 60, 101, 100, None)),
        ("a zero feature column, K=40", (200, 512, 42, 40, 3)),
        ("R=2000, C=41", (20, 2_000, 41, 40, None)),
    ):
        Zh = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
        wh = rng.random((B, R)) > 0.2
        Zh[~wh] = np.nan
        if zero_col is not None:
            Zh[..., C - k_h + zero_col] = 0.0
        out.append((label, Zh, wh, k_h))
    return out


def _householder_shared_stream(householder, torch, smi):
    """The kernel and the plain version at householder_shared_stream_edges,
    each against the long-double reduction (_householder_exact): the
    largest error of an entry over its column's norm, where it lies, and
    the block's valid rows. A measurement: the check against the plain
    version at REDUCTION_RTOL is the card test's
    (test_householder_wide_form_at_the_shared_stream_edges_on_card)."""
    res = {}
    for label, Z, w, K in householder_shared_stream_edges():
        Zt, wt = torch.as_tensor(Z, device="cuda"), torch.as_tensor(w, device="cuda")
        T_k = householder.householder_blocks(Zt, wt, K).cpu().numpy()
        T_p = householder.householder_blocks_ref(Zt, wt, K).cpu().numpy()
        T_x = _householder_exact(Z, w, K)
        norm = np.sqrt((np.where(w[..., None], Z, 0.0) ** 2).sum(axis=1, keepdims=True))
        row = {}
        M = Z.shape[-1] - K
        for name, a, b in (("kernel_vs_plain", T_k, T_p), ("kernel_vs_exact", T_k, T_x), ("plain_vs_exact", T_p, T_x)):
            rel = np.abs(a - b) / np.maximum(norm, 1e-300)
            at = np.unravel_index(int(np.argmax(rel)), rel.shape)
            # the pivot above the worst row, |R_jj| over its column's norm
            j = max(int(at[1]) - 1, 0)
            row[name] = {"max": float(rel[at]), "block": int(at[0]), "row": int(at[1]), "column": int(at[2]),
                         "valid_rows": int(w[at[0]].sum()),
                         "pivot_above_over_norm": float(abs(T_x[at[0], j, M + j]) / max(norm[at[0], 0, M + j], 1e-300))}
        res[label] = row
        print(f"kernel householder wide form, edge drawn from the shared stream, {label}: errors over the "
              f"column's norm {json.dumps(row)} (exact: the reduction in long double) ({smi})")
    return res


def _householder_past_4096(householder, torch, smi, n=4_200, K=4_100, R=512):
    """One group of n rows x K features in blocks of R rows through the
    Householder tree (its factors stack only the blocks' R rows: one level
    of 4,608 rows past K = 4,096, where a level once stacked two K-row
    factors), timed once (host clock around a synchronize: the tree takes
    seconds); its factor's triangle solved and held to numpy lstsq (rtol
    1e-9). The data of test_householder_tree_past_4096_features_on_card."""
    import scipy.linalg

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, K))
    y = X[:, :50].sum(axis=1) + rng.normal(size=n) * 0.1
    S = -(-n // R)
    Z = np.zeros((S * R, K + 1))
    Z[:n, 0], Z[:n, 1:] = y, X
    Zt = torch.as_tensor(Z.reshape(S, R, K + 1), device="cuda")
    wt = torch.as_tensor((np.arange(S * R) < n).reshape(S, R), device="cuda")
    plan = householder.plan_reduction(np.asarray([S]), K, "cuda", rows=R)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T = householder.reduce_groups(Zt, wt, K, plan)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    T = T[0].cpu().numpy()
    del Zt, wt
    beta = scipy.linalg.solve_triangular(T[:, 1:], T[:, 0])
    ref = np.linalg.lstsq(X, y, rcond=None)[0]
    np.testing.assert_allclose(beta, ref, rtol=1e-9, atol=1e-12)
    out = {"n": n, "K": K, "R": R, "launches": 1 + len(plan.levels), "ms": ms,
           "max_abs_err_vs_lstsq": float(np.abs(beta - ref).max())}
    print(f"kernel householder, one group past K = 4,096: {json.dumps(out)} (the tree once, host clock "
          f"around a synchronize; beta from its triangle against numpy lstsq at rtol 1e-9) ({smi})")
    return out


def _wide_kernels(pt, torch, smi, op_ms, mods, large, largek):
    """The wide forms against their plain versions at the blocks and factors
    that the two configurations give them, and at their edges; timed (in
    turns, with the library call that computes the same function) beside
    their bounds. Returns the kernels-line fields of each form."""
    fit, groups_mod, moments, householder, jacobi = mods
    res = {"grouped_moments": {}, "householder": {}, "jacobi_svd": {}}
    rng = np.random.default_rng(7)
    # the moments: B's blocks (headline), A's, and the edges
    for key, cfg in (("grouped_largek", largek), ("large", large)):
        layout, Zp, wp, offsets = _wide_blocks(fit, groups_mod, cfg["frame"], cfg["k"], cfg["grouped"])
        err, t = _check_kernel(f"wide form, {key} blocks", Zp, wp, offsets, layout.num_groups, moments, torch,
                               library=True)
        bound = _moment_bound(Zp, wp, layout.num_groups)
        print(f"kernel wide form, {key} blocks bound: {json.dumps(bound)} ({smi})")
        S, R, C = Zp.shape
        rows = moments.piece_rows(S, R, C, torch.cuda.get_device_properties(0).multi_processor_count)
        res["grouped_moments"][key] = {"max_abs_err": err, **t, **bound, "S": S, "R": R, "C": C,
                                       "piece_rows": rows, "pieces": moments.pieces(R, rows)}
    for label, n_blocks, R, C in (("C=34", rng.integers(1, 4, size=300), 512, 34),
                                  ("C=64", rng.integers(1, 4, size=100), 512, 64),
                                  ("C=1001 (test_fit_wide's ridge)", np.asarray([1]), 16, 1001)):
        _check_kernel(f"wide form, {label}", *_random_blocks(rng, n_blocks, R, C, torch, "cuda"), moments,
                      torch, timed=False)
    # the DMMA form's own edges, from a stream of their own (the draws below
    # stay as they were)
    rng_d = np.random.default_rng(17)
    for label, n_blocks, R, C in (("C=48, R=3 (six tiles, a ragged k-step)", np.full(40, 2), 3, 48),
                                  ("C=200 (the direct form)", np.full(10, 2), 300, 200),
                                  ("C=101, one group of 3 blocks of 37 rows (a row split)", np.asarray([3]), 37, 101)):
        _check_kernel(f"wide form, {label}", *_random_blocks(rng_d, n_blocks, R, C, torch, "cuda"), moments,
                      torch, timed=False)
    # NaN in masked slots and views at odd offsets (rows 8 bytes past 16)
    S, R, C = 120, 37, 65
    Z = rng.normal(size=(S, R, C))
    W = rng.random((S, R)) > 0.2
    Z[~W] = np.nan
    Zv = torch.empty(S * R * C + 1, dtype=torch.float64, device="cuda")[1:].view(S, R, C)
    wv = torch.empty(S * R + 3, dtype=torch.bool, device="cuda")[3:].view(S, R)
    Zv.copy_(torch.as_tensor(Z))
    wv.copy_(torch.as_tensor(W))
    offs = torch.arange(0, S + 1, 3, dtype=torch.int64, device="cuda")
    M_k, _ = moments.grouped_moments_blocks(Zv, wv, offs, S // 3)
    if not bool(torch.isfinite(M_k).all()):
        raise AssertionError("moment kernel, wide form: a masked slot's NaN reached the moments")
    _check_kernel("wide form, NaN in masked slots, views at odd offsets", Zv, wv, offs, S // 3, moments, torch,
                  timed=False)

    # the Householder reduction: B's svd blocks (headline), A's, B's
    # multi-target and fault blocks, and the edges
    for key, cfg, k, m, targets in (
        ("grouped_largek", largek, largek["k"], 1, None),
        ("large", large, large["k"], 1, None),
        ("grouped_largek_fault", largek, FAULT_K, FAULT_TARGETS, largek["fault"]),
        ("grouped_largek_multi_target", largek, largek["k"], 2, None),
    ):
        _, Zb, wb, _ = _wide_blocks(fit, groups_mod, cfg["frame"], k, cfg["grouped"], m, targets)
        form = householder.kernel_form(Zb.shape[1], Zb.shape[2])
        out = _check_householder(f"wide form ({form}), {key} blocks", Zb, wb, k, householder, torch,
                                 timed=key != "grouped_largek_multi_target")
        res["householder"][key] = {**out, "form": form, "S": Zb.shape[0], "R": Zb.shape[1], "C": Zb.shape[2],
                                   "K": k}
        if key in ("grouped_largek", "large"):
            res["householder"][key]["phases_ms"] = _householder_phases(
                f"wide form, {key} blocks", Zb, wb, k, householder, torch, smi)
        del Zb, wb
    for label, (B, R, C, k_h, zero_col) in (
        ("R=60 < K=100 (zero rows below the last)", (40, 60, 101, 100, None)),
        ("a zero feature column, K=40", (200, 512, 42, 40, 3)),
        ("R=2000, C=41 (panel in device memory)", (20, 2_000, 41, 40, None)),
    ):
        Zh = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
        wh = rng.random((B, R)) > 0.2
        Zh[~wh] = np.nan
        if zero_col is not None:
            Zh[..., C - k_h + zero_col] = 0.0
        _check_householder(f"wide form, {label}", torch.as_tensor(Zh, device="cuda"),
                           torch.as_tensor(wh, device="cuda"), k_h, householder, torch, timed=False)
    # the blocked form's own edges, from a stream of their own (the draws
    # above stay as they were): K not a multiple of the panel, fewer rows
    # than a panel, a zero pivot column inside a panel
    rng_h = np.random.default_rng(18)
    for label, (B, R, C, k_h, zero_col) in (
        ("K=33, C=35 (a panel of 1 after four of 8)", (200, 512, 35, 33, None)),
        ("K=41, C=43", (200, 300, 43, 41, None)),
        ("R=5 < a panel, C=41", (300, 5, 41, 40, None)),
        ("a zero pivot column inside the second panel, K=40", (200, 512, 42, 40, 10)),
    ):
        Zh = rng_h.normal(size=(B, R, C)) * np.exp(rng_h.normal(size=(1, 1, C)) * 3)
        wh = rng_h.random((B, R)) > 0.2
        Zh[~wh] = np.nan
        if zero_col is not None:
            Zh[..., C - k_h + zero_col] = 0.0
        _check_householder(f"wide form, {label}", torch.as_tensor(Zh, device="cuda"),
                           torch.as_tensor(wh, device="cuda"), k_h, householder, torch, timed=False)
    res["householder"]["shared_stream_edges"] = _householder_shared_stream(householder, torch, smi)
    res["householder"]["past_4096"] = _householder_past_4096(householder, torch, smi)

    # the Jacobi SVD: B's factors (headline, the svd query's), A's, the
    # multi-target query's, and the edges (the rows mode among them)
    for key, cfg, m in (("grouped_largek", largek, 1), ("large", large, 1), ("grouped_largek_multi_target", largek, 2)):
        k = cfg["k"]
        layout, Zb, wb, offsets = _wide_blocks(fit, groups_mod, cfg["frame"], k, cfg["grouped"], m)
        T = householder.reduce_groups(Zb, wb, k, fit._reduction_plan(layout, Zb.shape[1], k))
        nv = wb.sum(dim=1, dtype=torch.float64)
        if Zb.shape[0] > layout.num_groups:
            nv = torch.segment_reduce(nv, "sum", offsets=offsets, axis=0)
        timed = ("plain", "kernel", "library") if key != "grouped_largek_multi_target" else ()
        res["jacobi_svd"][key] = _check_jacobi(f"wide form, {key} factors", T[..., m:], T[..., :m], nv, jacobi,
                                               torch, op_ms, timed=timed, plain_once=True)
        if key in ("grouped_largek", "large"):
            res["jacobi_svd"][key]["phases_ms"] = _jacobi_phases(
                f"wide form, {key} factors", T[..., m:], T[..., :m], nv, jacobi, torch, smi,
                held=(0, jacobi.MAX_SWEEPS))
        del Zb, wb, T
    for label, (G, k_j, m_j, alpha_j, rcond_j, kind) in (
        ("K=33", (300, 33, 2, 0.0, None, "factor")),
        ("K=40 rank-deficient", (200, 40, 1, 0.0, None, "deficient")),
        ("K=40 NaN lanes", (140, 40, 2, 0.0, None, "nan")),
    ):
        _check_jacobi(f"wide form, {label}", *_jacobi_edge(rng, G, k_j, m_j, kind, torch), jacobi,
                      torch, op_ms, alpha_j, rcond_j)
    # the redesigned form's edges, from a stream of their own: odd K, a pair's
    # rows past a segment's registers, and the cluster (groups fewer than
    # the SMs)
    rng_w = np.random.default_rng(19)
    for label, (G, k_j, m_j, kind) in (
        ("K=41 (odd)", (300, 41, 2, "factor")),
        ("K=64 rank-deficient", (200, 64, 1, "deficient")),
        ("K=40, 20 groups (a cluster of 4 CTAs a group)", (20, 40, 2, "factor")),
        ("K=100, 4 groups NaN lanes (a cluster of 8)", (4, 100, 1, "nan")),
    ):
        _check_jacobi(f"wide form, {label}", *_jacobi_edge(rng_w, G, k_j, m_j, kind, torch), jacobi, torch, op_ms)
    rows_mode = {}
    for K_r, n_r, G_r in ((1_000, 10, 100), (100, 20, 1_000)):
        X = rng.normal(size=(G_r, n_r, K_r))
        Yr = rng.normal(size=(G_r, n_r, 1))
        Xt = torch.as_tensor(X, device="cuda").mT
        Yt = torch.as_tensor(Yr, device="cuda")
        nv = torch.full((G_r,), float(n_r), dtype=torch.float64, device="cuda")
        b_k = jacobi.rows_lstsq(Xt, Yt, nv)
        b_p = jacobi.rows_lstsq_ref(Xt, Yt, nv)
        err = _jacobi_err(f"rows mode K={K_r} n={n_r}", b_k, b_p, torch)
        bh = b_k.cpu().numpy()
        for i in range(min(G_r, 20)):
            np.testing.assert_allclose(bh[i], np.linalg.lstsq(X[i], Yr[i], rcond=None)[0], **COEF_TOL)
        t = _timing_fields(_in_turns({"kernel": lambda: jacobi.rows_lstsq(Xt, Yt, nv)}, JACOBI_LAUNCHES, torch))
        rows_mode[f"K={K_r},n={n_r},G={G_r}"] = {"max_abs_err": err, "ms": t["ms"]}
        print(f"kernel jacobi_svd wide form, rows mode: G={G_r} K={K_r} n={n_r} max_abs_err={err!r} vs plain, "
              f"20 problems match numpy lstsq ({COEF_TOL}); kernel_ms={t['ms']!r} per launch ({smi})")
    res["jacobi_svd"]["rows_mode"] = rows_mode
    return res


def _wide_cd_kernels(torch, smi, op_ms, cd, fit, groups_mod, large, largek):
    """The FISTA and wide cyclic kernels against their plain versions, timed
    beside their bounds: at the moments of the two configurations (the
    suite's elastic net by FISTA, the lasso's cd_active_set by the cyclic
    form; B first, the headline), at FISTA_CHECKS and CYCLIC_WIDE_CHECKS,
    and on test_fit_wide's lasso (FIT_WIDE). Returns the kernels-line
    fields of each kernel."""
    from polars_ols_tpu_torch.ops.direct import grouped_moments

    res = {"cd_fista": {}, "cd_cyclic_wide": {}}
    for key, cfg in (("grouped_largek", largek), ("large", large)):
        layout, Zp, wp, offsets = _wide_blocks(fit, groups_mod, cfg["frame"], cfg["k"], cfg["grouped"])
        XtX, Xty, counts = grouped_moments(Zp, wp, offsets, layout.num_groups)
        XtX, Xty = XtX.contiguous(), Xty.contiguous()
        res["cd_fista"][key] = _check_cd_wide(
            f"{key} moments, the suite's elastic net", XtX, Xty, counts,
            dict(alpha=WIDE_ALPHA, l1_ratio=0.5, max_iter=200), cd, torch, op_ms, smi, phases=True,
        )
        res["cd_cyclic_wide"][key] = _check_cd_wide(
            f"{key} moments, lasso cd_active_set", XtX, Xty, counts,
            dict(alpha=WIDE_ALPHA, l1_ratio=1.0, active_set=True), cd, torch, op_ms, smi, phases=True,
        )
        del Zp, wp, XtX, Xty
    for name, checks in (("cd_fista", FISTA_CHECKS), ("cd_cyclic_wide", CYCLIC_WIDE_CHECKS)):
        for i, (K, G, rows, kw) in enumerate(checks):
            label = f"K={K} G={G}"
            moments = _wide_cd_moments(1_000 * K + G + i, G, K, rows, torch)
            res[name][label] = _check_cd_wide(label, *moments, kw, cd, torch, op_ms, smi)
            del moments
    n, K, kw = FIT_WIDE
    rng = np.random.default_rng(0)  # tests/test_ols.py:_make_data(10, 1_000, scale=1e-4)
    X = rng.normal(size=(n, K))
    y = X.sum(axis=1) + rng.normal(size=n, scale=1e-4)
    dev = torch.device("cuda")
    moments = (torch.as_tensor((X.T @ X)[None], device=dev), torch.as_tensor((X.T @ y)[None], device=dev),
               torch.full((1,), float(n), dtype=torch.float64, device=dev))
    out = _check_cd_wide("test_fit_wide's lasso (10 rows)", *moments, kw, cd, torch, op_ms, smi)
    w, _ = cd.solve_elastic_net_cov(*moments, **kw)
    corr = float(np.corrcoef(X @ w[0].cpu().numpy(), y)[0, 1])
    if abs(corr - 1.0) > 1e-5:
        raise AssertionError(f"test_fit_wide's lasso: predictions correlate with y at {corr!r}, not within 1e-5 of 1")
    print(f"kernel cd_fista test_fit_wide's lasso: predictions correlate with y at {corr!r} (within 1e-5 of 1)")
    res["cd_fista"][f"K={K} G=1, {n} rows (test_fit_wide)"] = {**out, "correlation": corr}
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1

    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG, col
    from polars_ols_tpu_torch.engine import batch, fit, groups
    from polars_ols_tpu_torch.engine.native import native_loaded
    from polars_ols_tpu_torch.ops import (
        cd, grid_probe, householder, jacobi, kernels, moments, moving, recursive, rolling, special,
    )
    from polars_ols_tpu_torch.ops.direct import grouped_moments

    CONFIG.device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # 1. device
    print(smi)
    print(
        f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}"
    )

    # 2. build: one nvcc per source, all at once
    sources = ("moments", "grid_probe", "cd", "cd_wide", "t_pvalue", "moving", "householder", "jacobi_svd")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(kernels.build, sources))
    print(f"build: csrc/{{{','.join(sources)}}}.cu in {time.perf_counter() - t0:.3f} s")
    for name in sources:
        for entry, used, spill in _ptxas(kernels.build_log.get(name, "")):
            print(f"build {name} {entry}: {used}; {spill}")
    print(f"build moments: DMMA (mma.sync m8n8k4 f64) instructions in the built code {json.dumps(_dmma_counts(kernels))}")
    hh_sass = _householder_sass(kernels)
    print(f"build householder: the wide form's DMMA (mma.sync m16n8k16 / m16n8k8 f64), shared-memory (LDS / STS) and generic "
          f"(LD / ST) instructions in the built code {json.dumps(hh_sass)}")

    # 3. the probe's own entry point (its path), then each kernel against
    # its plain version, at the main path's shapes first
    grid_probe.scale_copy_launches = 0
    grid_probe.run_probe(torch.device("cuda"))
    torch.cuda.synchronize()
    probe_launches = grid_probe.scale_copy_launches
    if probe_launches != 2:
        raise AssertionError(f"probe kernel launched {probe_launches} times for 2 forms")
    probe_err, probe_times = _check_probe(grid_probe, torch)
    probe_x = torch.zeros((grid_probe.PROBE_ROWS, grid_probe.PROBE_COLS), dtype=torch.float32, device="cuda")
    probe_bound = _bound(2 * 4 * probe_x.numel(), probe_x.numel(), PEAK_F32_PER_S)
    dev = torch.device("cuda")
    floor_ms = _in_turns({"empty": lambda: grid_probe.empty_launch(dev)}, PROBE_LAUNCHES, torch)["empty"][0]
    print(f"floor: an empty kernel (one 32-thread block) {floor_ms!r} ms per launch ({smi})")
    op_ms = _dependent_op_ms(special, torch)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_ROWS, N_FEATURES))
    y = x.sum(axis=1) + rng.normal(size=N_ROWS) * 0.1
    g = rng.integers(N_GROUPS, size=N_ROWS).astype(float)
    # the static fits' additions, from their own stream: a weight column and
    # nulls per column (y, x1..x5) in the odd-numbered groups, so that the
    # even-numbered ones are compared as numbers under every policy
    # ('ignore' leaves a group with a null without finite coefficients)
    rng_s = np.random.default_rng(1)
    w = rng_s.random(N_ROWS) + 0.1
    valid = rng_s.random((N_ROWS, 1 + N_FEATURES)) >= NULL_RATE
    valid[g.astype(np.int64) % 2 == 0] = True
    valid[0] = True
    names = ["y"] + [f"x{i + 1}" for i in range(N_FEATURES)]
    up = {n: torch.as_tensor(v, dtype=torch.float64, device=dev)
          for n, v in zip(names + ["w"], [y, *x.T, w])}
    # the null-masked columns share the uploaded values
    nulled = {f"{n}n": pt.Series(f"{n}n", up[n], valid[:, j]) for j, n in enumerate(names)}
    # the multi-target queries' second target y2 and its nulls (odd-numbered
    # groups, row 0 valid), from a child stream of seed 0
    rng_2 = np.random.default_rng(np.random.SeedSequence(0).spawn(1)[0])
    y2 = x @ np.asarray(Y2_COEFS) + rng_2.normal(size=N_ROWS) * 0.1
    y2_valid = (rng_2.random(N_ROWS) >= NULL_RATE) | (g.astype(np.int64) % 2 == 0)
    y2_valid[0] = True
    y2_up = torch.as_tensor(y2, dtype=torch.float64, device=dev)
    nulled["y2n"] = pt.Series("y2n", y2_up, y2_valid)
    df = pt.DataFrame({**up, "y2": y2_up, "group": g, **nulled})
    features = [col(f"x{i + 1}") for i in range(N_FEATURES)]
    layout = groups.layout_for_columns([df["group"]])
    vals, _ = fit._stack_cached(df["y"], [df[f"x{i + 1}"] for i in range(N_FEATURES)])
    Zp, wp, _ = fit._blocks_cached(layout, vals, None, "ignore")
    r_cap = Zp.shape[1]
    main_err, main_times = _check_kernel(
        "main-path", Zp, wp, layout.device_block_offsets(r_cap),
        layout.num_groups, moments, torch, library=True,
    )
    main_bound = _moment_bound(Zp, wp, layout.num_groups)
    print(f"kernel main-path bound: {json.dumps(main_bound)}")
    _check_kernel(
        "ragged (R=37: mask bytes not 16-aligned; R*C odd: slabs 8-byte aligned)",
        *_random_blocks(rng, rng.integers(1, 8, size=300), 37, 33, torch), moments, torch,
    )
    _check_kernel(
        "one-group (S=64, fewer blocks than the persistent grid's warps)",
        *_random_blocks(rng, np.asarray([64]), 512, 6, torch), moments, torch,
    )
    # the edges of the card-only tests: where lanes owning rows hand over to
    # lanes owning entries, mask bytes not 16-aligned, groups without blocks
    # (from a stream of their own, so that the draws below stay as they were)
    rng_e = np.random.default_rng(2)
    # (C = 9 and C = 16 are timed too: a shape each side of the hand-over
    # from lanes owning entries to lanes owning tiles)
    for label, n_blocks, R, C, timed in (
        ("C=8 (rows in lanes)", rng_e.integers(1, 8, size=300), 512, 8, False),
        ("C=9 (entries in lanes)", np.full(2000, 2), 512, 9, True),
        ("C=16 (tiles in lanes)", np.full(2000, 2), 512, 16, True),
        ("R=513", rng_e.integers(1, 8, size=300), 513, 6, False),
        ("empty groups", np.asarray([3, 0, 2, 0, 0, 5, 0]), 512, 6, False),
    ):
        _check_kernel(label, *_random_blocks(rng_e, n_blocks, R, C, torch), moments, torch, timed=timed)

    # the Householder kernel against its plain version, at the main frame's
    # split blocks: C = 6 (the svd query's [y | X]) and C = 7 (the
    # multi-target query's [y, y2 | X]); then its edges, and one group of
    # SERIES_ROWS rows through every level of the tree
    K = N_FEATURES
    vals_mt, _ = fit._stack_cached(df["y"], [df["y2"]] + [df[f"x{i + 1}"] for i in range(K)])
    Zmt, wmt, _ = fit._blocks_cached(layout, vals_mt, None, "ignore", m=2)
    hh = {
        "svd": _check_householder("main-path blocks, C=6 (the svd query)", Zp, wp, K, householder, torch),
        "multi_target": _check_householder(
            "main-path blocks, C=7 (the multi-target query)", Zmt, wmt, K, householder, torch
        ),
    }
    hh_phases = {
        "svd": _householder_phases("C=6 (the svd query)", Zp, wp, K, householder, torch, smi),
        "multi_target": _householder_phases("C=7 (the multi-target query)", Zmt, wmt, K, householder, torch, smi),
    }
    # the Jacobi SVD kernel at the same queries' factors: the tree's last
    # level, as the engine hands it over (strided views of T); timed, and
    # stopped after 0 / 1 / all sweeps (the kernel's phases)
    jc, jc_phases = {}, {}
    for key, label, (Zb, wb, m) in (
        ("svd", "the svd query's factors", (Zp, wp, 1)),
        ("multi_target", "the multi-target query's factors", (Zmt, wmt, 2)),
    ):
        T = householder.reduce_groups(Zb, wb, K, fit._reduction_plan(layout, Zb.shape[1], K))
        nv = torch.segment_reduce(wb.sum(dim=1, dtype=torch.float64), "sum",
                                  offsets=layout.device_block_offsets(Zb.shape[1]), axis=0)
        jc[key] = _check_jacobi(label, T[..., m:], T[..., :m], nv, jacobi, torch, op_ms,
                                timed=("plain", "kernel", "library"))
        jc_phases[key] = _jacobi_phases(label, T[..., m:], T[..., :m], nv, jacobi, torch, smi)
    del Zmt, wmt, vals_mt, T
    # the edges; K = 8 / 16 / 32 timed too (the kernel, in the thread form
    # at K = 8 and the segment form at 16 / 32, and the torch.linalg.svd
    # route: the plain version takes seconds a call there)
    rng_j = np.random.default_rng(4)
    jacobi.jacobi_kernel_launches = 0
    jc_wide = {}
    for label, (k_j, m_j, alpha_j, rcond_j, kind) in (
        ("K=1", (1, 2, 0.0, None, "factor")),
        ("K=8", (8, 1, 0.0, None, "factor")),
        ("K=16", (16, 3, 0.0, None, "factor")),
        ("K=32", (32, 1, 0.0, None, "factor")),
        ("rank-deficient (a duplicate or a zero column)", (5, 2, 0.0, None, "deficient")),
        ("NaN lanes (in factors and in targets)", (5, 2, 0.0, None, "nan")),
        ("alpha > 0 and a user rcond", (5, 2, 0.3, 1e-6, "factor")),
        ("the square branch (general square X)", (5, 2, 0.0, None, "square")),
    ):
        timed_j = ("kernel", "library") if k_j in JACOBI_TIMED_K else ()
        out_j = _check_jacobi(label, *_jacobi_edge(rng_j, JACOBI_EDGE_GROUPS, k_j, m_j, kind, torch),
                              jacobi, torch, op_ms, alpha_j, rcond_j, timed=timed_j)
        if timed_j:
            jc_wide[str(k_j)] = out_j
    jc_edges = jacobi.jacobi_kernel_launches
    rng_h = np.random.default_rng(3)
    householder.householder_kernel_launches = 0
    for label, (B, R, C, k_h, zero_col, nan_masked) in (
        ("R=3 < K=5 (zero rows below the last)", (300, 3, 8, 5, None, False)),
        ("a zero feature column", (300, 512, 6, 5, 2, False)),
        ("NaN in the masked padding slots", (300, 512, 7, 5, None, True)),
        ("K=32, M=1 (C=33)", (100, 512, 33, 32, None, False)),
    ):
        Zh = rng_h.normal(size=(B, R, C)) * np.exp(rng_h.normal(size=(1, 1, C)) * 3)
        wh = rng_h.random((B, R)) > 0.2
        if zero_col is not None:
            Zh[..., C - k_h + zero_col] = 0.0
        if nan_masked:
            Zh[~wh] = np.nan
        _check_householder(
            label, torch.as_tensor(Zh, device=dev), torch.as_tensor(wh, device=dev), k_h,
            householder, torch, timed=False,
        )
    S2 = SERIES_ROWS
    df_one = pt.DataFrame({n: up[n][:S2] for n in names})
    lay1 = groups.single_layout(S2)
    vals1, _ = fit._stack_cached(df_one["y"], [df_one[f"x{i + 1}"] for i in range(K)])
    Z1, w1, _ = fit._blocks_cached(lay1, vals1, None, "ignore")
    plan1 = fit._reduction_plan(lay1, Z1.shape[1], K)
    T1_k = householder.reduce_groups(Z1, w1, K, plan1)
    torch.cuda.synchronize()
    plan1_cpu = householder.plan_reduction(lay1._blocks_per_group(Z1.shape[1]), K)
    T1_p = householder.reduce_groups(Z1.cpu(), w1.cpu(), K, plan1_cpu)
    norm1 = torch.where(w1[..., None], Z1, 0.0).square().sum(dim=(0, 1)).sqrt().cpu()
    tree_err = float((T1_k.cpu() - T1_p).abs().max())
    if not bool(((T1_k.cpu() - T1_p).abs() <= TREE_RTOL * norm1).all()):
        raise AssertionError(f"Householder tree of one group of {S2} rows: {tree_err!r} from the plain tree")
    hh_edges = householder.householder_kernel_launches
    print(
        f"kernel householder tree: one group of {S2} rows, {Z1.shape[0]} blocks of {Z1.shape[1]}, "
        f"{len(plan1.levels) + 1} launches (levels {[tuple(m.shape) for _, m in plan1.levels]}), "
        f"max_abs_err={tree_err!r} against the plain version's tree (within {TREE_RTOL} of each "
        f"column's norm); edge launches {hh_edges}"
    )
    del T1_k, T1_p, Z1, w1, vals1, df_one

    # 4. the main path at full width, through the public API
    expr = col("y").least_squares.ols(*features).over("group")
    coef_expr = col("y").least_squares.ols(*features, mode="coefficients").over("group")
    moments.moments_kernel_launches = 0
    CONFIG.lazy_row_order = False
    out_mat = df.select(expr)
    CONFIG.lazy_row_order = True
    out_lazy = df.select(expr)
    out_coef = df.select(coef_expr)
    torch.cuda.synchronize()
    launches = moments.moments_kernel_launches
    if launches < 3:
        raise AssertionError(f"moment kernel launched {launches} times for 3 queries")
    if not native_loaded():
        raise AssertionError("the native C++ layout helpers did not load")
    if not out_lazy["y"].is_lazy or out_mat["y"].is_lazy:
        raise AssertionError("lazy_row_order did not select the output form")
    preds_mat = out_mat["y"].to_numpy()
    preds_lazy = out_lazy["y"].to_numpy()
    coefs = out_coef["coefficients"].to_numpy()
    if preds_mat.shape != (N_ROWS,) or coefs.shape != (N_ROWS, N_FEATURES):
        raise AssertionError(f"shapes {preds_mat.shape} {coefs.shape}")
    if not (np.isfinite(preds_mat).all() and np.isfinite(coefs).all()):
        raise AssertionError("non-finite output")
    np.testing.assert_array_equal(preds_lazy, preds_mat)
    checked = rng.choice(N_GROUPS, size=N_CHECK_GROUPS, replace=False)
    for _, rows, beta in _groupwise_lstsq(x, y, g.astype(np.int64), checked):
        np.testing.assert_allclose(coefs[rows[0]], beta, **COEF_TOL)
        np.testing.assert_allclose(preds_mat[rows], x[rows] @ beta, **PRED_TOL)
    print(
        f"slice: {N_ROWS} rows x {N_FEATURES} features x {layout.num_groups} groups, "
        f"moment kernel launches={launches}, native layout helpers loaded, "
        f"{N_CHECK_GROUPS} groups match numpy lstsq"
    )

    # ill-conditioned groups (cond(X) ~ 1e7: the CSNE branch) and groups
    # with an all-zero feature (Cholesky fails: the eigh fallback)
    n_small = 6_000
    gs = rng.integers(25, size=n_small)
    x1 = rng.normal(size=n_small)
    x_ill = np.stack([x1, x1 + 1e-5 * rng.normal(size=n_small), rng.normal(size=n_small)], 1)
    if np.linalg.cond(x_ill) ** 2 <= 1e6:  # cond(X'X) gates the refinement
        raise AssertionError("the ill-conditioned case is not ill-conditioned")
    x_def = rng.normal(size=(n_small, 3))
    x_def[gs < 5, 1] = 0.0
    cases = (
        ("ill-conditioned", x_ill, 1e-8, 1e-10),
        ("rank-deficient", x_def, 1e-8, 1e-10),
    )
    for label, X_, rtol, atol in cases:
        ys = X_ @ np.asarray([1.5, -0.5, 2.0]) + rng.normal(size=n_small) * 0.1
        dfs = pt.DataFrame(
            {"y": ys, "a": X_[:, 0], "b": X_[:, 1], "c": X_[:, 2], "g": gs.astype(float)}
        )
        preds = dfs.select(col("y").least_squares.ols("a", "b", "c").over("g"))["y"].to_numpy()
        cs = dfs.select(
            col("y").least_squares.ols("a", "b", "c", mode="coefficients").over("g")
        )["coefficients"].to_numpy()
        for _, rows, beta in _groupwise_lstsq(X_, ys, gs, np.arange(25)):
            np.testing.assert_allclose(preds[rows], X_[rows] @ beta, rtol=rtol, atol=atol)
            if label == "rank-deficient":
                np.testing.assert_allclose(cs[rows[0]], beta, **COEF_TOL)
        print(f"slice: {label} case matches numpy lstsq (rtol {rtol}, atol {atol})")

    # 5. the static fits at full width: every query through the public API
    # under .over("group"), first-query seconds on the host clock
    xn = [f"x{i + 1}n" for i in range(N_FEATURES)]
    xv = [f"x{i + 1}" for i in range(N_FEATURES)]

    def ols(target, feats, **kw):
        return col(target).least_squares.ols(*feats, **kw).over("group")

    queries = {}  # label -> (expr, output column)
    for policy in POLICIES:
        queries[policy] = (ols("yn", xn, null_policy=policy), "yn")
        queries[f"{policy}/coef"] = (
            ols("yn", xn, null_policy=policy, mode="coefficients"), "coefficients"
        )
    queries["wls"] = (col("y").least_squares.wls(*xv, sample_weights="w").over("group"), "y")
    queries["wls/coef"] = (ols("y", xv, sample_weights="w", mode="coefficients"), "coefficients")
    queries["drop/residuals"] = (ols("yn", xn, null_policy="drop", mode="residuals"), "yn")
    for method in ("lu", "qr", "svd"):
        queries[method] = (ols("y", xv, solve_method=method), "y")
        queries[f"{method}/coef"] = (ols("y", xv, solve_method=method, mode="coefficients"), "coefficients")
    moment_queries = [q for q in queries if not q.startswith("svd")]

    moments.moments_kernel_launches = householder.householder_kernel_launches = 0
    jacobi.jacobi_kernel_launches = 0
    out, first_s = {}, {}
    for label, (q, column) in queries.items():
        t0 = time.perf_counter()
        out[label] = df.select(q)[column]
        torch.cuda.synchronize()
        first_s[label] = time.perf_counter() - t0
    static_launches = moments.moments_kernel_launches
    svd_launches = householder.householder_kernel_launches
    svd_jacobi = jacobi.jacobi_kernel_launches
    if static_launches < len(moment_queries):
        raise AssertionError(
            f"moment kernel launched {static_launches} times for "
            f"{len(moment_queries)} moment-path queries"
        )
    n_svd = len(queries) - len(moment_queries)
    if svd_launches < n_svd or svd_jacobi != n_svd:
        raise AssertionError(
            f"Householder / Jacobi kernels launched {svd_launches} / {svd_jacobi} times for {n_svd} svd queries"
        )

    # nulls exactly where each policy puts them, over every row
    fit_drop = torch.as_tensor(valid[:, 0] & valid[:, 1:].all(axis=1), device=dev)
    for label, s in out.items():
        policy = label.split("/")[0]
        if label.endswith("/coef"):
            if policy != "ignore" and not bool(s.validity.all()):
                raise AssertionError(f"{label}: null coefficients")
        elif policy == "drop":  # predictions and residuals
            if s.validity is None or not torch.equal(s.validity, fit_drop):
                raise AssertionError(f"{label}: nulls are not the dropped rows")
        elif s.validity is not None:
            raise AssertionError(f"{label}: predictions carry nulls")

    # values against numpy on the sampled groups
    group_rows = _group_rows(g.astype(np.int64), checked)
    sel_np = np.concatenate([rows for _, rows in group_rows])
    sel = torch.as_tensor(sel_np, device=dev)
    host = {label: _picked(s, sel) for label, s in out.items()}
    sq = np.sqrt(w)
    at = 0
    n_clean = n_nulled = 0
    for _, rows in group_rows:
        here = slice(at, at + len(rows))
        at += len(rows)
        Xg, yg, vx, vy = x[rows], y[rows], valid[rows, 1:], valid[rows, 0]
        n_clean += bool(vx.all() and vy.all())
        n_nulled += not (vx.all() and vy.all())
        for policy in POLICIES:
            beta, preds, shown = _policy_expected(policy, Xg, yg, vx, vy)
            np.testing.assert_allclose(host[f"{policy}/coef"][here][0], beta, **COEF_TOL)
            np.testing.assert_allclose(host[policy][here][shown], preds[shown], **PRED_TOL)
            if policy == "drop":
                np.testing.assert_allclose(
                    host["drop/residuals"][here][shown], (yg - preds)[shown], **PRED_TOL
                )
        beta = _lstsq(Xg * sq[rows, None], yg * sq[rows])
        np.testing.assert_allclose(host["wls/coef"][here][0], beta, **COEF_TOL)
        np.testing.assert_allclose(host["wls"][here], Xg @ beta, **PRED_TOL)
        beta = _lstsq(Xg, yg)  # full rank: the minimum-norm solution too
        for method in ("lu", "qr", "svd"):
            np.testing.assert_allclose(host[f"{method}/coef"][here][0], beta, **COEF_TOL)
            np.testing.assert_allclose(host[method][here], Xg @ beta, **PRED_TOL)
    if n_clean == 0 or n_nulled == 0:
        raise AssertionError(
            f"sampled groups: {n_clean} without nulls, {n_nulled} with: both kinds are needed"
        )
    print(
        f"static: {len(queries)} queries ({', '.join(queries)}) at {N_ROWS} rows, "
        f"moment kernel launches={static_launches} for {len(moment_queries)} moment-path "
        f"queries, nulls where each policy puts them, {N_CHECK_GROUPS} groups match numpy "
        f"({n_clean} without nulls, finite under 'ignore'; {n_nulled} with)"
    )
    print("static first-query s: " + json.dumps({k: round(v, 4) for k, v in first_s.items()}))
    vals_n, valid_n = fit._stack_cached(df["yn"], [df[c] for c in xn])
    Zd, wd, _ = fit._blocks_cached(layout, vals_n, valid_n, "drop")
    _check_kernel(
        "drop-policy", Zd, wd, layout.device_block_offsets(r_cap), layout.num_groups,
        moments, torch,
    )
    del Zd, wd

    # 5b. multi-target OLS at full width through the public API: the
    # reference suite's struct(y, y2) target on x1..x5 under .over("group"),
    # every query once, with the counts of all kernels set to 0 just before
    # and read just after
    def mt(targets, feats, **kw):
        target = pt.struct(*[col(t) for t in targets])
        return target.least_squares.multi_target_ols(*feats, **kw).over("group").alias("p")

    mt_queries = {
        "multi_target": mt(("y", "y2"), xv),
        "multi_target/residuals": mt(("y", "y2"), xv, mode="residuals"),
        "multi_target/wls": mt(("y", "y2"), xv, sample_weights="w"),
        "multi_target/drop": mt(("yn", "y2n"), xn, null_policy="drop"),
    }
    CONFIG.lazy_row_order = False
    moments.moments_kernel_launches = cd.cd_kernel_launches = special.t_pvalue_kernel_launches = 0
    moving.moving_kernel_launches = householder.householder_kernel_launches = 0
    jacobi.jacobi_kernel_launches = 0
    mtout, first_s_mt = {}, {}
    for label, q in mt_queries.items():
        t0 = time.perf_counter()
        mtout[label] = df.select(q)["p"]
        torch.cuda.synchronize()
        first_s_mt[label] = time.perf_counter() - t0
    mt_launches = householder.householder_kernel_launches
    mt_jacobi = jacobi.jacobi_kernel_launches
    others = (moments.moments_kernel_launches, cd.cd_kernel_launches,
              special.t_pvalue_kernel_launches, moving.moving_kernel_launches)
    if mt_launches < len(mt_queries) or mt_jacobi != len(mt_queries) or any(others):
        raise AssertionError(
            f"Householder / Jacobi kernels launched {mt_launches} / {mt_jacobi} times for "
            f"{len(mt_queries)} multi-target queries; other kernels {others}"
        )
    fit_mt = valid[:, 0] & y2_valid & valid[:, 1:].all(axis=1)
    for label, s_ in mtout.items():
        if s_.values.shape != (N_ROWS, 2) or s_.field_names != (
            ["yn", "y2n"] if label.endswith("drop") else ["y", "y2"]
        ):
            raise AssertionError(f"{label}: fields {s_.field_names}, shape {tuple(s_.values.shape)}")
        if label.endswith("drop"):
            want_valid = torch.as_tensor(np.repeat(fit_mt[:, None], 2, axis=1), device=dev)
            if s_.validity is None or not torch.equal(s_.validity, want_valid):
                raise AssertionError(f"{label}: nulls are not the dropped rows")
        elif s_.validity is not None:
            raise AssertionError(f"{label}: predictions carry nulls")
    mthost = {label: _picked(s_, sel) for label, s_ in mtout.items()}
    at = 0
    for _, rows in group_rows:
        here = slice(at, at + len(rows))
        at += len(rows)
        Xg, Yg = x[rows], np.stack([y[rows], y2[rows]], axis=1)
        preds = Xg @ _lstsq(Xg, Yg)
        np.testing.assert_allclose(mthost["multi_target"][here], preds, err_msg="multi_target", **PRED_TOL)
        np.testing.assert_allclose(
            mthost["multi_target/residuals"][here], Yg - preds, err_msg="residuals", **PRED_TOL
        )
        sqw = sq[rows, None]
        np.testing.assert_allclose(
            mthost["multi_target/wls"][here], Xg @ _lstsq(Xg * sqw, Yg * sqw), err_msg="wls", **PRED_TOL
        )
        f = fit_mt[rows]
        got = mthost["multi_target/drop"][here]
        np.testing.assert_array_equal(np.isnan(got), ~np.repeat(f[:, None], 2, axis=1))
        np.testing.assert_allclose(got[f], (Xg @ _lstsq(Xg[f], Yg[f]))[f], err_msg="drop", **PRED_TOL)
    print(
        f"multi_target: {len(mt_queries)} queries ({', '.join(mt_queries)}) of struct(y, y2) at "
        f"{N_ROWS} rows x {N_FEATURES} features x {N_GROUPS} groups, Householder kernel "
        f"launches={mt_launches}, Jacobi kernel launches={mt_jacobi} (no other kernel), nulls where "
        f"'drop' puts them, "
        f"{N_CHECK_GROUPS} groups match numpy lstsq per target"
    )
    print("multi_target first-query s: " + json.dumps({k: round(v, 4) for k, v in first_s_mt.items()}))
    del mtout, mthost

    # 6. statistics and coordinate descent at full width, through the
    # public API under .over("group"): every query once, with the counts
    # of all kernels set to 0 just before and read just after
    def lasso(target, feats, **kw):
        return col(target).least_squares.lasso(*feats, alpha=LASSO_ALPHA, **kw).over("group")

    stat_queries = {
        "statistics": (ols("y", xv, mode="statistics"), "statistics"),
        "ridge/statistics": (
            col("y").least_squares.ridge(*xv, alpha=RIDGE_ALPHA, mode="statistics").over("group"),
            "statistics",
        ),
        "drop/statistics": (ols("yn", xn, null_policy="drop", mode="statistics"), "statistics"),
        "svd/statistics": (ols("y", xv, solve_method="svd", mode="statistics"), "statistics"),
        "lasso": (lasso("y", xv), "y"),
        "lasso/coef": (lasso("y", xv, mode="coefficients"), "coefficients"),
        "lasso/statistics": (lasso("y", xv, mode="statistics"), "statistics"),
        "elastic_net/coef": (
            col("y").least_squares.elastic_net(
                *xv, alpha=ENET_ALPHA, l1_ratio=0.5, mode="coefficients"
            ).over("group"),
            "coefficients",
        ),
        "nnls/coef": (lasso("y", xv, positive=True, mode="coefficients"), "coefficients"),
        "cd_active_set/coef": (
            lasso("y", xv, solve_method="cd_active_set", mode="coefficients"), "coefficients"
        ),
    }
    CONFIG.lazy_row_order = False
    moments.moments_kernel_launches = 0
    cd.cd_kernel_launches = 0
    special.t_pvalue_kernel_launches = 0
    householder.householder_kernel_launches = jacobi.jacobi_kernel_launches = 0
    sout, first_s_stat = {}, {}
    for label, (q, column) in stat_queries.items():
        t0 = time.perf_counter()
        sout[label] = df.select(q)[column]
        torch.cuda.synchronize()
        first_s_stat[label] = time.perf_counter() - t0
    stat_launches = {
        "grouped_moments": moments.moments_kernel_launches,
        "cd_cov": cd.cd_kernel_launches,
        "t_pvalue": special.t_pvalue_kernel_launches,
        "householder": householder.householder_kernel_launches,
        "jacobi_svd": jacobi.jacobi_kernel_launches,
    }
    n_stat = sum(label.endswith("statistics") for label in stat_queries)
    n_cd = sum(label.split("/")[0] in ("lasso", "elastic_net", "nnls", "cd_active_set")
               for label in stat_queries)
    if (stat_launches["grouped_moments"] < len(stat_queries) or stat_launches["cd_cov"] < n_cd
            or stat_launches["t_pvalue"] < n_stat or stat_launches["jacobi_svd"] != 1
            or stat_launches["householder"] < 1):
        raise AssertionError(
            f"kernel launches {stat_launches} for {len(stat_queries)} queries, {n_cd} by "
            f"coordinate descent and {n_stat} with statistics"
        )

    # values on the sampled groups against numpy / scipy
    first = np.asarray([rows[0] for _, rows in group_rows])
    first_t = torch.as_tensor(first, device=dev)
    picked = {}
    for label, s in sout.items():
        if label.endswith("statistics"):
            arrays = s.gather(first_t).arrays
            picked[label] = {k: v.cpu().numpy() for k, v in arrays.items()}
        elif label.endswith("/coef"):
            picked[label] = _picked(s, first_t)
    lasso_preds = _picked(sout["lasso"], sel)
    at = 0
    for i, (_, rows) in enumerate(group_rows):
        here = slice(at, at + len(rows))
        at += len(rows)
        Xg, yg, vx, vy = x[rows], y[rows], valid[rows, 1:], valid[rows, 0]
        fit_rows = vy & vx.all(axis=1)
        XtX_g, Xty_g, n_g = Xg.T @ Xg, Xg.T @ yg, float(len(rows))
        w_lasso = _cd_numpy(XtX_g, Xty_g, n_g, LASSO_ALPHA, 1.0)
        want = {
            "statistics": _stats_numpy(Xg, yg, 0.0),
            "ridge/statistics": _stats_numpy(Xg, yg, RIDGE_ALPHA),
            "drop/statistics": _stats_numpy(Xg[fit_rows], yg[fit_rows], 0.0),
            "svd/statistics": _stats_numpy(Xg, yg, 0.0),
            "lasso/statistics": _stats_numpy(Xg, yg, LASSO_ALPHA, beta=w_lasso),
        }
        for label, ref in want.items():
            got = {k: v[i] for k, v in picked[label].items()}
            coef_tol = CD_TOL if label.startswith("lasso") else COEF_TOL
            np.testing.assert_allclose(got["coefficients"], ref["coefficients"], **coef_tol)
            for key in ("standard_errors", "t_values"):
                np.testing.assert_allclose(got[key], ref[key], err_msg=f"{label} {key}", **SE_T_TOL)
            np.testing.assert_allclose(got["p_values"], ref["p_values"], **P_TOL)
            for key in ("r2", "mse", "mae"):
                np.testing.assert_allclose(got[key], ref[key], err_msg=f"{label} {key}", **METRIC_TOL)
        cd_want = {
            "lasso/coef": w_lasso,
            "elastic_net/coef": _cd_numpy(XtX_g, Xty_g, n_g, ENET_ALPHA, 0.5),
            "nnls/coef": _cd_numpy(XtX_g, Xty_g, n_g, LASSO_ALPHA, 1.0, positive=True),
            "cd_active_set/coef": _cd_numpy(XtX_g, Xty_g, n_g, LASSO_ALPHA, 1.0, active_set=True),
        }
        for label, ref in cd_want.items():
            np.testing.assert_allclose(picked[label][i], ref, err_msg=label, **CD_TOL)
        np.testing.assert_allclose(lasso_preds[here], Xg @ w_lasso, **CD_TOL)
    lasso_coefs = picked["lasso/coef"]
    if not ((lasso_coefs == 0).any() and (lasso_coefs != 0).any()):
        raise AssertionError(f"lasso at alpha {LASSO_ALPHA}: the sampled groups need zero and nonzero coefficients")
    print(
        f"statistics/cd: {len(stat_queries)} queries ({', '.join(stat_queries)}) at {N_ROWS} rows, "
        f"kernel launches {json.dumps(stat_launches)}, {N_CHECK_GROUPS} groups match numpy lstsq / "
        f"scipy.stats.t and a literal numpy coordinate descent; lasso zero coefficients "
        f"{float((lasso_coefs == 0).mean())!r} of the sampled"
    )
    print("statistics/cd first-query s: " + json.dumps({k: round(v, 4) for k, v in first_s_stat.items()}))

    # the two kernels of this path against their plain versions, at its
    # shapes: coordinate descent on the main path's moments, the p-values
    # on the statistics query's t and dof
    XtX_m, Xty_m, counts_m = grouped_moments(Zp, wp, layout.device_block_offsets(r_cap), layout.num_groups)
    XtX_m, Xty_m = XtX_m.contiguous(), Xty_m.contiguous()
    cd_err, cd_times, cd_sweeps = _check_cd(
        "main-path lasso", XtX_m, Xty_m, counts_m, dict(alpha=LASSO_ALPHA, l1_ratio=1.0), cd, torch
    )
    cd_bound = _cd_bound(N_GROUPS, N_FEATURES, cd_sweeps, op_ms)
    print(f"kernel cd main-path lasso bound: {json.dumps(cd_bound)}")
    for label, kw in (
        ("main-path active_set", dict(alpha=LASSO_ALPHA, l1_ratio=1.0, active_set=True)),
        ("main-path positive", dict(alpha=LASSO_ALPHA, l1_ratio=1.0, positive=True)),
    ):
        _check_cd(label, XtX_m, Xty_m, counts_m, kw, cd, torch)
    _check_cd(
        "signed positive", *_signed_moments(rng, N_GROUPS, N_FEATURES, torch),
        dict(alpha=0.05, l1_ratio=0.8, positive=True), cd, torch,
    )
    # the K buckets' edges (8 | 9, 16 | 17) at group counts that leave the
    # last warp part empty (4 and 2 groups a warp at K <= 8 and <= 16)
    for K in (8, 9, 16, 17):
        _check_cd(
            f"K={K} bucket edge", *_signed_moments(rng_e, 1001, K, torch),
            dict(alpha=0.05, l1_ratio=0.8, positive=K % 2 == 1), cd, torch, timed=False,
        )
    first_of_group = torch.as_tensor(np.unique(g.astype(np.int64), return_index=True)[1], device=dev)
    t_query = sout["statistics"].gather(first_of_group).arrays["t_values"].contiguous()
    dof_query = torch.as_tensor(layout.counts - N_FEATURES, dtype=torch.float64, device=dev)
    p_err, p_times = _check_pvalue(t_query, dof_query, special, torch, op_ms)
    p_bound = _pvalue_bound(
        t_query, dof_query, {kind: ns * 1e-6 for kind, ns in p_times["dependent_op_ns"].items()}
    )
    print(f"kernel t_pvalue bound at the query's [{N_GROUPS}, {N_FEATURES}]: {json.dumps(p_bound)}")

    # 7. the moving models: the kernel against its plain versions on small
    # batches, then every query once at full width through the public API,
    # with the counts of all kernels set to 0 just before and read just after
    _check_moving(moving, recursive, rolling, torch)
    digests = _register_digests(moving, torch)
    if digests != REGISTER_FORM_DIGESTS:
        raise AssertionError(f"the register form's outputs changed: {digests} != {REGISTER_FORM_DIGESTS}")
    print(f"kernel moving, register form: K = 1..8 outputs equal the recorded digests bit for bit ({digests})")
    K = N_FEATURES

    def mv(model, target, feats, **kw):
        return getattr(col(target).least_squares, model)(*feats, **kw)

    moving_queries = {
        "rls": (mv("rls", "y", xv, half_life=HALF_LIFE).over("group"), "y"),
        "rls/coef": (
            mv("rls", "y", xv, half_life=HALF_LIFE, mode="coefficients").over("group"), "coefficients"
        ),
        "rls/wls": (mv("rls", "y", xv, half_life=HALF_LIFE, sample_weights="w").over("group"), "y"),
        "expanding": (mv("expanding_ols", "y", xv).over("group"), "y"),
        "rolling": (mv("rolling_ols", "y", xv, window_size=WINDOW).over("group"), "y"),
        "rolling/drop_window": (
            mv("rolling_ols", "yn", xn, window_size=WINDOW, null_policy="drop_window").over("group"), "yn"
        ),
        "rolling/drop": (
            mv("rolling_ols", "yn", xn, window_size=WINDOW, null_policy="drop").over("group"), "yn"
        ),
    }
    S = SERIES_ROWS
    df2 = pt.DataFrame({
        **{n: up[n][:S] for n in names + ["w"]},
        **{f"{n}n": pt.Series(f"{n}n", up[n][:S], valid[:S, j]) for j, n in enumerate(names)},
    })
    series_queries = {
        "series/rls": (mv("rls", "yn", xn, half_life=HALF_LIFE), "yn"),
        "series/expanding": (mv("expanding_ols", "yn", xn), "yn"),
        "series/expanding/coef": (mv("expanding_ols", "yn", xn, mode="coefficients"), "coefficients"),
        "series/rolling": (mv("rolling_ols", "yn", xn, window_size=WINDOW), "yn"),
    }
    CONFIG.lazy_row_order = True
    moments.moments_kernel_launches = cd.cd_kernel_launches = special.t_pvalue_kernel_launches = 0
    moving.moving_kernel_launches = moving.moving_host_syncs = moving.moving_flagged_rows = 0
    batch.flag_reads = 0
    mout, first_s_mov = {}, {}
    for frame, qs in ((df, moving_queries), (df2, series_queries)):
        for label, (q, column) in qs.items():
            t0 = time.perf_counter()
            mout[label] = frame.select(q)[column]
            torch.cuda.synchronize()
            first_s_mov[label] = time.perf_counter() - t0
    CONFIG.lazy_row_order = False
    rls_mat = df.select(moving_queries["rls"][0])["y"]
    torch.cuda.synchronize()
    moving_launches = moving.moving_kernel_launches
    # a fit's flag count comes to the host in its run's one read
    # (engine/batch.py); the eigh rows of a flagged call read twice more
    moving_syncs, moving_flagged = batch.flag_reads + moving.moving_host_syncs, moving.moving_flagged_rows
    n_moving = len(moving_queries) + len(series_queries) + 1
    if moving_launches < n_moving:
        raise AssertionError(f"moving kernel launched {moving_launches} times for {n_moving} queries")
    if not mout["rls"].is_lazy or rls_mat.is_lazy:
        raise AssertionError("lazy_row_order did not select the moving output form")
    if not torch.equal(mout["rls"].values, rls_mat.values):
        raise AssertionError("rls: lazy and materialized predictions differ")

    # the grouped queries on the sampled groups against a literal Kalman
    # recursion and a numpy lstsq per window
    ff = recursive.forgetting_factor(HALF_LIFE)
    mhost = {label: _picked(mout[label], sel) for label in moving_queries}
    t0 = time.perf_counter()
    at = 0
    for _, rows in group_rows:
        here = slice(at, at + len(rows))
        at += len(rows)
        Xg, yg, vx, vy = x[rows], y[rows], valid[rows, 1:], valid[rows, 0]
        every = np.ones(len(rows), dtype=bool)
        kal = _kalman_numpy(Xg, yg, every, ff)
        np.testing.assert_allclose(mhost["rls/coef"][here], kal, err_msg="rls/coef", **COEF_TOL)
        np.testing.assert_allclose(mhost["rls"][here], (Xg * kal).sum(1), err_msg="rls", **PRED_TOL)
        kal = _kalman_numpy(Xg, yg, every, 1.0)
        np.testing.assert_allclose(mhost["expanding"][here], (Xg * kal).sum(1), err_msg="expanding", **PRED_TOL)
        sqw = sq[rows]
        kal = _kalman_numpy(Xg * sqw[:, None], yg * sqw, every, ff)
        np.testing.assert_allclose(mhost["rls/wls"][here], (Xg * kal).sum(1), err_msg="rls/wls", **PRED_TOL)
        fitm = vy & vx.all(axis=1)
        Xz, yz = np.where(vx, Xg, 0.0), np.where(vy, yg, 0.0)
        for label, Xw, yw, vw, positional in (
            ("rolling", Xg, yg, every, True),
            ("rolling/drop_window", Xz, yz, fitm, True),
            ("rolling/drop", Xz, yz, fitm, False),
        ):
            win, cnt = _window_numpy(Xw, yw, vw, WINDOW, K, positional)
            shown = vw & ~np.isnan(win[:, 0])
            got = mhost[label][here]
            np.testing.assert_array_equal(np.isnan(got), ~shown, err_msg=label)
            m = shown & (cnt >= K + SETTLED_EXTRA)
            np.testing.assert_allclose(got[m], (Xw * win).sum(1)[m], err_msg=label, **PRED_TOL)
    oracle_s = time.perf_counter() - t0

    # the single series: its first rows against the same oracles, its last
    # rows against closed forms
    H, T = SERIES_HEAD, SERIES_TAIL
    fit_s = valid[:S].all(axis=1)
    Xs, ys = np.where(valid[:S, 1:], x[:S], 0.0), np.where(valid[:S, 0], y[:S], 0.0)
    shost = {label: s_.to_numpy() for label, s_ in mout.items() if label.startswith("series/")}
    kal = _kalman_numpy(Xs[:H], ys[:H], fit_s[:H], ff)
    np.testing.assert_array_equal(np.isnan(shost["series/rls"]), ~fit_s)
    np.testing.assert_allclose(shost["series/rls"][:H][fit_s[:H]], (Xs[:H] * kal).sum(1)[fit_s[:H]], **PRED_TOL)
    kal = _kalman_numpy(Xs[:H], ys[:H], fit_s[:H], 1.0)
    np.testing.assert_allclose(shost["series/expanding/coef"][:H], kal, **COEF_TOL)
    np.testing.assert_allclose(shost["series/expanding"][:H][fit_s[:H]], (Xs[:H] * kal).sum(1)[fit_s[:H]], **PRED_TOL)
    win, cnt = _window_numpy(Xs[:H], ys[:H], fit_s[:H], WINDOW, K, False)
    shown = fit_s[:H] & ~np.isnan(win[:, 0])
    np.testing.assert_array_equal(np.isnan(shost["series/rolling"][:H]), ~shown)
    m = shown & (cnt >= K + SETTLED_EXTRA)
    np.testing.assert_allclose(shost["series/rolling"][:H][m], (Xs[:H] * win).sum(1)[m], **PRED_TOL)
    tail = np.arange(S - T, S)
    win, _ = _window_numpy(Xs, ys, fit_s, WINDOW, K, False, rows=tail)
    m = fit_s[tail]
    rolling_tail_err = float(np.abs(shost["series/rolling"][tail][m] - (Xs[tail] * win[tail]).sum(1)[m]).max())
    np.testing.assert_allclose(shost["series/rolling"][tail][m], (Xs[tail] * win[tail]).sum(1)[m], **PRED_TOL)
    # rows more than 100,000 back weigh below 1e-119 at this half life
    lo = S - 100_000
    for i in tail[m][-10:]:
        beta = _closed_form_discounted(Xs[lo:], ys[lo:], fit_s[lo:], ff, 10.0, i - lo)
        np.testing.assert_allclose(shost["series/rls"][i], Xs[i] @ beta, **PRED_TOL)
    # expanding: (X'X + I / c)^-1 X'y at the last row, and backwards from it
    A = Xs[fit_s].T @ Xs[fit_s] + np.eye(K) / 10.0
    b = Xs[fit_s].T @ ys[fit_s]
    np.testing.assert_allclose(shost["series/expanding/coef"][S - 1], np.linalg.solve(A, b), **COEF_TOL)
    for i in tail[::-1]:
        beta = np.linalg.solve(A, b)
        np.testing.assert_allclose(shost["series/expanding/coef"][i], beta, **COEF_TOL)
        if fit_s[i]:
            np.testing.assert_allclose(shost["series/expanding"][i], Xs[i] @ beta, **PRED_TOL)
            A -= np.outer(Xs[i], Xs[i])
            b -= Xs[i] * ys[i]
    if not np.isfinite(shost["series/rls"][fit_s]).all():
        raise AssertionError("series/rls: non-finite predictions after the prior's discount underflows")
    print(
        f"moving: {len(moving_queries)} grouped queries ({', '.join(moving_queries)}) at {N_ROWS} rows x "
        f"{N_GROUPS} groups and {len(series_queries)} on the first {S} rows as one series, kernel "
        f"launches={moving_launches}, host syncs={moving_syncs}, flagged rows={moving_flagged}; "
        f"{N_CHECK_GROUPS} groups match a literal Kalman recursion and a numpy lstsq per window "
        f"({oracle_s:.1f} s of numpy), the series its first {H} rows likewise and its last {T} rows "
        f"closed forms; rolling, last {T} windows of the series: max abs err {rolling_tail_err!r} "
        "against a fresh lstsq per window"
    )
    print("moving first-query s: " + json.dumps({k: round(v, 4) for k, v in first_s_mov.items()}))

    # add / subtract drift over a long history: the whole frame as one series
    # (the window sums are prefix sums of entering minus leaving products
    # from row 0 on), its last windows against a fresh lstsq each
    long_q = mv("rolling_ols", "y", xv, window_size=WINDOW)
    got = df.select(long_q)["y"].to_numpy()
    tail = np.arange(N_ROWS - T, N_ROWS)
    win, _ = _window_numpy(x, y, np.ones(N_ROWS, dtype=bool), WINDOW, K, True, rows=tail)
    want = (x[tail] * win[tail]).sum(1)
    np.testing.assert_allclose(got[tail], want, **PRED_TOL)
    med = _timed_median(lambda: df.select(long_q), torch)
    print(
        f"moving: rolling over all {N_ROWS} rows as one series, last {T} windows: max abs err "
        f"{float(np.abs(got[tail] - want).max())!r} against a fresh lstsq per window; median "
        f"{med * 1e3!r} ms a query ({smi})"
    )
    del got

    # p-values at large dof end to end: the weight column (noise) regressed
    # on the features of the series, one group of SERIES_ROWS rows
    big_stat = col("w").least_squares.ols(*xv, mode="statistics")
    got = df2.select(big_stat)["statistics"].item()
    ref = _stats_numpy(x[:S], w[:S], 0.0)
    np.testing.assert_allclose(got["coefficients"], ref["coefficients"], **COEF_TOL)
    np.testing.assert_allclose(got["t_values"], ref["t_values"], **SE_T_TOL)
    np.testing.assert_allclose(got["p_values"], ref["p_values"], **P_TOL)
    med = _timed_median(lambda: df2.select(big_stat), torch)
    print(
        f"statistics at dof {S - K}: p-values {got['p_values']!r} match scipy.stats.t at {P_TOL} "
        f"(max rel err {float(np.max(np.abs(np.asarray(got['p_values']) / ref['p_values'] - 1)))!r}); "
        f"median {med * 1e3!r} ms a query ({smi})"
    )

    # the moving kernel at the main frame: against the plain versions, timed,
    # with its bound
    Zm, vm, _ = fit._moving_cached(layout, vals, None, "drop")
    rows_m = layout.device_counts()
    counts_np = layout.counts
    idx_m = rolling.rolling_indices(vm, WINDOW, K, True)
    zero_mean = [0.0] * K
    kernel_args = {
        "rls": (Zm, vm, rows_m, vm, None, False, ff, 0.1, zero_mean),
        "rolling": (Zm, vm, rows_m, idx_m[1].contiguous(), idx_m[0].contiguous(), True, 1.0, 0.0, zero_mean),
    }
    plain_fns = {
        "rls": lambda: recursive.solve_recursive_least_squares(Zm[..., 1:], Zm[..., 0], vm, HALF_LIFE),
        "rolling": lambda: rolling.solve_rolling_ols(Zm[..., 1:], Zm[..., 0], vm, WINDOW, None, 0.0, True),
    }
    settled_m = {"rls": None, "rolling": _window_counts(vm.cpu().numpy(), WINDOW, True) >= K + SETTLED_EXTRA}
    mv_err, mv_times, mv_bound, mv_shape = {}, {}, {}, {}
    for model, args in kernel_args.items():
        out_k = moving._launch(*args, "coefficients", None, counts_np)
        mv_err[model] = _moving_diff(out_k, plain_fns[model](), counts_np, settled_m[model])
        del out_k
        mv_times[model] = _timing_fields(_in_turns({
            "plain": plain_fns[model],
            "kernel": lambda args=args: moving._launch_kernels(*args, "predictions", None, counts_np),
        }, MOVING_LAUNCHES, torch, synced=("plain",)))
        mv_bound[model] = _moving_kernel_bound(args, counts_np, K, model, torch)
        mv_shape[model] = _moving_shape(moving, Zm, counts_np, model == "rolling", dev)
        print(
            f"kernel moving {model} at the main frame: G={Zm.shape[0]} R={Zm.shape[1]} (padding "
            f"{Zm.shape[0] * Zm.shape[1] / N_ROWS - 1!r} of the rows) K={K} {json.dumps(mv_shape[model])}, "
            f"max_abs_err={mv_err[model]!r} vs plain on the coefficients; predictions: kernel_ms="
            f"{mv_times[model]['ms']!r} per launch, plain_ms="
            f"{mv_times[model]['plain_ms']!r} per call (host syncs inside), host_us="
            f"{mv_times[model]['host_us']!r}; bound {json.dumps(mv_bound[model])}; no PyTorch call "
            "computes it"
        )
    sweep = {}
    for model, args in kernel_args.items():
        for T in STRETCH_SWEEP:
            sweep[f"{model} T={T}"] = (
                lambda args=args, T=T: moving._launch_kernels(*args, "predictions", None, counts_np, T)
            )
        for L in RANGE_SWEEP:
            sweep[f"{model} L={L}"] = (
                lambda args=args, L=L: moving._launch_kernels(*args, "predictions", L, counts_np)
            )
    swept = _in_turns(sweep, SWEEP_LAUNCHES, torch)
    print(
        "kernel moving sweep at the main frame, ms per launch (T: rows a lane at the planner's "
        "rows a range; L: rows a range at the default T): "
        + json.dumps({label: t[0] for label, t in swept.items()}) + f" ({smi})"
    )
    del sweep, swept
    mv_wide = {}
    for k_wide in WIDE_K:
        mv_wide[k_wide] = _moving_frame(
            f"K={k_wide}", counts_np, Zm.shape[1], k_wide, _plain_groups(len(counts_np), Zm.shape[1], k_wide),
            moving, recursive, rolling, ff, torch, smi, seed=10 + k_wide,
            sweep={f"T={T}": (None, T) for T in WIDE_STRETCH_SWEEP.get(k_wide, ())}, phases=k_wide == 16,
        )
    skew_counts = _skewed_counts(np.random.default_rng(5), N_ROWS, N_GROUPS, SKEW_SIGMA, SKEW_CAP)
    mv_skew = _moving_frame(
        f"skewed (lognormal sizes, sigma {SKEW_SIGMA}, capped at {SKEW_CAP} rows)", skew_counts,
        int(skew_counts.max()), K, SKEW_CHECKED, moving, recursive, rolling, ff, torch, smi, seed=6,
        sweep={f"L={L}": (L, None) for L in SKEW_RANGE_SWEEP},
    )

    # 7b. predict and the formula API at full width through the public API:
    # predict of the ols coefficients (with_columns), predict under 'drop'
    # on the null columns, a static formula with an interaction, and the
    # formulas of the rls / rolling queries above; the counts of all
    # kernels set to 0 just before and read just after
    CONFIG.lazy_row_order = False
    formula_all = " + ".join(xv) + " - 1"
    moments.moments_kernel_launches = cd.cd_kernel_launches = special.t_pvalue_kernel_launches = 0
    moving.moving_kernel_launches = householder.householder_kernel_launches = 0
    jacobi.jacobi_kernel_launches = 0
    t0 = time.perf_counter()
    pred = df.with_columns(coef_expr).select(col("coefficients").least_squares.predict(*features))["predictions"]
    pred_drop = df.with_columns(ols("yn", xn, null_policy="drop", mode="coefficients").alias("cn")).select(
        col("cn").least_squares.predict(*[col(c) for c in xn], null_policy="drop")
    )["predictions"]
    f_static = df.select(col("y").least_squares.from_formula("x1 + x2 + x3:x4").over("group"))["y"]
    f_rls = df.select(col("y").least_squares.from_formula(formula_all, half_life=HALF_LIFE).over("group"))["y"]
    f_rolling = df.select(col("y").least_squares.from_formula(formula_all, window_size=WINDOW).over("group"))["y"]
    torch.cuda.synchronize()
    pf_s = time.perf_counter() - t0
    pf_launches = {
        "grouped_moments": moments.moments_kernel_launches, "moving": moving.moving_kernel_launches,
        "householder": householder.householder_kernel_launches,
        "jacobi_svd": jacobi.jacobi_kernel_launches,
    }
    if pf_launches["grouped_moments"] < 3 or pf_launches["moving"] < 2:
        raise AssertionError(f"kernel launches {pf_launches} for 3 static fits and 2 moving formulas")
    np.testing.assert_allclose(pred.to_numpy(), preds_mat, **PREDICT_TOL)
    if not torch.equal(pred_drop.validity, torch.as_tensor(valid[:, 1:].all(axis=1), device=dev)):
        raise AssertionError("predict/drop: nulls are not the rows with a null feature")
    fit_d = valid[:, 0] & valid[:, 1:].all(axis=1)
    np.testing.assert_allclose(pred_drop.to_numpy()[fit_d], out["drop"].to_numpy()[fit_d], **PREDICT_TOL)
    f_host = _picked(f_static, sel)
    at = 0
    for _, rows in group_rows:
        here = slice(at, at + len(rows))
        at += len(rows)
        Xf = np.column_stack([x[rows, 0], x[rows, 1], x[rows, 2] * x[rows, 3], np.ones(len(rows))])
        np.testing.assert_allclose(f_host[here], Xf @ _lstsq(Xf, y[rows]), err_msg="from_formula", **PRED_TOL)
    rolling_mat = df.select(moving_queries["rolling"][0])["y"]
    for label, got, want in (("rls", f_rls, rls_mat), ("rolling", f_rolling, rolling_mat)):
        # (a rolling warm-up row is a null over a NaN value, and NaN != NaN)
        same = torch.equal(torch.nan_to_num(got.values), torch.nan_to_num(want.values))
        if not (same and torch.equal(got.valid_mask(), want.valid_mask())):
            raise AssertionError(f"from_formula(..., {label}) differs from the {label} query")
    print(
        f"predict/formula: predict of the ols coefficients equals the ols predictions "
        f"(max abs diff {float(np.abs(pred.to_numpy() - preds_mat).max())!r}, {PREDICT_TOL}); "
        f"predict under 'drop' null exactly on rows with a null feature and equal to the drop fit's "
        f"predictions; from_formula('x1 + x2 + x3:x4') matches numpy lstsq on {N_CHECK_GROUPS} groups; "
        f"from_formula('{formula_all}', half_life / window_size) equal the rls / rolling queries bit "
        f"for bit; kernel launches {json.dumps(pf_launches)}; {pf_s!r} s for the five queries"
    )
    del pred, pred_drop, f_static, f_rls, f_rolling, rolling_mat

    # 8. steady-state timing, median of TIMING_REPS after one warm call
    for label, lazy in (("materialized", False), ("lazy", True)):
        CONFIG.lazy_row_order = lazy
        med = _timed_median(lambda: df.select(expr), torch)
        print(f"timing {label}: median {med * 1e3!r} ms, {N_ROWS / med!r} rows/s ({smi})")
    CONFIG.lazy_row_order = False
    for label in ("drop", "wls", "svd"):
        q = queries[label][0]
        med = _timed_median(lambda: df.select(q), torch)
        print(
            f"timing {label} (materialized): median {med * 1e3!r} ms, "
            f"{N_ROWS / med!r} rows/s, first query {first_s[label]!r} s ({smi})"
        )
    for label, q in mt_queries.items():
        med = _timed_median(lambda: df.select(q), torch)
        print(
            f"timing {label} (materialized): median {med * 1e3!r} ms, "
            f"{N_ROWS / med!r} rows/s, first query {first_s_mt[label]!r} s ({smi})"
        )
    timed = {
        "statistics (deferred rows)": lambda: df.select(stat_queries["statistics"][0]),
        "statistics (materialized)": lambda: df.select(stat_queries["statistics"][0])["statistics"].arrays,
        "lasso (materialized)": lambda: df.select(stat_queries["lasso"][0]),
        "lasso/statistics (deferred rows)": lambda: df.select(stat_queries["lasso/statistics"][0]),
    }
    for label, fn in timed.items():
        med = _timed_median(fn, torch)
        print(
            f"timing {label}: median {med * 1e3!r} ms, {N_ROWS / med!r} rows/s, "
            f"first query {first_s_stat[label.split(' ')[0]]!r} s ({smi})"
        )

    moving_timed = {
        "rls (materialized)": (df, N_ROWS, moving_queries["rls"][0], False),
        "rls (lazy)": (df, N_ROWS, moving_queries["rls"][0], True),
        "expanding (materialized)": (df, N_ROWS, moving_queries["expanding"][0], False),
        "rolling (materialized)": (df, N_ROWS, moving_queries["rolling"][0], False),
        "rolling/drop (materialized)": (df, N_ROWS, moving_queries["rolling/drop"][0], False),
        "series/rls": (df2, S, series_queries["series/rls"][0], False),
        "series/expanding": (df2, S, series_queries["series/expanding"][0], False),
        "series/rolling": (df2, S, series_queries["series/rolling"][0], False),
    }
    for label, (frame, n_frame, q, lazy) in moving_timed.items():
        CONFIG.lazy_row_order = lazy
        med = _timed_median(lambda: frame.select(q), torch)
        print(
            f"timing {label}: median {med * 1e3!r} ms, {n_frame / med!r} rows/s, "
            f"first query {first_s_mov[label.split(' ')[0]]!r} s ({smi})"
        )

    # 9. where the device time goes: torch.profiler over the main, lasso,
    # statistics, rls and rolling queries
    CONFIG.lazy_row_order = False
    for label, fn in (
        ("main (materialized)", lambda: df.select(expr)),
        ("svd (materialized)", lambda: df.select(queries["svd"][0])),
        ("multi_target (materialized)", lambda: df.select(mt_queries["multi_target"])),
        ("lasso (materialized)", timed["lasso (materialized)"]),
        ("statistics (deferred rows)", timed["statistics (deferred rows)"]),
        ("rls (materialized)", lambda: df.select(moving_queries["rls"][0])),
        ("rolling (materialized)", lambda: df.select(moving_queries["rolling"][0])),
        ("series/rolling", lambda: df2.select(series_queries["series/rolling"][0])),
    ):
        named = MOVING_KERNEL_NAMES if "rls" in label or "rolling" in label else {}
        top = 6 if label.startswith(("svd", "multi_target")) else 0
        prof = _profile(fn, torch, named, top)
        if prof is None:
            print(f"profile {label}: not measured (the profiler recorded no device activity)")
            continue
        print(
            f"profile {label}: device busy {prof['busy_ms']!r} ms, {prof['launches']!r} launches, "
            f"{prof['host_syncs']!r} host syncs a query; {prof['wall_ms']!r} ms a query under the "
            f"profiler, idle share <= {prof['idle_share']!r}; every launch traced: {prof['complete']} "
            f"(try {prof['tries']})"
            + (f"; device ms by kernel {json.dumps(prof['kernels_ms'])}, kernels "
               f"{json.dumps(prof['kernel_names'])}" if named else "")
            + (f"; top device operations, ms a query: {json.dumps(prof['top_ms'])}" if top else "")
            + f" ({smi})"
        )

    # 9b. the frame substrate at the main frame: the reference suite's
    # workflow through the public API, then warmup() and trace()
    frame_launches = _frame_phase(pt, torch, smi, {n: up[n] for n in names}, x, y, g, checked,
                                  (moments, special, cd, householder, jacobi, moving))

    # 9c. the fused select at the main frame and at "large": several fits
    # in one select share their moments, their solves and one host read
    fused_launches = _fused_phase(
        pt, torch, smi, df, {"x": x, "y": y, "y2": y2, "w": w, "g": g, "valid": valid}, checked,
        (moments, special, cd, householder, jacobi, moving),
    )

    # 9d. the sharded engine over virtual shards of the card, every family
    # held to one device; then utils.trace of the main query in a fresh
    # process
    sharded_launches = _sharded_phase(pt, torch, smi, df, g, (moments, special, cd, householder, jacobi, moving))
    _trace_fresh(torch, smi)

    # 10. the reference suite's wide configurations at full size, through
    # the public API, then the wide forms against their plain versions
    mods = (moments, householder, jacobi, moving, recursive, cd)
    large = _wide_config("large", LARGE_SHAPE, pt, col, torch, smi, mods)
    largek = _wide_config("grouped_largek", LARGEK_SHAPE, pt, col, torch, smi, mods)
    wide = _wide_kernels(pt, torch, smi, op_ms, (fit, groups, moments, householder, jacobi), large, largek)
    wide_cd = _wide_cd_kernels(torch, smi, op_ms, cd, fit, groups, large, largek)
    # the moving kernel's shared form at the two configurations' shapes (their
    # group sizes and K, rows drawn on the card): against its plain version
    # and its bound
    counts_b = groups.layout_for_columns([largek["frame"]["g"]]).counts
    R_b = int(counts_b.max())
    mv_shared = {
        "grouped_largek": _moving_frame(
            f"grouped_largek (K={largek['k']})", counts_b, R_b, largek["k"],
            _plain_groups(len(counts_b), R_b, largek["k"]), moving, recursive, rolling, ff, torch, smi, seed=40,
            phases=True,
        ),
        "large": _moving_frame(
            f"large (K={large['k']})", np.asarray([LARGE_SHAPE[0]]), LARGE_SHAPE[0], large["k"], 1, moving,
            recursive, rolling, ff, torch, smi, seed=100,
        ),
    }
    wide_launches = {
        kname: {"large": large["launches"][kname], "grouped_largek": largek["launches"][kname]}
        for kname in ("grouped_moments", "householder", "jacobi_svd", "cd_fista", "cd_cyclic_wide")
    }
    cd_rows = {
        name: {key: v for key, v in wide_cd[name].items() if key not in ("grouped_largek", "large")}
        for name in wide_cd
    }

    print(json.dumps({"kernels": [
        {
            "name": "grouped_moments",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/moments.cu",
            "replaces": "polars_ols_tpu/ops/pallas_moments.py:78",
            "launches": launches + static_launches + stat_launches["grouped_moments"]
            + frame_launches["grouped_moments"] + fused_launches["grouped_moments"]
            + sharded_launches["grouped_moments"],
            "launches_by_path": {
                "main": launches, "static": static_launches,
                "statistics_cd": stat_launches["grouped_moments"], "frame": frame_launches["grouped_moments"],
                "fused": fused_launches["grouped_moments"], "sharded": sharded_launches["grouped_moments"],
            },
            "max_abs_err": main_err,
            **main_times,
            **main_bound,
            "library_call": "torch.bmm(Zm.mT, Zm) on the pre-masked blocks: block products "
                            "only, no mask, no segment sum",
            "floor_ms": floor_ms,
        },
        {
            "name": "scale_copy",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/grid_probe.cu",
            "replaces": "experiments/pallas_grid_probe.py:19",
            "launches": probe_launches,
            "max_abs_err": probe_err,
            **probe_times,
            **probe_bound,
            "floor_ms": floor_ms,
        },
        {
            "name": "cd_cov",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/cd.cu",
            "replaces": "polars_ols_tpu/ops/cd.py:99",
            "replaces_kind": "XLA while loop, not Pallas",
            "launches": stat_launches["cd_cov"] + fused_launches["cd_cov"] + sharded_launches["cd_cov"],
            "launches_by_path": {"statistics_cd": stat_launches["cd_cov"], "fused": fused_launches["cd_cov"],
                                 "sharded": sharded_launches["cd_cov"]},
            "max_abs_err": cd_err,
            **cd_times,
            **cd_bound,
            "floor_ms": floor_ms,
        },
        {
            "name": "t_pvalue",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/t_pvalue.cu",
            "replaces": "polars_ols_tpu/ops/linalg.py:659",
            "replaces_kind": "XLA betainc, not Pallas",
            "launches": stat_launches["t_pvalue"] + frame_launches["t_pvalue"] + fused_launches["t_pvalue"]
            + sharded_launches["t_pvalue"],
            "launches_by_path": {"statistics": stat_launches["t_pvalue"], "frame": frame_launches["t_pvalue"],
                                 "fused": fused_launches["t_pvalue"], "sharded": sharded_launches["t_pvalue"]},
            "max_abs_err": p_err,
            **p_times,
            **p_bound,
            "floor_ms": floor_ms,
        },
        {
            "name": "moving",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/moving.cu",
            "replaces": "polars_ols_tpu/ops/moving.py:553",
            "replaces_kind": "XLA scans (lax.associative_scan, lax.scan) and batched solves of "
                             "ops/recursive.py:40, ops/rolling.py:41 and ops/moving.py:553,601, not Pallas",
            "launches": moving_launches + fused_launches["moving"] + sharded_launches["moving"],
            "launches_by_path": {"moving": moving_launches, "fused": fused_launches["moving"],
                                 "sharded": sharded_launches["moving"]},
            "max_abs_err": mv_err["rls"],
            **mv_times["rls"],
            **mv_bound["rls"],
            **mv_shape["rls"],
            "rolling": {
                "max_abs_err": mv_err["rolling"], **mv_times["rolling"], **mv_bound["rolling"],
                **mv_shape["rolling"],
            },
            "wide_k": {str(k): f for k, f in mv_wide.items() if k <= 8},
            "skewed": mv_skew,
            "floor_ms": floor_ms,
        },
        {
            "name": "moving, shared form (K > 8)",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/moving.cu",
            "replaces": "polars_ols_tpu/ops/moving.py:553",
            "replaces_kind": "XLA scans, not Pallas: above K = 32 the Sherman-Morrison scans of "
                             "ops/recursive.py:90 and ops/rolling.py:93 and the refined-SM lanes of "
                             "ops/moving.py:435,494 (solve_recursive_lanes :553, solve_rolling_lanes :601)",
            "launches": large["launches"]["moving (shared form)"] + largek["launches"]["moving (shared form)"],
            "launches_by_path": {
                "large": large["launches"]["moving (shared form)"],
                "grouped_largek": largek["launches"]["moving (shared form)"],
            },
            **{key: mv_shared["grouped_largek"]["rls"][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_rank1_ms", "host_us",
                "plain_groups", "range_rows", "resident_warps", "walker_threads", "phases_ms")},
            "library_ms": None,
            "grouped_largek": mv_shared["grouped_largek"],
            "large": mv_shared["large"],
            "main_frame": {str(k): f for k, f in mv_wide.items() if k > 8},
            "floor_ms": floor_ms,
        },
        {
            "name": "householder",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/householder.cu",
            "replaces": "polars_ols_tpu/ops/linalg.py:382",
            "replaces_kind": "XLA, not Pallas: _householder_reduce (:382) and its lane-major form "
                             "householder_lanes (:435) under the shared SVD",
            "launches": mt_launches + svd_launches + fused_launches["householder"] + sharded_launches["householder"],
            "launches_by_path": {
                "multi_target": mt_launches, "svd": svd_launches, "fused": fused_launches["householder"],
                "sharded": sharded_launches["householder"],
                "edges (kernel checks, not a path)": hh_edges,
            },
            **hh["multi_target"],
            "phases_ms": hh_phases["multi_target"],
            "svd_blocks": {**hh["svd"], "phases_ms": hh_phases["svd"]},
            "library_call": "torch.linalg.qr(Zx, mode='r') of the masked blocks with the feature "
                            "columns first (its first K rows are [R | Q^T Y])",
            "floor_ms": floor_ms,
        },
        {
            "name": "jacobi_svd",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/jacobi_svd.cu",
            "replaces": "polars_ols_tpu/ops/linalg.py:463",
            "replaces_kind": "XLA, not Pallas: jacobi_svd_lanes (:463) with the shrink of svd_lstsq_lanes "
                             "(:499); in the port it takes the place of cuSOLVER's batched SVD",
            "launches": mt_jacobi + svd_jacobi + stat_launches["jacobi_svd"] + fused_launches["jacobi_svd"]
            + sharded_launches["jacobi_svd"],
            "launches_by_path": {
                "multi_target": mt_jacobi, "svd": svd_jacobi, "statistics": stat_launches["jacobi_svd"],
                "fused": fused_launches["jacobi_svd"], "sharded": sharded_launches["jacobi_svd"],
                "edges (kernel checks and their timing, not a path)": jc_edges,
            },
            **jc["multi_target"],
            "phases_ms": jc_phases["multi_target"],
            "svd_factors": {**jc["svd"], "phases_ms": jc_phases["svd"]},
            "edges_timed": jc_wide,
            "library_call": "torch.linalg.svd of the factors with numpy's cutoff and the ridge shrink "
                            "(the port's route before this kernel)",
            "floor_ms": floor_ms,
        },
        {
            "name": "grouped_moments, wide form (C > 33)",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/moments.cu",
            "replaces": "polars_ols_tpu/ops/pallas_moments.py:78",
            "launches": sum(wide_launches["grouped_moments"].values()),
            "launches_by_path": wide_launches["grouped_moments"],
            **wide["grouped_moments"]["grouped_largek"],
            "large_blocks": wide["grouped_moments"]["large"],
            "library_call": "torch.bmm(Zm.mT, Zm) on the pre-masked blocks: block products only, no "
                            "mask, no segment sum",
            "floor_ms": floor_ms,
        },
        {
            "name": "householder, wide form (C > 33)",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/householder.cu",
            "replaces": "polars_ols_tpu/ops/linalg.py:382",
            "replaces_kind": "XLA, not Pallas: _householder_reduce (:382; K <= 32, or at most 4 problems "
                             "up to K = 128) and jnp.linalg.qr beyond (svd_lstsq :573)",
            "launches": sum(wide_launches["householder"].values()),
            "launches_by_path": wide_launches["householder"],
            **wide["householder"]["grouped_largek"],
            "large_blocks": wide["householder"]["large"],
            "fault_blocks": wide["householder"]["grouped_largek_fault"],
            "multi_target_blocks": wide["householder"]["grouped_largek_multi_target"],
            "tree_past_4096": wide["householder"]["past_4096"],
            "library_call": "torch.linalg.qr(Zx, mode='r') of the masked blocks with the feature "
                            "columns first",
            "floor_ms": floor_ms,
        },
        {
            "name": "jacobi_svd, wide form (K > 32, and its rows mode)",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/jacobi_svd.cu",
            "replaces": "polars_ols_tpu/ops/linalg.py:575",
            "replaces_kind": "XLA, not Pallas: jnp.linalg.svd of the K x K factor in svd_lstsq (:575) "
                             "and of X itself where n <= K (:578)",
            "launches": sum(wide_launches["jacobi_svd"].values()),
            "launches_by_path": {
                **wide_launches["jacobi_svd"],
                "grouped_largek fault query (thread form, K = 3)":
                    largek["launches"]["jacobi_svd (thread form, the fault query's K = 3)"],
            },
            **wide["jacobi_svd"]["grouped_largek"],
            "large_factor": wide["jacobi_svd"]["large"],
            "multi_target_factors": wide["jacobi_svd"]["grouped_largek_multi_target"],
            "rows_mode": wide["jacobi_svd"]["rows_mode"],
            "library_call": "torch.linalg.svd of the factors with numpy's cutoff and the ridge shrink",
            "floor_ms": floor_ms,
        },
        {
            "name": "cd_fista",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/cd_wide.cu",
            "replaces": "polars_ols_tpu/ops/cd.py:156",
            "replaces_kind": "XLA while loop, not Pallas: _cd_cov_single_fista (:156), the K >= 33 route of "
                             "solve_elastic_net_cov (:331-342); its polish _active_set_polish (:216) stays torch ops",
            "launches": sum(wide_launches["cd_fista"].values()),
            "launches_by_path": wide_launches["cd_fista"],
            **wide_cd["cd_fista"]["grouped_largek"],
            "large_moments": wide_cd["cd_fista"]["large"],
            "checks": cd_rows["cd_fista"],
            "library_call": "none: no PyTorch call computes FISTA with adaptive restart",
            "floor_ms": floor_ms,
        },
        {
            "name": "cd_cyclic_wide",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/cd_wide.cu",
            "replaces": "polars_ols_tpu/ops/cd.py:99",
            "replaces_kind": "XLA while loop, not Pallas: _cd_cov_single with active_set above K = 32 "
                             "(solve_elastic_net_cov :329-330)",
            "launches": sum(wide_launches["cd_cyclic_wide"].values()),
            "launches_by_path": wide_launches["cd_cyclic_wide"],
            **wide_cd["cd_cyclic_wide"]["grouped_largek"],
            "large_moments": wide_cd["cd_cyclic_wide"]["large"],
            "checks": cd_rows["cd_cyclic_wide"],
            "library_call": "none: no PyTorch call computes cyclic coordinate descent",
            "floor_ms": floor_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-main"]:
        sys.exit(trace_main(sys.argv[2]))
    sys.exit(main())
