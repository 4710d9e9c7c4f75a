"""Smoke run of the PyTorch/CUDA engine (polars_ols_tpu_torch) on one GPU.

Builds the hand-written CUDA kernels from this checkout (one nvcc per
source, all at once), runs the probe kernel's entry point, checks each
kernel against its plain PyTorch version on the card, drives the
grouped-OLS main path, the static fits (the five null policies, WLS,
residuals, explicit lu / qr / svd) and the statistics and
coordinate-descent queries (statistics, lasso, elastic net, NNLS, the
active-set variant) once at full width through the public API (8,000,000
rows x 5 features x 10,000 groups, f64: the workload of bench.py, with
~1 % nulls per column in half of the groups and a weight column), checks
the results against numpy and scipy, and times them.

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
(f64 34 TFLOP/s outside the tensor cores, f32 67 TFLOP/s). The edge cases
of the card-only tests (moments at C = 8 / 9, R = 513, empty groups, a grid
larger than the work; coordinate descent at K = 8 / 9 / 16 / 17) are held
to the plain versions too, and ``torch.profiler`` reads device busy time,
launches and host syncs of the main, lasso and statistics queries. The
line before the last is a JSON object with the kernels' names, sources,
launch counts on their paths, errors, times and bounds; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# outside the tensor cores, f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12
PEAK_F32_PER_S = 67e12
PROFILE_QUERIES = 5


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
    """The kernels-line fields of an _in_turns result over plain, kernel and
    (where one PyTorch call computes the same function) library."""
    return {
        "ms": times["kernel"][0], "plain_ms": times["plain"][0],
        "library_ms": times["library"][0] if "library" in times else None,
        "host_us": times["kernel"][1], "plain_host_us": times["plain"][1],
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
    multiply and one add per upper-triangle entry of each valid row."""
    S, R, C = Zp.shape
    moved = S * R * (8 * C + 1) + 8 * (G + 1) + 8 * G * C * C + 8 * G
    return _bound(moved, int(wp.sum()) * C * (C + 1), PEAK_F64_PER_S)


def _cd_bound(G, K, sweeps):
    """XtX, Xty and n_valid read once, w and the sweep counts written once;
    per sweep of a group K coordinate steps of 2K + 6 operations (the
    K-term dot, rho, the threshold, the division) and 3K for the step norm,
    over the sweeps this run's groups took."""
    moved = 8 * (G * K * K + G * K + G) + 8 * G * K + 4 * G
    return _bound(moved, int(sweeps.sum()) * K * (2 * K + 9), PEAK_F64_PER_S)


def _lentz_iterations(p, q, z):
    """Iterations the kernel's continued fraction (csrc/t_pvalue.cu:lentz)
    takes for each element: a numpy replica of its loop and its stop test."""
    tiny, eps = 1e-300, 2.0 ** -52

    def floor(v):
        return np.where(np.abs(v) < tiny, tiny, v)

    qab, qap, qam = p + q, p + 1.0, p - 1.0
    c = np.ones_like(z)
    d = 1.0 / floor(1.0 - qab * z / qap)
    count = np.zeros(z.shape, dtype=np.int64)
    running = np.ones(z.shape, dtype=bool)
    for m in range(1, 201):
        m2 = 2.0 * m
        aa = m * (q - m) * z / ((qam + m2) * (p + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        aa = -(p + m) * (qab + m) * z / ((p + m2) * (qap + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        count += running
        running &= ~(np.abs(d * c - 1.0) <= eps)
        if not running.any():
            break
    return count


def _pvalue_bound(t, dof):
    """t and dof read once, p written once. Operations: 31 adds, multiplies
    and divides per continued-fraction iteration, as many as a numpy
    replica of the kernel's loop counts for these inputs, 12 per series
    term (all 15 counted where the series branch runs), and 25 around them;
    a call of log, exp, lgamma or erfc counts as one."""
    G, K = t.shape
    t = t.cpu().numpy()
    d = np.broadcast_to(dof.cpu().numpy()[:, None], t.shape).ravel()
    t = t.ravel()
    with np.errstate(all="ignore"):
        x = d / (d + t * t)
        a = d / 2.0
        live = (a > 0) & np.isfinite(a) & (x > 0) & (x < 1)
        series = live & (a >= 15.0) & (-np.log(x) <= 1.0)
        cf = live & ~series
        direct = x < (a + 1.0) / (a + 2.5)
        iters = _lentz_iterations(
            np.where(direct, a, 0.5)[cf], np.where(direct, 0.5, a)[cf],
            np.where(direct, x, 1.0 - x)[cf],
        )
    ops = 25 * int(live.sum()) + 31 * int(iters.sum()) + 12 * 15 * int(series.sum())
    return _bound(8 * (2 * G * K + G), ops, PEAK_F64_PER_S)


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
                t = re.match(r"I(?:NS_\d+([A-Za-z]+)I)?((?:Li\d+E)+)", mangled[end:])
                if t:
                    args = ",".join(re.findall(r"Li(\d+)E", t.group(2)))
                    entry += f"<{t.group(1)}<{args}>>" if t.group(1) else f"<{args}>"
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "ptxas info" in line and "Used" in line:
            out.append((entry, line.split(":", 1)[1].strip(), spill))
    return out


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


def _random_blocks(rng, n_blocks, R, C, torch):
    """Blocks with column scales spread over decades and ~20% masked rows."""
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    wp = rng.random((S, R)) > 0.2
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    dev = torch.device("cuda")
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


def _timed_median(fn, torch) -> float:
    """Median host seconds of TIMING_REPS calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
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


def _profile(fn, torch):
    """Device busy ms (the union of device intervals), launches (launch API
    calls) and host syncs (stream / device syncs, less the loop's own) per
    query, from torch.profiler over PROFILE_QUERIES queries after a warm
    one, with the host ms per query under the profiler (which inflates it:
    the idle share 1 - busy / wall is an upper bound). None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_QUERIES):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_QUERIES
    events = prof.events()
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
    names = [e.name for e in events if e.device_type == DeviceType.CPU]
    launches = sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
                   for n in names)
    syncs = sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for n in names)
    busy_ms = busy_us / 1e3 / PROFILE_QUERIES
    return {
        "busy_ms": busy_ms, "launches": launches / PROFILE_QUERIES,
        "host_syncs": (syncs - PROFILE_QUERIES) / PROFILE_QUERIES,
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


def _check_pvalue(t_query, dof_query, special, torch):
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
    times = _timing_fields(_in_turns({
        "plain": lambda: special.t_two_sided_p_value_ref(t_query, dof_query),
        "kernel": lambda: special.t_two_sided_p_value(t_query, dof_query),
    }, PVALUE_LAUNCHES, torch, synced=("plain",)))
    print(
        f"kernel t_pvalue: {2 * G + 6} rows x 5 (query t, t/100, edges) max_abs_err={err!r} "
        f"vs plain, max rel err vs scipy={scipy_rel!r}; at the query's [{G}, 5]: "
        f"kernel_ms={times['ms']!r} per launch, plain_ms={times['plain_ms']!r} per call (host "
        f"syncs inside), host_us={times['host_us']!r} plain_host_us={times['plain_host_us']!r} "
        "per call"
    )
    return err, times


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1

    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG, col
    from polars_ols_tpu_torch.engine import fit, groups
    from polars_ols_tpu_torch.engine.native import native_loaded
    from polars_ols_tpu_torch.ops import cd, grid_probe, kernels, moments, special
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
    sources = ("moments", "grid_probe", "cd", "t_pvalue")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(kernels.build, sources))
    print(f"build: csrc/{{{','.join(sources)}}}.cu in {time.perf_counter() - t0:.3f} s")
    for name in sources:
        for entry, used, spill in _ptxas(kernels.build_log.get(name, "")):
            print(f"build {name} {entry}: {used}; {spill}")

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
    df = pt.DataFrame({**up, "group": g, **nulled})
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

    moments.moments_kernel_launches = 0
    out, first_s = {}, {}
    for label, (q, column) in queries.items():
        t0 = time.perf_counter()
        out[label] = df.select(q)[column]
        torch.cuda.synchronize()
        first_s[label] = time.perf_counter() - t0
    static_launches = moments.moments_kernel_launches
    if static_launches < len(moment_queries):
        raise AssertionError(
            f"moment kernel launched {static_launches} times for "
            f"{len(moment_queries)} moment-path queries"
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
    }
    n_stat = sum(label.endswith("statistics") for label in stat_queries)
    n_cd = sum(label.split("/")[0] in ("lasso", "elastic_net", "nnls", "cd_active_set")
               for label in stat_queries)
    if (stat_launches["grouped_moments"] < len(stat_queries) or stat_launches["cd_cov"] < n_cd
            or stat_launches["t_pvalue"] < n_stat):
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
        fit = vy & vx.all(axis=1)
        XtX_g, Xty_g, n_g = Xg.T @ Xg, Xg.T @ yg, float(len(rows))
        w_lasso = _cd_numpy(XtX_g, Xty_g, n_g, LASSO_ALPHA, 1.0)
        want = {
            "statistics": _stats_numpy(Xg, yg, 0.0),
            "ridge/statistics": _stats_numpy(Xg, yg, RIDGE_ALPHA),
            "drop/statistics": _stats_numpy(Xg[fit], yg[fit], 0.0),
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
    cd_bound = _cd_bound(N_GROUPS, N_FEATURES, cd_sweeps)
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
    p_err, p_times = _check_pvalue(t_query, dof_query, special, torch)
    p_bound = _pvalue_bound(t_query, dof_query)
    print(f"kernel t_pvalue bound at the query's [{N_GROUPS}, {N_FEATURES}]: {json.dumps(p_bound)}")

    # 7. steady-state timing, median of TIMING_REPS after one warm call
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

    # 8. where the device time goes: torch.profiler over the main, lasso and
    # statistics queries
    CONFIG.lazy_row_order = False
    for label, fn in (
        ("main (materialized)", lambda: df.select(expr)),
        ("lasso (materialized)", timed["lasso (materialized)"]),
        ("statistics (deferred rows)", timed["statistics (deferred rows)"]),
    ):
        prof = _profile(fn, torch)
        if prof is None:
            print(f"profile {label}: not measured (the profiler recorded no device activity)")
            continue
        print(
            f"profile {label}: device busy {prof['busy_ms']!r} ms, {prof['launches']!r} launches, "
            f"{prof['host_syncs']!r} host syncs a query; {prof['wall_ms']!r} ms a query under the "
            f"profiler, idle share <= {prof['idle_share']!r} ({smi})"
        )

    print(json.dumps({"kernels": [
        {
            "name": "grouped_moments",
            "route": "cuda",
            "source": "polars_ols_tpu_torch/csrc/moments.cu",
            "replaces": "polars_ols_tpu/ops/pallas_moments.py:78",
            "launches": launches + static_launches + stat_launches["grouped_moments"],
            "launches_by_path": {
                "main": launches, "static": static_launches,
                "statistics_cd": stat_launches["grouped_moments"],
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
            "launches": stat_launches["cd_cov"],
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
            "launches": stat_launches["t_pvalue"],
            "max_abs_err": p_err,
            **p_times,
            **p_bound,
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
    sys.exit(main())
