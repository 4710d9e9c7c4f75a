"""The PyTorch port on the card: the CUDA kernels against their plain
versions, and the slices on CUDA tensors against the same slices on the
CPU.

Every test here needs a CUDA device and skips (with the reason) without
one. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: kernel and plain version differ only in summation order, so
rtol 1e-12 / atol 1e-13 * max|M|; counts are integers and match exactly,
and two launches give the same bits (no atomics). The moment kernel's edges
are held the same way: C = 8 | 9 and 13 | 14 (lanes owning rows hand over
to lanes owning entries, then tiles), R = 513 and R = 37 (mask bytes not
16-aligned), R * C odd and views at odd offsets (rows 8 bytes past a
16-byte boundary), fewer blocks than the persistent grid's warps,
S = 20,000, groups without blocks.
The probe kernel doubles f32 values, which is exact: bit equality, also
on ragged, misaligned and many-tile shapes that take its plain edges. The
main-path slice on the card matches the CPU slice at the port's parity
tolerance against the JAX engine, rtol 1e-9 / atol 1e-11; the null-policy
and WLS slice at 1e-12 (the same solves; only the moment kernel's
summation order differs), with identical null masks. The coordinate-descent
kernel makes the plain version's sums in the same order from separately
rounded products: the same sweep counts and the same bits, also at the
K buckets' edges (8 | 9, 16 | 17) with group counts that leave a warp's
last groups empty. The p-value kernel runs the plain version's
arithmetic with the compiler's fused multiply-adds and the device's
``log`` / ``exp`` / ``erfc``: rtol 1e-12 to it, 1e-12 to scipy. The
statistics and lasso slices on the card match the CPU at rtol 1e-9 (the
moment kernel's summation order, through the solves). The moving kernel
sums a window's rows in another order than the plain versions' cumulative
sums and solves by its own Cholesky: rtol 1e-9 / atol 1e-11 on the
coefficients where the window holds K + 3 valid rows or alpha > 0 (a
singular window's branch is decided by round-off), an equal NaN pattern
everywhere, and the same bits from two launches. ``chunk`` sets the
rows a range: 32, 7 and 2 cut the groups into ranges (the summary pass,
the prefix and the fill; at 2 rows the prefix runs in segments). The
edges of the kernel's shape are held the same way: groups of 32 T - 1,
32 T and 32 T + 1 rows (a stretch) and T - 1, T, T + 1 (a lane's rows),
groups of one and of several ranges in one call, and K = 4 / 6 with an
odd R (rows that start 8 bytes past a 16-byte boundary). Its shared form
(K > 8) is held the same way at K = 9 .. 160 (a device-memory workspace at
160; there also over windows of 5 rows, the ridge ones against each
window solved in long double: their condition ~1e4 puts the plain
version's own rounding past the tolerance at predictions near zero), and
its register form (K <= 8) to digests
of its outputs recorded before the shared form existed, bit for bit. The Householder
kernel runs the plain version's reflections with its sums in another
order: each entry of the factor within 1e-12 of its column's norm over the
block's valid rows, NaN exactly where the plain version has it, the same
bits from two launches; at R < K, with a zero feature column, NaN in
masked slots, K = 32, and through the tree of a group of many blocks, and
at the register panel's edges (R = 510 and 37, each column bucket's ends,
R < K at K = 32). The Jacobi SVD kernel makes the plain version's
rotations with its sums in another order: each entry of a group's beta
within 1e-12 of the group's largest |beta|, NaN where the plain version
has it, the same bits from two launches; at K = 1 / 2 / 5 / 8 / 9 / 16 /
17 / 32, warps with empty segments, rank-deficient and NaN factors, alpha
and rcond, square factors and the tree's strided views; the form its C
entry picks at each K; in its thread form at every K it takes (1 .. 8) and
the segment form's first (9), with each edge kind, more targets than a
staging holds and a ragged last block; and a sweep cap at or above what
the groups need leaves the bits as they were. The multi-target and 'svd'
slices on the card match the CPU at rtol 1e-10.
The wide forms (more than 33 columns, K > 32) are held the same way: the
moments at C = 34 / 43 / 64 / 65 / 101 / 1,001 (NaN in masked slots,
views at odd offsets, groups without blocks); the Householder reduction
at the multi-target shapes that raised before (M = 40 / K = 3, M = 2 /
K = 32, M = 3 / K = 31, M = 2 / K = 40), at K = 100 with its panel in
device memory, at R < K and at R = 2,000, and through a tree; the Jacobi
SVD at K = 33 / 40 / 100 / 125 (W and V in device memory at 125) with
each edge kind, and its rows mode against numpy lstsq (rtol 1e-9). Static
fits and multi-target above 33 columns on the card match the CPU at rtol
1e-10, with identical null masks. The Householder tree of one group of
4,200 rows x 4,100 features (a level of 4,608 rows: the stacked blocks'
factors) matches its plain version and numpy lstsq.
Coordinate descent above K = 32: the FISTA and wide cyclic kernels make
their plain versions' sums in the same tree order (``fista_ref`` with
``kernel_order=True``), so they are held to the same values and iteration
or sweep counts at K = 33 .. 200 and on 10 rows x 1,000 features, with a
group without rows and a NaN group, XtX in shared or device memory; the
layout each K takes; and the lasso / elastic net / NNLS / cd_active_set
slices at K = 40 and 100 on the card match the CPU at rtol 1e-9.
The fused selects of ``chip_smoke.fused_selects`` (an alpha sweep, the JAX
suite's mix, the sweep over a collinear and an ill-conditioned group) on
the card equal the eager ones within 1e-12 and match the CPU at rtol 1e-9,
with one flag read a select.
The frame workflow of ``chip_smoke.frame_steps`` (filter, sort, unique,
join, group_by, explode around the fits) on the card matches its CPU run:
the same rows in the same order, values at rtol 1e-9, every value column
on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG, col  # noqa: E402
from polars_ols_tpu_torch.ops import (  # noqa: E402
    cd, grid_probe, householder, jacobi, moments, moving, recursive, rolling, special,
)


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    monkeypatch.setattr(cd, "cd_kernel_launches", 0)
    monkeypatch.setattr(cd, "fista_kernel_launches", 0)
    monkeypatch.setattr(cd, "cyclic_wide_kernel_launches", 0)
    monkeypatch.setattr(special, "t_pvalue_kernel_launches", 0)
    monkeypatch.setattr(moving, "moving_kernel_launches", 0)
    monkeypatch.setattr(householder, "householder_kernel_launches", 0)
    monkeypatch.setattr(jacobi, "jacobi_kernel_launches", 0)
    return torch.device("cuda")


def _blocks(seed: int, n_groups: int, R: int, C: int, device):
    rng = np.random.default_rng(seed)
    n_blocks = rng.integers(1, 8, size=n_groups)
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    wp = rng.random((S, R)) > 0.2
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    return (
        torch.as_tensor(Zp, device=device),
        torch.as_tensor(wp, device=device),
        torch.as_tensor(offsets, device=device),
        n_groups,
    )


@pytest.mark.gpu
@pytest.mark.parametrize(
    "G,R,C",
    [(2_000, 512, 6), (300, 37, 33), (1, 512, 6), (50, 100, 1), (50, 200, 22), (50, 200, 23),
     (300, 512, 8), (300, 512, 9), (300, 512, 13), (300, 512, 14), (300, 513, 6)],
)
def test_kernel_matches_plain_on_card(cuda_device, G, R, C):
    args = _blocks(G + C, G, R, C, cuda_device)
    M_k, c_k = moments.grouped_moments_blocks(*args)
    torch.cuda.synchronize()
    assert moments.moments_kernel_launches == 1
    M_p, c_p = moments.grouped_moments_blocks_ref(*args)
    scale = float(M_p.abs().max())
    np.testing.assert_allclose(
        M_k.cpu().numpy(), M_p.cpu().numpy(), rtol=1e-12, atol=1e-13 * scale
    )
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_p.cpu().numpy())
    # no atomics: a second launch gives the same bits
    M_k2, _ = moments.grouped_moments_blocks(*args)
    assert torch.equal(M_k, M_k2)


MOMENT_EDGES = {
    # id: (blocks per group, R, C, element offset of Zp, byte offset of wp)
    "r37_c33_views_at_odd_offsets": (np.full(300, 3), 37, 33, 1, 3),
    "r100_c5_views_at_odd_offsets": (np.full(300, 3), 100, 5, 1, 7),
    "s_below_grid": (np.asarray([5]), 512, 6, 0, 0),
    "s_20000": (np.full(10_000, 2), 512, 6, 0, 0),
    "empty_groups": (np.asarray([0, 3, 0, 2, 0, 0, 5, 0]), 512, 6, 0, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MOMENT_EDGES))
def test_moment_kernel_edges_on_card(cuda_device, case):
    n_blocks, R, C, z_off, w_off = MOMENT_EDGES[case]
    rng = np.random.default_rng(len(case))
    S, G = int(n_blocks.sum()), len(n_blocks)
    Z = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    W = rng.random((S, R)) > 0.2
    Z[~W] = np.nan  # a masked row is selected away, never multiplied
    Zp = torch.empty(S * R * C + z_off, dtype=torch.float64, device=cuda_device)[z_off:].view(S, R, C)
    wp = torch.empty(S * R + w_off, dtype=torch.bool, device=cuda_device)[w_off:].view(S, R)
    Zp.copy_(torch.as_tensor(Z))
    wp.copy_(torch.as_tensor(W))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(n_blocks)]), device=cuda_device)
    M_k, c_k = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    M_k2, c_k2 = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    torch.cuda.synchronize()
    assert moments.moments_kernel_launches == 2
    assert torch.equal(M_k, M_k2) and torch.equal(c_k, c_k2)
    M_p, c_p = moments.grouped_moments_blocks_ref(Zp, wp, offsets, G)
    M_k, M_p = M_k.cpu().numpy(), M_p.cpu().numpy()
    assert np.isfinite(M_k).all()
    np.testing.assert_allclose(M_k, M_p, rtol=1e-12, atol=1e-13 * float(np.abs(M_p).max()))
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_p.cpu().numpy())
    empty = n_blocks == 0
    assert (M_k[empty] == 0).all() and (c_k.cpu().numpy()[empty] == 0).all()


@pytest.mark.gpu
def test_empty_kernel_launches_on_card(cuda_device):
    grid_probe.empty_launch(cuda_device)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_rejects_tensors_on_two_devices(cuda_device):
    Zp, wp, offsets, G = _blocks(0, 4, 16, 3, cuda_device)
    with pytest.raises(ValueError, match="one device"):
        moments.grouped_moments_blocks(Zp, wp, offsets.cpu(), G)
    assert moments.moments_kernel_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("lazy", [True, False])
def test_slice_on_card_matches_cpu(cuda_device, lazy, monkeypatch):
    rng = np.random.default_rng(8)
    n, k, g = 20_000, 4, 37
    X = rng.normal(size=(n, k))
    cols = {
        "y": X @ np.arange(1.0, k + 1) + 0.1 * rng.normal(size=n),
        **{f"x{i + 1}": X[:, i] for i in range(k)},
        "g": rng.integers(g, size=n).astype(float),
    }
    monkeypatch.setattr(CONFIG, "lazy_row_order", lazy)
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", 128)
    expr = col("y").least_squares.ols(col("^x.*$")).over("g")
    monkeypatch.setattr(CONFIG, "device", "cpu")
    cpu = pt.DataFrame(cols).select(expr)["y"].to_numpy()
    monkeypatch.setattr(CONFIG, "device", "cuda")
    out = pt.DataFrame(cols).select(expr)["y"]
    assert out.is_lazy == lazy
    gpu = out.to_numpy()
    assert moments.moments_kernel_launches == 1
    np.testing.assert_allclose(gpu, cpu, rtol=1e-9, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("block_rows", [None, 256])
def test_probe_kernel_doubles_exactly_on_card(cuda_device, block_rows, monkeypatch):
    monkeypatch.setattr(grid_probe, "scale_copy_launches", 0)
    x = torch.arange(2048 * 256, dtype=torch.float32, device=cuda_device).reshape(2048, 256)
    if block_rows is None:
        x = x[:256]  # the ungridded form: one [256, 256] tile
    out = grid_probe.scale_copy(x, block_rows)
    torch.cuda.synchronize()
    assert grid_probe.scale_copy_launches == 1
    assert torch.equal(out, x * 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case,rows,cols,block_rows",
    [
        ("ragged", 300, 7, 100),  # a tile of one partial chunk
        ("misaligned", 2048, 256, 256),  # 4 bytes past a 16-byte boundary
        ("odd_tiles", 999, 33, 333),  # unaligned edges at every tile
        ("many_tiles", 70_000, 4, 1),  # more tiles than the grid's y limit
    ],
)
def test_probe_kernel_edges_on_card(cuda_device, case, rows, cols, block_rows, monkeypatch):
    monkeypatch.setattr(grid_probe, "scale_copy_launches", 0)
    flat = torch.arange(rows * cols + 1, dtype=torch.float32, device=cuda_device)
    x = (flat[1:] if case == "misaligned" else flat[:-1]).view(rows, cols)
    assert (x.data_ptr() % 16 != 0) == (case == "misaligned")
    out = grid_probe.scale_copy(x, block_rows)
    torch.cuda.synchronize()
    assert grid_probe.scale_copy_launches == 1
    assert torch.equal(out, x * 2.0)


def _static_frame(n=20_000, k=4, g=37, seed=9):
    """Columns with ~2 % nulls per column (row 0 valid) and a weight column
    with one null."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    valid = rng.random((n, 1 + k)) > 0.02
    valid[0] = True
    w_valid = np.ones(n, dtype=bool)
    w_valid[3] = False
    return {
        "y": pt.Series("y", X @ np.arange(1.0, k + 1) + 0.1 * rng.normal(size=n), valid[:, 0]),
        **{f"x{i + 1}": pt.Series(f"x{i + 1}", X[:, i], valid[:, 1 + i]) for i in range(k)},
        "w": pt.Series("w", rng.random(n) + 0.1, w_valid),
        "g": rng.integers(g, size=n).astype(float),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["drop", "wls", "drop_coefficients"])
def test_static_slice_on_card_matches_cpu(cuda_device, query, monkeypatch):
    kw = {"drop": dict(null_policy="drop"), "wls": dict(null_policy="drop", sample_weights="w"),
          "drop_coefficients": dict(null_policy="drop", mode="coefficients")}[query]
    column = "coefficients" if query == "drop_coefficients" else "y"
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", 128)
    expr = col("y").least_squares.ols(col("^x.*$"), **kw).over("g")
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        s = pt.DataFrame(_static_frame()).select(expr)[column]
        valid = s.validity
        out[dev] = (s.values.cpu().numpy(), None if valid is None else valid.cpu().numpy())
    assert moments.moments_kernel_launches == 1
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    m = np.ones(out["cpu"][0].shape, bool) if out["cpu"][1] is None else out["cpu"][1]
    np.testing.assert_allclose(out["cuda"][0][m], out["cpu"][0][m], rtol=1e-12, atol=1e-12)


def _cd_moments(seed: int, G: int, K: int, device, empty_group: bool = False):
    """Per-group moments of random groups of 5..200 rows with correlated
    features; one group without rows when ``empty_group``."""
    rng = np.random.default_rng(seed)
    XtX = np.zeros((G, K, K))
    Xty = np.zeros((G, K))
    n = rng.integers(5, 200, size=G).astype(float)
    for g in range(G):
        X = rng.normal(size=(int(n[g]), K)) @ (np.eye(K) + 0.3 * rng.normal(size=(K, K)))
        y = X @ (rng.normal(size=K) * (rng.random(K) > 0.5)) + rng.normal(size=int(n[g]))
        XtX[g], Xty[g] = X.T @ X, X.T @ y
    if empty_group:
        XtX[0], Xty[0], n[0] = 0.0, 0.0, 0.0
    return tuple(torch.as_tensor(a, device=device) for a in (XtX, Xty, n))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "G,K,kw",
    [
        (10_000, 5, dict(alpha=0.05, l1_ratio=1.0)),
        (1001, 5, dict(alpha=0.05, l1_ratio=0.5, positive=True)),
        (1001, 5, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
        (1, 5, dict(alpha=0.05, l1_ratio=1.0)),
        (333, 1, dict(alpha=0.2, l1_ratio=1.0)),
        (64, 32, dict(alpha=0.1, l1_ratio=0.7, max_iter=40)),  # plain: ~1,100 launches a sweep
        (64, 32, dict(alpha=0.01, l1_ratio=1.0, max_iter=3)),
        # the K buckets' edges, G no multiple of the groups a warp holds
        (1001, 8, dict(alpha=0.05, l1_ratio=0.8)),
        (1001, 9, dict(alpha=0.05, l1_ratio=0.8, positive=True)),
        (1003, 16, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
        (1003, 17, dict(alpha=0.05, l1_ratio=0.7)),
    ],
    ids=["main", "positive", "active_set", "one_group", "k1", "k32", "max_iter",
         "k8", "k9", "k16", "k17"],
)
def test_cd_kernel_matches_plain_on_card(cuda_device, G, K, kw):
    XtX, Xty, n = _cd_moments(G + K, G, K, cuda_device, empty_group=G > 1)
    w_k, s_k = cd.solve_elastic_net_cov(XtX, Xty, n, **kw)
    torch.cuda.synchronize()
    assert cd.cd_kernel_launches == 1
    w_p, s_p = cd.solve_elastic_net_cov_ref(XtX, Xty, n, **kw)
    np.testing.assert_array_equal(s_k.cpu().numpy(), s_p.cpu().numpy())
    np.testing.assert_array_equal(w_k.cpu().numpy(), w_p.cpu().numpy())
    if G > 1:  # the group without rows: zero coefficients after one sweep
        assert float(w_k[0].abs().max()) == 0.0 and int(s_k[0]) == 1
    if "max_iter" in kw:
        assert int(s_k.max()) == kw["max_iter"]


def _pvalue_inputs(device, G, K):
    """t [G, K] and dof [G]: dof from 1 to 8e6, |t| from 1e-3 to 40, and
    with G >= 6, K >= 5 the edge rows (t = 0, dof <= 0, a NaN t or dof)."""
    rng = np.random.default_rng(3 + G + K)
    dof = np.exp(rng.uniform(0.0, np.log(8e6), G))
    t = np.exp(rng.uniform(np.log(1e-3), np.log(40.0), (G, K))) * rng.choice([-1.0, 1.0], (G, K))
    edges = G >= 6 and K >= 5
    if edges:
        dof[:3] = (1.0, 2.5, 8e6)
        t[:3, 0] = 0.0
        t[3, :5] = (0.0, 1.0, np.nan, np.inf, 2.0)
        dof[3:6] = (0.0, -1.0, np.nan)
    return torch.as_tensor(t, device=device), torch.as_tensor(dof, device=device), edges


@pytest.mark.gpu
@pytest.mark.parametrize(
    "G,K", [(2_000, 5), (1, 1), (1, 32), (2_001, 32), (37, 1)],
    ids=["edges", "one", "one_group_k32", "ragged_k32", "k1"],
)
def test_pvalue_kernel_matches_plain_and_scipy_on_card(cuda_device, G, K):
    special_fns = pytest.importorskip("scipy.special")
    t, dof, edges = _pvalue_inputs(cuda_device, G, K)
    p_k = special.t_two_sided_p_value(t, dof)
    torch.cuda.synchronize()
    assert special.t_pvalue_kernel_launches == 1
    p_p = special.t_two_sided_p_value_ref(t, dof).cpu().numpy()
    p_k = p_k.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(p_k), np.isnan(p_p))
    np.testing.assert_allclose(p_k, p_p, rtol=1e-12, atol=0)
    tn, dn = t.cpu().numpy(), dof.cpu().numpy()[:, None]
    with np.errstate(invalid="ignore"):
        x = dn / (dn + tn * tn)
    ok = (dn > 0) & np.isfinite(x)
    ref = special_fns.betainc(np.broadcast_to(dn / 2, x.shape)[ok], 0.5, x[ok])
    np.testing.assert_allclose(p_k[ok], ref, rtol=1e-12, atol=1e-300)
    if edges:
        assert (p_k[:3, 0] == 1.0).all()  # t = 0
        assert np.isnan(p_k[3, 2]) and np.isnan(p_k[4]).all() and np.isnan(p_k[5]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["statistics", "lasso_statistics", "lasso"])
def test_statistics_and_lasso_slices_on_card_match_cpu(cuda_device, query, monkeypatch):
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", 128)
    feats = [col(f"x{i + 1}") for i in range(4)]
    kw = {"statistics": dict(mode="statistics"),
          "lasso_statistics": dict(alpha=0.01, l1_ratio=1.0, mode="statistics"),
          "lasso": dict(alpha=0.01, l1_ratio=1.0, null_policy="drop")}[query]
    expr = col("y").least_squares.ols(*feats, **kw).over("g")
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        s = pt.DataFrame(_static_frame()).select(expr)[
            "statistics" if "statistics" in query else "y"
        ]
        if "statistics" in query:
            out[dev] = {k: v.cpu().numpy() for k, v in s.arrays.items()}
        else:
            out[dev] = {"y": s.to_numpy()}
    assert moments.moments_kernel_launches == 1
    assert cd.cd_kernel_launches == (0 if query == "statistics" else 1)
    assert special.t_pvalue_kernel_launches == (1 if "statistics" in query else 0)
    for key, ref in out["cpu"].items():
        np.testing.assert_array_equal(np.isnan(out["cuda"][key]), np.isnan(ref), err_msg=key)
        np.testing.assert_allclose(out["cuda"][key], ref, rtol=1e-9, atol=1e-12, err_msg=key)


# --------------------------------------------------------------------------- #
# the moving kernel
# --------------------------------------------------------------------------- #
def _moving_batch(seed: int, k: int, device, r: int = 300):
    """Five groups: full, shorter than most windows, empty, one row, ragged;
    ~5 % invalid rows."""
    rng = np.random.default_rng(seed)
    rows = np.asarray([r, 40, 0, 1, r - 13])
    G = len(rows)
    X = rng.normal(size=(G, r, k)) * np.resize([1.0, 3.0, 0.3], k)
    y = X.sum(-1) + rng.normal(size=(G, r)) * 0.1
    v = (rng.random((G, r)) > 0.05) & (np.arange(r)[None] < rows[:, None])
    Z = np.concatenate([y[..., None], X], axis=-1)
    return (
        torch.as_tensor(Z, device=device), torch.as_tensor(v, device=device),
        torch.as_tensor(rows, device=device), rows,
    )


def _assert_moving(out, ref, rows, settled=None):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    for g, n in enumerate(rows):
        a, b = out[g, :n], ref[g, :n]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(b)
        if settled is not None:
            m &= settled[g, :n].reshape((-1,) + (1,) * (a.ndim - 1))
        np.testing.assert_allclose(a[m], b[m], rtol=1e-9, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("chunk", [None, 32, 7, 2])
@pytest.mark.parametrize("half_life,mean", [(252.0, None), (None, None), (3.0, 0.5), (None, "list")])
@pytest.mark.parametrize("k", [5, 8, 9, 16, 17, 32])
def test_moving_kernel_rls_matches_plain_on_card(cuda_device, k, half_life, mean, chunk, want):
    Z, v, rows_t, rows = _moving_batch(k, k, cuda_device)
    m = list(np.linspace(-1.0, 1.0, k)) if mean == "list" else mean
    out = moving.recursive_least_squares(Z, v, rows_t, half_life, 10.0, m, want=want, chunk=chunk)
    torch.cuda.synchronize()
    assert moving.moving_kernel_launches == 1
    coefs = recursive.solve_recursive_least_squares(Z[..., 1:], Z[..., 0], v, half_life, 10.0, m)
    _assert_moving(out, moving._from_coefs(coefs, Z, want), rows)
    again = moving.recursive_least_squares(Z, v, rows_t, half_life, 10.0, m, want=want, chunk=chunk)
    for g, n in enumerate(rows):
        assert torch.equal(out[g, :n], again[g, :n])


@pytest.mark.gpu
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("chunk", [None, 32, 7, 2])
@pytest.mark.parametrize("positional", [True, False])
@pytest.mark.parametrize("window,min_periods,alpha", [
    (252, None, 0.0), (252, 2, 0.1), (5, None, 0.1), (5, 2, 0.1), (40, None, 0.0), (40, 2, 0.0),
])
@pytest.mark.parametrize("k", [5, 8, 9, 16, 17, 32])
def test_moving_kernel_rolling_matches_plain_on_card(
    cuda_device, k, window, min_periods, alpha, positional, chunk, want
):
    Z, v, rows_t, rows = _moving_batch(100 + k, k, cuda_device)
    out = moving.rolling_ols(
        Z, v, rows_t, window, min_periods, alpha, positional, want=want, chunk=chunk
    )
    torch.cuda.synchronize()
    assert moving.moving_kernel_launches == 1
    coefs = rolling.solve_rolling_ols(Z[..., 1:], Z[..., 0], v, window, min_periods, alpha, positional)
    settled = None
    if alpha == 0.0:
        vn = v.cpu().numpy()
        r = np.cumsum(vn, axis=1)
        if positional:
            shifted = np.concatenate([np.zeros((len(rows), window), dtype=r.dtype), r], axis=1)
            counts = r - shifted[:, : vn.shape[1]]
        else:
            counts = np.minimum(r, window)
        settled = counts >= k + 3
    _assert_moving(out, moving._from_coefs(coefs, Z, want), rows, settled)
    again = moving.rolling_ols(
        Z, v, rows_t, window, min_periods, alpha, positional, want=want, chunk=chunk
    )
    for g, n in enumerate(rows):
        a, b = out[g, :n], again[g, :n]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 9, 16, 40, 100])
def test_moving_kernel_flagged_rows_take_the_eigh_solve_on_card(cuda_device, k, monkeypatch):
    monkeypatch.setattr(moving, "moving_flagged_rows", 0)
    Z, v, rows_t, rows = _moving_batch(200 + k, k, cuda_device, r=90)
    Z[..., 2] = 0.0  # an all-zero feature: every window's Cholesky meets a zero pivot
    for chunk in (None, 16):
        for want in moving.WANTS:
            out = moving.rolling_ols(Z, v, rows_t, 20, None, 0.0, True, want=want, chunk=chunk)
            coefs = rolling.solve_rolling_ols(Z[..., 1:], Z[..., 0], v, 20, None, 0.0, True)
            vn = v.cpu().numpy()
            r = np.cumsum(vn, axis=1)
            shifted = np.concatenate([np.zeros((len(rows), 20), dtype=r.dtype), r], axis=1)
            _assert_moving(out, moving._from_coefs(coefs, Z, want), rows, r - shifted[:, :90] >= k + 3)
    assert moving.moving_flagged_rows > 0


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["rls", "rolling_ols", "expanding_ols"])
@pytest.mark.parametrize("mode", ["predictions", "residuals", "coefficients"])
def test_moving_slices_on_card_match_cpu(cuda_device, model, mode, monkeypatch):
    feats = [col(f"x{i + 1}") for i in range(4)]
    kw = dict(window_size=30, min_periods=12) if model == "rolling_ols" else {}
    expr = getattr(col("y").least_squares, model)(*feats, mode=mode, null_policy="drop", **kw)
    out = {}
    for grouped in (True, False):
        for dev in ("cpu", "cuda"):
            monkeypatch.setattr(CONFIG, "device", dev)
            s = pt.DataFrame(_static_frame()).select(expr.over("g") if grouped else expr)[
                "coefficients" if mode == "coefficients" else "y"
            ]
            out[dev] = s.to_numpy()
        np.testing.assert_array_equal(np.isnan(out["cuda"]), np.isnan(out["cpu"]))
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-7, atol=1e-9)
    assert moving.moving_kernel_launches == 2


def _sized_batch(seed: int, k: int, sizes, R: int, device):
    """Groups of the given sizes padded to R rows; ~5 % invalid rows."""
    rng = np.random.default_rng(seed)
    rows = np.asarray(sizes)
    G = len(rows)
    X = rng.normal(size=(G, R, k)) * np.resize([1.0, 3.0, 0.3], k)
    y = X.sum(-1) + rng.normal(size=(G, R)) * 0.1
    v = (rng.random((G, R)) > 0.05) & (np.arange(R)[None] < rows[:, None])
    Z = np.concatenate([y[..., None], X], axis=-1)
    return (
        torch.as_tensor(Z, device=device), torch.as_tensor(v, device=device),
        torch.as_tensor(rows, device=device), rows,
    )


def _moving_both(model, Z, v, rows_t, k, want, chunk):
    """The kernel's result, the plain version's and where to compare values."""
    if model == "rls":
        out = moving.recursive_least_squares(Z, v, rows_t, 20.0, 10.0, 0.5, want=want, chunk=chunk)
        coefs = recursive.solve_recursive_least_squares(Z[..., 1:], Z[..., 0], v, 20.0, 10.0, 0.5)
        return out, moving._from_coefs(coefs, Z, want), None
    out = moving.rolling_ols(Z, v, rows_t, 30, None, 0.0, True, want=want, chunk=chunk)
    coefs = rolling.solve_rolling_ols(Z[..., 1:], Z[..., 0], v, 30, None, 0.0, True)
    vn = v.cpu().numpy()
    r = np.cumsum(vn, axis=1)
    shifted = np.concatenate([np.zeros((vn.shape[0], 30), dtype=r.dtype), r], axis=1)
    return out, moving._from_coefs(coefs, Z, want), r - shifted[:, : vn.shape[1]] >= k + 3


@pytest.mark.gpu
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("chunk", [None, 200])
@pytest.mark.parametrize("model", ["rls", "rolling"])
@pytest.mark.parametrize("k,R", [(5, 331), (4, 331), (6, 333), (8, 201)])
def test_moving_kernel_stretch_and_range_edges_on_card(cuda_device, k, R, model, chunk, want):
    T = moving.stretch_rows(k, model == "rolling")
    S = moving.LANES * T
    sizes = [min(n, R) for n in (S - 1, S, S + 1, T - 1, T, T + 1, 1, 0, R, 2 * S + 1)]
    Z, v, rows_t, rows = _sized_batch(300 + k, k, sizes, R, cuda_device)
    out, ref, settled = _moving_both(model, Z, v, rows_t, k, want, chunk)
    torch.cuda.synchronize()
    assert moving.moving_kernel_launches == 1
    _assert_moving(out, ref, rows, settled)
    again, _, _ = _moving_both(model, Z, v, rows_t, k, want, chunk)
    for g, n in enumerate(rows):
        a, b = out[g, :n], again[g, :n]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.gpu
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("model", ["rls", "rolling"])
def test_moving_kernel_long_and_short_groups_on_card(cuda_device, model, want):
    # at the planner's own rows a range (one stretch on a frame this small)
    # the long group is cut into more ranges than a segment of the prefix
    # holds; most short ones are one range each
    sizes = [6_000, 100, 0, 3, 161, 1]
    Z, v, rows_t, rows = _sized_batch(400, 5, sizes, 6_000, cuda_device)
    plan = moving.plan_ranges(rows, moving.stretch_rows(5, model == "rolling"), 10**9)
    assert plan.M > moving.SEGMENT_RANGES and (np.asarray(sizes) <= plan.L).sum() >= 3
    out, ref, settled = _moving_both(model, Z, v, rows_t, 5, want, None)
    _assert_moving(out, ref, rows, settled)


def _shared_batch(seed: int, k: int, device):
    """Groups for the shared form: longer than four stretches, 3 K rows,
    40, none, one, ragged; ~5 % invalid rows."""
    r = max(300, 4 * k)
    return _sized_batch(seed, k, [r, 3 * k, 40, 0, 1, r - 13], r, device)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 32], ids=["one_range", "ranges_of_32"])
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("model", ["rls", "rolling", "rolling_ridge"])
@pytest.mark.parametrize("k", [9, 12, 16, 24, 32, 33, 40, 48, 49, 64, 100, 101, 160])
def test_moving_shared_form_matches_plain_on_card(cuda_device, k, model, want, chunk):
    # the shared form (K > 8: a block of warps walks a range's stretches, a
    # warp a run of rows from its start state, the factor in registers up
    # to K = 48 and in shared memory from 49, the states and factor in a
    # device-memory workspace from K = 101) against the plain versions at
    # MOVING_KERNEL_TOL, equal NaN patterns, the same bits from two
    # launches; groups of one range, and cut into ranges of 32 rows (the
    # summary pass, the prefix, the fill)
    Z, v, rows_t, rows = _shared_batch(600 + k, k, cuda_device)
    assert (moving.shared_layout(k, model != "rls", 1)[0] > 0) == (k > 100)
    X, y = Z[..., 1:], Z[..., 0]
    settled = None
    if model == "rls":
        mean = list(np.linspace(-0.5, 0.5, k))
        run = lambda: moving.recursive_least_squares(Z, v, rows_t, 252.0, 10.0, mean, want=want, chunk=chunk)
        coefs = recursive.solve_recursive_least_squares(X, y, v, 252.0, 10.0, mean)
    else:
        window, alpha = 2 * k + 20, (0.0 if model == "rolling" else 0.1)
        run = lambda: moving.rolling_ols(Z, v, rows_t, window, None, alpha, True, want=want, chunk=chunk)
        coefs = rolling.solve_rolling_ols(X, y, v, window, None, alpha, True)
        if alpha == 0.0:
            settled = cs._window_counts(v.cpu().numpy(), window, True) >= k + cs.SETTLED_EXTRA
    out = run()
    again = run()
    torch.cuda.synchronize()
    assert moving.moving_kernel_launches == 2
    _assert_moving(out, moving._from_coefs(coefs, Z, want), rows, settled)
    for g, n in enumerate(rows):
        a, b = out[g, :n], again[g, :n]
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 32], ids=["one_range", "ranges_of_32"])
@pytest.mark.parametrize("want", moving.WANTS)
@pytest.mark.parametrize("positional", [True, False], ids=["positional", "valid_rank"])
@pytest.mark.parametrize("min_periods,alpha", [(None, 0.1), (2, 0.1), (2, 0.0)])
def test_moving_shared_form_short_windows_in_the_workspace_on_card(
    cuda_device, min_periods, alpha, positional, want, chunk
):
    # K = 160 (the state and factor in the device-memory workspace) over
    # windows of 5 rows. Ridge systems of rank 5 plus alpha I (condition
    # ~1e4): the plain version's own rounding sits up to ~1e-10 from the
    # exact predictions, which MOVING_KERNEL_TOL does not hold where a
    # prediction is near zero, so the kernel's values are held at that
    # tolerance to chip_smoke._ridge_exact (each window solved in long
    # double) and its NaN pattern to the plain version's. At alpha 0 the
    # windows are singular (flagged, re-solved by eigh): the plain
    # version's NaN pattern, as everywhere a window holds fewer than
    # K + SETTLED_EXTRA rows
    k, window = 160, 5
    Z, v, rows_t, rows = _shared_batch(600 + k, k, cuda_device)
    assert moving.shared_layout(k, True, 1)[0] > 0
    coefs = rolling.solve_rolling_ols(Z[..., 1:], Z[..., 0], v, window, min_periods, alpha, positional)
    out = moving.rolling_ols(Z, v, rows_t, window, min_periods, alpha, positional, want=want, chunk=chunk)
    vn = v.cpu().numpy()
    settled = cs._window_counts(vn, window, positional) >= k + cs.SETTLED_EXTRA
    _assert_moving(out, moving._from_coefs(coefs, Z, want), rows, settled)
    if alpha > 0:
        exact = cs._ridge_exact(Z.cpu().numpy(), vn, rows, window, min_periods, alpha, positional, want)
        _assert_moving(out, torch.as_tensor(exact), rows)


@pytest.mark.gpu
def test_moving_register_form_keeps_its_bits_on_card(cuda_device):
    # K = 1 .. 8 (the register form) give the same bits as before the
    # shared form replaced the local-memory buckets: digests of every
    # output of chip_smoke._register_digests, recorded from the earlier
    # kernel on an H100 (chip_smoke.REGISTER_FORM_DIGESTS)
    assert cs._register_digests(moving, torch) == cs.REGISTER_FORM_DIGESTS



HOUSEHOLDER_CASES = {
    # id: (blocks, R, C, K, zero feature column, NaN in the masked slots)
    "main_path_c6": (2_000, 512, 6, 5, None, False),
    "multi_target_c7": (2_000, 512, 7, 5, None, False),
    "r_below_k": (300, 3, 8, 5, None, False),
    "zero_feature_column": (300, 512, 6, 5, 3, False),
    "nan_in_masked_slots": (300, 512, 7, 5, None, True),
    "k32_m1": (100, 512, 33, 32, None, False),
    "r37_c9": (300, 37, 9, 7, None, False),
    "r10_tree_level": (1_000, 10, 6, 5, None, False),
    # the register panel's edges: the tree's second level (R = 510, not a
    # multiple of the 128 threads' rows), rows that leave threads without a
    # row, each column bucket (C <= 8, <= 16, <= 33) at its ends, R < K at K = 32
    "r510_second_level": (500, 510, 7, 5, None, False),
    "r37_c7": (300, 37, 7, 5, None, False),
    "c2_k1": (300, 512, 2, 1, None, False),
    "c9_k8": (300, 300, 9, 8, 7, False),
    "c16_k14": (300, 256, 16, 14, None, True),
    "c17_k16": (200, 512, 17, 16, None, False),
    "c33_r37": (100, 37, 33, 32, 31, False),
    "c33_r20_below_k": (100, 20, 33, 32, None, True),
}


def _assert_reduction(T_k, T_p, Z, w):
    """Kernel against plain version: the same reflections, sums in another
    order: each entry within 1e-12 of its column's norm over the block's
    valid rows, NaN where the plain version has it."""
    norm = torch.where(w[..., None], Z, 0.0).square().sum(dim=1, keepdim=True).sqrt()
    nan = torch.isnan(T_p)
    assert torch.equal(torch.isnan(T_k), nan)
    err = torch.where(nan, 0.0, (T_k - T_p).abs())
    assert bool((err <= 1e-12 * norm).all()), float((err / norm.clamp_min(1e-300)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HOUSEHOLDER_CASES))
def test_householder_kernel_matches_plain_on_card(cuda_device, case):
    B, R, C, K, zero_col, nan_masked = HOUSEHOLDER_CASES[case]
    rng = np.random.default_rng(len(case))
    Z = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    W = rng.random((B, R)) > 0.2
    if zero_col is not None:
        Z[:, :, C - K + zero_col] = 0.0
    if nan_masked:
        Z[~W] = np.nan
    Zt, wt = torch.as_tensor(Z, device=cuda_device), torch.as_tensor(W, device=cuda_device)
    T_k = householder.householder_blocks(Zt, wt, K)
    T_k2 = householder.householder_blocks(Zt, wt, K)
    torch.cuda.synchronize()
    assert householder.householder_kernel_launches == 2
    assert torch.equal(T_k, T_k2) or torch.equal(torch.isnan(T_k), torch.isnan(T_k2))
    T_p = householder.householder_blocks_ref(Zt, wt, K)
    _assert_reduction(T_k, T_p, Zt, wt)
    if nan_masked:
        assert bool(torch.isfinite(T_k).all())
    if R < K:
        assert bool((T_k[:, R:] == 0).all())


@pytest.mark.gpu
def test_householder_tree_matches_plain_on_card(cuda_device):
    # one group of 200,000 rows (391 blocks of 512: three launches) and
    # groups of one, two and 150 blocks
    rng = np.random.default_rng(3)
    n_blocks = np.asarray([391, 1, 2, 150, 1])
    S, K, C = int(n_blocks.sum()), 5, 7
    Z = torch.as_tensor(rng.normal(size=(S, 512, C)), device=cuda_device)
    w = torch.as_tensor(rng.random((S, 512)) > 0.1, device=cuda_device)
    plan = householder.plan_reduction(n_blocks, K, cuda_device)
    assert len(plan.levels) == 2
    T_k = householder.reduce_groups(Z, w, K, plan)
    torch.cuda.synchronize()
    assert householder.householder_kernel_launches == 3
    plan_cpu = householder.plan_reduction(n_blocks, K)
    T_p = householder.reduce_groups(Z.cpu(), w.cpu(), K, plan_cpu)
    norm = torch.where(w[..., None], Z, 0.0).square().sum(dim=(0, 1)).sqrt().cpu()
    assert bool(((T_k.cpu() - T_p).abs() <= 1e-11 * norm).all())


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["multi_target", "multi_target_drop_weighted", "svd", "svd_single"])
def test_householder_slices_on_card_match_cpu(cuda_device, query, monkeypatch):
    feats = [col(f"x{i + 1}") for i in range(4)]
    target = pt.struct(col("y"), col("w"))
    expr = {
        "multi_target": target.least_squares.multi_target_ols(*feats).over("g"),
        "multi_target_drop_weighted": target.least_squares.multi_target_ols(
            *feats, null_policy="drop", sample_weights="w", mode="residuals"
        ).over("g"),
        "svd": col("y").least_squares.ols(*feats, solve_method="svd", null_policy="zero").over("g"),
        "svd_single": col("y").least_squares.ols(*feats, solve_method="svd", null_policy="drop"),
    }[query]
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", 128)
    monkeypatch.setattr(CONFIG, "lazy_row_order", False)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        s = pt.DataFrame(_static_frame()).select(expr)
        c = s[s.columns[0]]
        out[dev] = (c.to_numpy(), None if c.validity is None else c.validity.cpu().numpy())
    assert householder.householder_kernel_launches >= 1 and jacobi.jacobi_kernel_launches >= 1
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-10, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("reflections", [0, 1, 3])
def test_householder_phases_stop_after_their_reflections(cuda_device, reflections):
    # the phase entry (chip_smoke.py times it): after 0 reflections, the
    # load and the store alone give the masked panel's first K rows; after
    # r, rows 0 .. r - 1 are final, the full reduction's first r rows
    rng = np.random.default_rng(reflections)
    B, R, C, K = 200, 300, 7, 5
    Z = torch.as_tensor(rng.normal(size=(B, R, C)), device=cuda_device)
    w = torch.as_tensor(rng.random((B, R)) > 0.2, device=cuda_device)
    T = householder._launch(Z, w, K, reflections)
    torch.cuda.synchronize()
    if reflections == 0:
        assert torch.equal(T, torch.where(w[:, :K, None], Z[:, :K], 0.0))
    else:
        T_p = householder.householder_blocks_ref(Z, w, K)
        _assert_reduction(T[:, :reflections], T_p[:, :reflections], Z, w)


JACOBI_CASES = {
    # id: (groups, K, M, alpha, rcond, kind)
    "k5_m1_main": (10_000, 5, 1, 0.0, None, "factor"),
    "k5_m2_ragged_warp": (1_001, 5, 2, 0.0, None, "factor"),
    "k1": (37, 1, 2, 0.0, None, "factor"),
    "k2": (300, 2, 1, 0.0, None, "factor"),
    "k8": (300, 8, 3, 0.0, None, "factor"),
    "k9": (300, 9, 1, 0.0, None, "factor"),
    "k16": (300, 16, 2, 0.0, None, "factor"),
    "k17": (100, 17, 1, 0.0, None, "factor"),
    "k32": (100, 32, 2, 0.0, None, "factor"),
    "alpha_rcond": (500, 5, 2, 0.3, 1e-6, "factor"),
    "deficient": (600, 5, 2, 0.0, None, "deficient"),
    "deficient_k6": (600, 6, 2, 0.0, None, "deficient"),
    "deficient_k7": (600, 7, 2, 0.0, None, "deficient"),
    "deficient_k8": (600, 8, 2, 0.0, None, "deficient"),
    "deficient_k16": (300, 16, 1, 0.0, None, "deficient"),
    "nan_lanes": (700, 5, 2, 0.0, None, "nan"),
    "square": (500, 5, 2, 0.0, None, "square"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(JACOBI_CASES))
def test_jacobi_kernel_matches_plain_on_card(cuda_device, case):
    # the same rotations, sums in another order: each entry within 1e-12 of
    # its group's largest |beta|, NaN where the plain version has it, the
    # same bits from two launches
    G, K, M, alpha, rcond, kind = JACOBI_CASES[case]
    F, Y, n_valid = cs._jacobi_edge(np.random.default_rng(len(case)), G, K, M, kind, torch, cuda_device)
    b_k = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    b_k2 = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    torch.cuda.synchronize()
    assert jacobi.jacobi_kernel_launches == 2
    assert torch.equal(torch.nan_to_num(b_k), torch.nan_to_num(b_k2))
    b_p = jacobi.factor_lstsq_ref(F, Y, n_valid, alpha, rcond)
    nan = torch.isnan(b_p)
    assert torch.equal(torch.isnan(b_k), nan)
    scale = torch.where(nan, 0.0, b_p.abs()).amax(dim=(1, 2), keepdim=True)
    err = torch.where(nan, 0.0, (b_k - b_p).abs())
    assert bool((err <= 1e-12 * scale).all()), float((err / scale.clamp_min(1e-300)).max())
    if kind == "nan":
        assert bool(torch.isnan(b_k[0::7]).all()) and bool(torch.isnan(b_k[3::7, :, M - 1]).all())
    if kind == "deficient":  # the zero column's coefficient is exactly zero
        assert bool((b_k[1::3, K // 2] == 0).all())


@pytest.mark.gpu
def test_jacobi_kernel_takes_the_trees_strided_views(cuda_device):
    rng = np.random.default_rng(5)
    T = torch.as_tensor(rng.normal(size=(2_000, 5, 7)), device=cuda_device)
    n_valid = torch.full((2_000,), 40.0, dtype=torch.float64, device=cuda_device)
    a = jacobi.factor_lstsq(T[..., 2:], T[..., :2], n_valid)
    b = jacobi.factor_lstsq(T[..., 2:].contiguous(), T[..., :2].contiguous(), n_valid)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the thread form's cases: (M, alpha, rcond, _jacobi_edge kind); 12 targets
# take three stagings of the block's target columns at K = 5
JACOBI_FORM_KINDS = {
    "factor": (2, 0.0, None, "factor"),
    "deficient": (2, 0.0, None, "deficient"),
    "nan": (2, 0.0, None, "nan"),
    "square": (1, 0.0, None, "square"),
    "alpha_rcond": (3, 0.3, 1e-6, "factor"),
    "targets": (12, 0.0, None, "factor"),
}


def _conditioned_err(label, b_k, b_p, F, n_valid, rcond):
    """Each group of the kernel's beta within 1e-12 of its largest |beta|
    from the plain version's where the part of F the cutoff keeps has
    condition <= 1e3 (sigma_max over the smallest sigma above rcond *
    sigma_max), within 1e-12 x that condition / 1e3 above: two roundings of
    one solve differ by up to ~cond eps in beta, and general square factors
    reach cond 6e4 at K = 7 / 8, where LAPACK's lstsq is itself 7.4e-12 of a
    group's largest |beta| from the plain version (on the card, NVIDIA H100
    80GB HBM3). A rank-deficient group is held to the condition of what it
    keeps, not to cond(F) (infinite with a zero column). NaN exactly where
    the plain version has it."""
    nan = torch.isnan(b_p)
    assert torch.equal(torch.isnan(b_k), nan), label
    Fh, nh = F.cpu().numpy(), n_valid.cpu().numpy()
    K = Fh.shape[-1]
    ok = np.isfinite(Fh).all(axis=(1, 2))
    cond = np.ones(len(Fh))
    sv = np.linalg.svd(Fh[ok], compute_uv=False)  # descending
    rc = 2.0 ** -52 * np.maximum(nh[ok], K) if rcond is None else np.full(int(ok.sum()), rcond)
    kept = np.where(sv > (rc * sv[:, 0])[:, None], sv, np.inf).min(axis=1)
    cond[ok] = np.where(np.isfinite(kept), sv[:, 0] / kept, 1.0)
    allow = torch.as_tensor(1e-12 * np.maximum(1.0, cond / 1e3), device=b_k.device)
    err = torch.where(nan, 0.0, (b_k - b_p).abs()).amax(dim=(1, 2))
    scale = torch.where(nan, 0.0, b_p.abs()).amax(dim=(1, 2))
    assert bool((err <= allow * scale).all()), (label, float((err / scale.clamp_min(1e-300)).max()))


def _tree_views(F, Y):
    """F and Y as the strided views of one [G, K, M + K] tensor, as the
    engine hands over the tree's last level."""
    T = torch.cat([Y, F], dim=-1)
    M = Y.shape[-1]
    return T[..., M:], T[..., :M]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(JACOBI_FORM_KINDS))
@pytest.mark.parametrize("K", list(range(1, 10)))
def test_jacobi_thread_form_matches_plain_on_card(cuda_device, K, kind):
    # every K of the thread form and the segment form's first, at 1,001
    # groups (a ragged last block), on strided views: within 1e-12 of each
    # group's largest |beta| (more where the factor is ill-conditioned:
    # _conditioned_err), NaN where the plain version has it, the same bits
    # from two launches
    M, alpha, rcond, edge = JACOBI_FORM_KINDS[kind]
    F, Y, n_valid = cs._jacobi_edge(np.random.default_rng(10 * K + M), 1_001, K, M, edge, torch, cuda_device)
    F, Y = _tree_views(F, Y)
    assert jacobi.kernel_form(K)[0] == ("thread" if K <= 8 else "segment")
    b_k = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    b_k2 = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    torch.cuda.synchronize()
    assert jacobi.jacobi_kernel_launches == 2
    assert torch.equal(torch.nan_to_num(b_k), torch.nan_to_num(b_k2))
    _conditioned_err(f"K={K} {kind}", b_k, jacobi.factor_lstsq_ref(F, Y, n_valid, alpha, rcond), F, n_valid, rcond)
    if edge == "nan":
        assert bool(torch.isnan(b_k[0::7]).all()) and bool(torch.isnan(b_k[3::7, :, M - 1]).all())
    if edge == "deficient":  # the zero column's coefficient is exactly zero
        assert bool((b_k[1::3, K // 2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["factor", "deficient"])
@pytest.mark.parametrize("K", [1, 5, 6, 7, 16])
def test_jacobi_sweep_cap_at_or_above_the_need_changes_nothing(cuda_device, K, kind):
    # every cap from the sweeps the kernel's groups need (the first cap that
    # gives the uncapped bits) up to MAX_SWEEPS gives those bits; that need
    # is the plain version's rotating sweeps, give or take one where
    # round-off puts a pair at the threshold. One capped sweep of the full
    # rank factors is the plain version's capped result (a deficient
    # group's noise column may still sit at the cutoff after one sweep,
    # where round-off decides whether its 1 / sigma enters beta)
    F, Y, n_valid = cs._jacobi_edge(np.random.default_rng(K), 1_001, K, 2, kind, torch, cuda_device)
    _, _, sweeps, _ = jacobi.jacobi_ref(F)
    need = max(int(sweeps.max()) - 1, 0)
    full = jacobi.factor_lstsq(F, Y, n_valid)
    same = [torch.equal(jacobi.factor_lstsq(F, Y, n_valid, max_sweeps=cap), full)
            for cap in range(jacobi.MAX_SWEEPS + 1)]
    first = same.index(True)
    assert all(same[first:]) and abs(first - need) <= 1, (need, same)
    if kind == "factor":
        capped = jacobi.factor_lstsq(F, Y, n_valid, max_sweeps=1)
        cs._jacobi_err(f"K={K} one sweep", capped, jacobi.factor_lstsq_ref(F, Y, n_valid, max_sweeps=1), torch)


@pytest.mark.gpu
@pytest.mark.parametrize("K,want", [
    (1, ("thread", 32, 32)), (5, ("thread", 32, 32)), (6, ("thread", 32, 32)), (8, ("thread", 32, 32)),
    (9, ("segment", 64, 4)), (16, ("segment", 64, 4)), (17, ("segment", 64, 2)), (32, ("segment", 64, 2)),
])
def test_kernel_form_by_k(cuda_device, K, want):
    # the kernel's C entry picks the form: a thread a group up to K = 8, W
    # and V in its registers, 32 threads a block; a segment of 16 / 32 lanes
    # a group above it, two warps a block
    assert jacobi.kernel_form(K) == want


# --------------------------------------------------------------------------- #
# the wide forms: K > 32 features, and multi-target blocks past 33 columns
# --------------------------------------------------------------------------- #
MOMENT_WIDE = {
    # id: (blocks per group, R, C, element offset of Zp, byte offset of wp, NaN in masked slots)
    "c34": (np.full(40, 2), 512, 34, 0, 0, False),
    "c43_grouped": (np.full(300, 2), 512, 43, 0, 0, False),
    "c48_six_tiles": (np.full(100, 2), 512, 48, 0, 0, False),
    "c64_views_at_odd_offsets": (np.full(50, 3), 37, 64, 1, 3, True),
    "c101_one_group": (np.asarray([20]), 512, 101, 0, 0, False),
    "c101_one_group_nan_masked": (np.asarray([20]), 512, 101, 0, 0, True),
    "c101_nan_masked": (np.full(10, 2), 300, 101, 0, 0, True),
    "c128_widest_staged": (np.full(20, 2), 100, 128, 0, 0, False),
    "c129_direct": (np.full(20, 2), 100, 129, 0, 0, True),
    "c200": (np.full(10, 2), 300, 200, 0, 0, False),
    "c1001_one_block": (np.asarray([1]), 16, 1001, 0, 0, False),
    "c65_empty_groups": (np.asarray([0, 3, 0, 2, 0]), 200, 65, 0, 0, False),
    # a ragged last k-step (R % 4 != 0), and a row split into pieces of 16
    # rows whose last is ragged, on views at odd offsets
    "r1_c41": (np.full(50, 2), 1, 41, 0, 0, False),
    "r3_c34": (np.full(50, 2), 3, 34, 0, 0, True),
    "r37_c64_row_split": (np.asarray([3]), 37, 64, 1, 3, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MOMENT_WIDE))
def test_moment_wide_form_matches_plain_on_card(cuda_device, case):
    # the wide form (C > 33) on the FP64 tensor cores: up to C = 128 a CTA
    # covers a block's triangle of 8 x 8 tiles from rows staged once (a
    # block cut into pieces of rows where the blocks are few: one group of
    # 20 or 3 blocks), above a warp a pair of 32-column panels read from
    # device memory; the sums in another order than the plain version's, as
    # the register forms': rtol 1e-12 / atol 1e-13 * max|M|, counts exact,
    # the same bits from two launches
    n_blocks, R, C, z_off, w_off, nan_masked = MOMENT_WIDE[case]
    rng = np.random.default_rng(len(case) + C)
    S, G = int(n_blocks.sum()), len(n_blocks)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    split = moments.pieces(R, moments.piece_rows(S, R, C, sms)) > 1
    if case in ("c101_one_group", "c101_one_group_nan_masked", "r37_c64_row_split"):
        assert split  # a block cut into pieces of rows, each its own partial
    Z = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    W = rng.random((S, R)) > 0.2
    if nan_masked:
        Z[~W] = np.nan
    Zp = torch.empty(S * R * C + z_off, dtype=torch.float64, device=cuda_device)[z_off:].view(S, R, C)
    wp = torch.empty(S * R + w_off, dtype=torch.bool, device=cuda_device)[w_off:].view(S, R)
    Zp.copy_(torch.as_tensor(Z))
    wp.copy_(torch.as_tensor(W))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(n_blocks)]), device=cuda_device)
    M_k, c_k = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    M_k2, _ = moments.grouped_moments_blocks(Zp, wp, offsets, G)
    torch.cuda.synchronize()
    assert moments.moments_kernel_launches == 2 and torch.equal(M_k, M_k2)
    M_p, c_p = moments.grouped_moments_blocks_ref(Zp, wp, offsets, G)
    M_k, M_p = M_k.cpu().numpy(), M_p.cpu().numpy()
    assert np.isfinite(M_k).all()
    np.testing.assert_allclose(M_k, M_p, rtol=1e-12, atol=1e-13 * float(np.abs(M_p).max()))
    np.testing.assert_array_equal(c_k.cpu().numpy(), c_p.cpu().numpy())
    assert (M_k[n_blocks == 0] == 0).all()


HOUSEHOLDER_WIDE = {
    # id: (B, R, C, K, zero feature column, NaN in masked slots)
    "m40_k3": (300, 512, 43, 3, None, False),
    "m2_k32": (200, 512, 34, 32, None, False),
    "m3_k31": (200, 512, 34, 31, None, True),
    "m2_k40": (200, 512, 42, 40, 7, False),
    "m1_k100_panel_in_device_memory": (20, 512, 101, 100, None, False),
    "m1_k100_below_k": (20, 60, 101, 100, None, True),
    "m1_k40_r2000_panel_in_device_memory": (10, 2_000, 41, 40, None, False),
    # a block of more rows than the tree's levels stack
    "m1_k40_r9000_panel_in_device_memory": (2, 9_000, 41, 40, None, False),
    # the blocked form's panels of 8: K not a multiple of 8, fewer rows than
    # a panel, a zero pivot column inside the second panel
    "m2_k33": (200, 512, 35, 33, None, False),
    "m2_k41": (200, 300, 43, 41, None, True),
    "m1_k40_r5": (300, 5, 41, 40, None, True),
    "m2_k40_zero_pivot_in_a_panel": (200, 512, 42, 40, 10, False),
}

# the form each case takes (householder.FORMS; the rest: one CTA's shared
# memory) and the CTAs a block: A's 512 x 101 blocks and 2,000 rows at C =
# 41 hold their panel in the shared memory of a cluster of 4 CTAs (the ids
# name where the panel lived before the blocked form)
HOUSEHOLDER_WIDE_FORMS = {
    "m1_k100_panel_in_device_memory": ("wide (panel in a cluster's shared memory)", 4),
    "m1_k40_r2000_panel_in_device_memory": ("wide (panel in a cluster's shared memory)", 4),
    "m1_k40_r9000_panel_in_device_memory": ("wide (panel in device memory)", 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HOUSEHOLDER_WIDE))
def test_householder_wide_form_matches_plain_on_card(cuda_device, case):
    # the wide form takes C > 33 and any R; the reflections are the plain
    # version's, blocked in panels of 8 with the sums in another order:
    # _assert_reduction's 1e-12 of each column's norm, NaN where the plain
    # version has it, zero rows below a block's last, the same bits from two
    # launches; and the form (one CTA, a cluster, device memory) is the one
    # the case names
    B, R, C, K, zero_col, nan_masked = HOUSEHOLDER_WIDE[case]
    rng = np.random.default_rng(len(case) + C)
    Z = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    W = rng.random((B, R)) > 0.2
    if zero_col is not None:
        Z[:, :, C - K + zero_col] = 0.0
    if nan_masked:
        Z[~W] = np.nan
    Zt, wt = torch.as_tensor(Z, device=cuda_device), torch.as_tensor(W, device=cuda_device)
    form, ctas = HOUSEHOLDER_WIDE_FORMS.get(case, ("wide (panel in shared memory)", 1))
    assert householder.kernel_form(R, C) == form and householder.cluster_ctas(R, C) == ctas
    T_k = householder.householder_blocks(Zt, wt, K)
    T_k2 = householder.householder_blocks(Zt, wt, K)
    torch.cuda.synchronize()
    assert householder.householder_kernel_launches == 2 and torch.equal(T_k, T_k2)
    _assert_reduction(T_k, householder.householder_blocks_ref(Zt, wt, K), Zt, wt)
    assert bool(torch.isfinite(T_k).all())
    if R < K:
        assert bool((T_k[:, R:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [0, 1, 2])
def test_householder_wide_form_at_the_shared_stream_edges_on_card(cuda_device, edge):
    # chip_smoke's three Householder edges as they were drawn when the wide
    # moment edges before them took the shared stream
    # (chip_smoke.householder_shared_stream_edges): the kernel against the
    # plain version at _assert_reduction's 1e-12 of each column's norm
    _, Z, W, K = cs.householder_shared_stream_edges()[edge]
    Zt, wt = torch.as_tensor(Z, device=cuda_device), torch.as_tensor(W, device=cuda_device)
    T_k = householder.householder_blocks(Zt, wt, K)
    _assert_reduction(T_k, householder.householder_blocks_ref(Zt, wt, K), Zt, wt)
    assert bool(torch.isfinite(T_k).all())


@pytest.mark.gpu
@pytest.mark.parametrize("reflections", [0, 1, 7, 9, 40])
def test_householder_wide_phases_stop_after_their_reflections(cuda_device, reflections):
    # the wide form's phase entry stops after any number of reflections, in
    # the middle of a panel of 8 too (1, 7, 9): rows 0 .. r - 1 are then
    # final; after none the masked panel's first K rows come back as they were
    rng = np.random.default_rng(40 + reflections)
    B, R, C, K = 100, 300, 42, 40
    Z = torch.as_tensor(rng.normal(size=(B, R, C)), device=cuda_device)
    w = torch.as_tensor(rng.random((B, R)) > 0.2, device=cuda_device)
    T = householder._launch(Z, w, K, reflections)
    torch.cuda.synchronize()
    if reflections == 0:
        assert torch.equal(T, torch.where(w[:, :K, None], Z[:, :K], 0.0))
    else:
        T_p = householder.householder_blocks_ref(Z, w, K)
        _assert_reduction(T[:, :reflections], T_p[:, :reflections], Z, w)
        T_w = householder.householder_blocks_wy(Z, w, K, reflections)
        _assert_reduction(T, T_w, Z, w)


@pytest.mark.gpu
def test_householder_wide_tree_matches_plain_on_card(cuda_device):
    # groups of one, two and 30 blocks of 512 at K = 40 (12 factors a
    # stacked block): the wide form through every level of the tree
    rng = np.random.default_rng(13)
    n_blocks = np.asarray([30, 1, 2, 1])
    S, K, C = int(n_blocks.sum()), 40, 42
    Z = torch.as_tensor(rng.normal(size=(S, 512, C)), device=cuda_device)
    w = torch.as_tensor(rng.random((S, 512)) > 0.1, device=cuda_device)
    plan = householder.plan_reduction(n_blocks, K, cuda_device)
    T_k = householder.reduce_groups(Z, w, K, plan)
    torch.cuda.synchronize()
    assert householder.householder_kernel_launches == 1 + len(plan.levels)
    T_p = householder.reduce_groups(Z.cpu(), w.cpu(), K, householder.plan_reduction(n_blocks, K))
    norm = torch.where(w[..., None], Z, 0.0).square().sum(dim=(0, 1)).sqrt().cpu()
    assert bool(((T_k.cpu() - T_p).abs() <= 1e-11 * norm).all())


@pytest.mark.gpu
def test_householder_tree_past_4096_features_on_card(cuda_device, monkeypatch):
    # one group of 4,200 rows x 4,100 features in blocks of 512: their
    # factors stack only their 512 rows, so one level of 4,608 rows reduces
    # the group (the whole svd query, its Jacobi SVD of one 4,100 x 4,100
    # factor included, takes minutes; the reduction is held alone). Against
    # the plain tree on the card (1e-12 of each column's norm, up to row
    # signs) and numpy lstsq of the triangular system (rtol 1e-9)
    n, K, R = 4_200, 4_100, 512
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, K))
    y = X[:, :50].sum(axis=1) + rng.normal(size=n) * 0.1
    S = -(-n // R)
    Z = np.zeros((S * R, K + 1))
    Z[:n, 0], Z[:n, 1:] = y, X
    Zt = torch.as_tensor(Z.reshape(S, R, K + 1), device=cuda_device)
    wt = torch.as_tensor((np.arange(S * R) < n).reshape(S, R), device=cuda_device)
    plan = householder.plan_reduction(np.asarray([S]), K, cuda_device, rows=R)
    assert [tuple(m.shape) for _, m in plan.levels] == [(1, S * R)]
    T_k = householder.reduce_groups(Zt, wt, K, plan)[0].cpu().numpy()
    assert householder.householder_kernel_launches == 2
    # the plain tree on the card (on the CPU its 4,100 reflections of 4,608
    # rows take minutes)
    monkeypatch.setattr(householder, "householder_blocks", householder.householder_blocks_ref)
    T_p = householder.reduce_groups(Zt, wt, K, plan)[0].cpu().numpy()
    sign = np.sign(np.diagonal(T_k[:, 1:]) * np.diagonal(T_p[:, 1:]))
    assert (np.abs(T_k * sign[:, None] - T_p) <= 1e-12 * np.linalg.norm(Z, axis=0)).all()
    import scipy.linalg

    beta = scipy.linalg.solve_triangular(T_k[:, 1:], T_k[:, 0])
    np.testing.assert_allclose(beta, np.linalg.lstsq(X, y, rcond=None)[0], rtol=1e-9, atol=1e-12)


JACOBI_WIDE = {
    # id: (groups, K, M, alpha, rcond, kind)
    "k33": (300, 33, 2, 0.0, None, "factor"),
    "k33_deficient": (300, 33, 1, 0.0, None, "deficient"),
    "k33_nan": (140, 33, 2, 0.0, None, "nan"),
    "k33_square": (100, 33, 1, 0.0, None, "square"),
    "k40_alpha_rcond": (200, 40, 3, 0.3, 1e-6, "factor"),
    "k40_m40": (50, 40, 40, 0.0, None, "factor"),
    "k100": (4, 100, 2, 0.0, None, "factor"),
    "k125_workspace": (2, 125, 1, 0.0, None, "factor"),
    # the redesigned form: odd K, a pair's rows in 8 or 16 lanes, either side
    # of one CTA's shared memory (K = 119 / 120 at more groups than SMs),
    # and the cluster (fewer groups than SMs: one group, and 20)
    "k41_odd": (300, 41, 2, 0.0, None, "factor"),
    "k48": (300, 48, 1, 0.0, None, "deficient"),
    "k64": (300, 64, 2, 0.0, None, "factor"),
    "k119_one_cta_shared": (300, 119, 1, 0.0, None, "factor"),
    "k120_one_cta_workspace": (300, 120, 1, 0.0, None, "factor"),
    "k100_one_group_cluster": (1, 100, 1, 0.0, None, "factor"),
    "k40_20_groups_cluster": (20, 40, 2, 0.0, None, "deficient"),
    "k41_14_groups_cluster_nan": (14, 41, 2, 0.0, None, "nan"),
}

# CTAs a group of each case on a card of 132 SMs (the H100's): a cluster
# where the groups are fewer than the SMs (8 at one group of K = 100, 4 at
# 20 or 14 groups), else 1
JACOBI_WIDE_CTAS = {
    "k100": 8, "k125_workspace": 8, "k40_m40": 2, "k100_one_group_cluster": 8, "k40_20_groups_cluster": 4,
    "k41_14_groups_cluster_nan": 4,
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(JACOBI_WIDE))
def test_jacobi_wide_form_matches_plain_on_card(cuda_device, case):
    # the wide form (K > 32): a CTA of warps a group, W and V in shared
    # memory (in device memory at K = 120 on one CTA), or a cluster of CTAs
    # that hold its columns by position on the circle where the groups are
    # fewer than the SMs; the plain version's rotations (the same rounds of
    # the circle method) with the
    # sums in another order: _conditioned_err (1e-12 of a group's largest
    # |beta|, more where the factor is ill-conditioned), NaN where the plain
    # version has it, the same bits from two launches
    G, K, M, alpha, rcond, kind = JACOBI_WIDE[case]
    F, Y, n_valid = cs._jacobi_edge(np.random.default_rng(K + M), G, K, M, kind, torch, cuda_device)
    F, Y = _tree_views(F, Y)
    assert jacobi.kernel_form(K, G)[0] == "wide"
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count == 132:
        assert jacobi.wide_ctas(K, G) == JACOBI_WIDE_CTAS.get(case, 1)
    b_k = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    b_k2 = jacobi.factor_lstsq(F, Y, n_valid, alpha, rcond)
    torch.cuda.synchronize()
    assert jacobi.jacobi_kernel_launches == 2
    assert torch.equal(torch.nan_to_num(b_k), torch.nan_to_num(b_k2))
    _conditioned_err(case, b_k, jacobi.factor_lstsq_ref(F, Y, n_valid, alpha, rcond), F, n_valid, rcond)
    if kind == "nan":
        assert bool(torch.isnan(b_k[0::7]).all()) and bool(torch.isnan(b_k[3::7, :, M - 1]).all())
    if kind == "deficient":
        assert bool((b_k[1::3, K // 2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("K,n,G", [(100, 10, 50), (1_000, 10, 3), (301, 100, 2), (40, 33, 100)])
def test_jacobi_rows_mode_matches_plain_and_numpy_on_card(cuda_device, K, n, G):
    # the rows mode: X [n, K] with n < K as its transpose's n columns; held
    # to the plain version (1e-12 of a group's largest |beta|) and to numpy
    # lstsq (rtol 1e-9, the JAX suite's coefficient tolerance, on these
    # well-conditioned problems); a NaN problem gives NaN
    rng = np.random.default_rng(K + n)
    X = rng.normal(size=(G, n, K))
    Y = rng.normal(size=(G, n, 2))
    X[-1, 0, 0] = np.nan
    Xt = torch.as_tensor(X, device=cuda_device).mT
    Yt = torch.as_tensor(Y, device=cuda_device)
    nv = torch.full((G,), float(n), dtype=torch.float64, device=cuda_device)
    b_k = jacobi.rows_lstsq(Xt, Yt, nv)
    torch.cuda.synchronize()
    assert jacobi.jacobi_kernel_launches == 1
    cs._jacobi_err(f"rows K={K} n={n}", b_k, jacobi.rows_lstsq_ref(Xt, Yt, nv), torch)
    b = b_k.cpu().numpy()
    assert np.isnan(b[-1]).all()
    for g in range(G - 1):
        np.testing.assert_allclose(b[g], np.linalg.lstsq(X[g], Y[g], rcond=None)[0], rtol=1e-9, atol=1e-11)


def _wide_frame(n=3_000, k=40, m=2, g=5, seed=21):
    """k features, m targets, ~2 % nulls per column (row 0 valid), a
    weight column and g groups."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    Yv = X @ rng.normal(size=(k, m)) + 0.1 * rng.normal(size=(n, m))
    valid = rng.random((n, k + m)) > 0.02
    valid[0] = True
    return {
        **{f"y{j}": pt.Series(f"y{j}", Yv[:, j], valid[:, j]) for j in range(m)},
        **{f"x{i}": pt.Series(f"x{i}", X[:, i], valid[:, m + i]) for i in range(k)},
        "w": rng.random(n) + 0.1,
        "g": rng.integers(g, size=n).astype(float),
    }


WIDE_QUERIES = {
    # id: (features, targets, the expression on them)
    "ols_k40": (40, 1, lambda f, t: t[0].least_squares.ols(*f, null_policy="drop").over("g")),
    "qr_k40": (40, 1, lambda f, t: t[0].least_squares.ols(*f, solve_method="qr").over("g")),
    "lu_k40": (40, 1, lambda f, t: t[0].least_squares.ols(*f, solve_method="lu", null_policy="zero").over("g")),
    "svd_k40": (40, 1, lambda f, t: t[0].least_squares.ols(*f, solve_method="svd", null_policy="drop").over("g")),
    "ridge_wls_k40": (40, 1, lambda f, t: t[0].least_squares.wls(
        *f, sample_weights="w", alpha=0.1, null_policy="drop_zero").over("g")),
    "statistics_k40": (40, 1, lambda f, t: t[0].least_squares.ols(*f, mode="statistics").over("g")),
    "m40_k3": (3, 40, lambda f, t: pt.struct(*t).least_squares.multi_target_ols(*f).over("g")),
    "m2_k32": (32, 2, lambda f, t: pt.struct(*t).least_squares.multi_target_ols(*f).over("g")),
    "m3_k31": (31, 3, lambda f, t: pt.struct(*t).least_squares.multi_target_ols(
        *f, null_policy="drop").over("g")),
    "m2_k40": (40, 2, lambda f, t: pt.struct(*t).least_squares.multi_target_ols(*f).over("g")),
    "svd_k100_one_group": (100, 1, lambda f, t: t[0].least_squares.ols(*f, solve_method="svd")),
    "wide_rows_k100": (100, 1, lambda f, t: t[0].least_squares.ridge(*f, alpha=1e-3, solve_method="svd").over("g")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("query", sorted(WIDE_QUERIES))
def test_wide_slices_on_card_match_cpu(cuda_device, query, monkeypatch):
    # static fits and multi-target above 33 columns through the public API:
    # the card (the wide forms and the library Cholesky) against the CPU
    # (the plain versions) at rtol 1e-10 (the kernels' summation order,
    # through the solves), with identical null masks
    k, m, build = WIDE_QUERIES[query]
    n = 150 if query == "wide_rows_k100" else 3_000
    frame = _wide_frame(n=n, k=k, m=m, g=3 if n < 1_000 else 5)
    expr = build([f"x{i}" for i in range(k)], [col(f"y{j}") for j in range(m)])
    monkeypatch.setattr(CONFIG, "lazy_row_order", False)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        s = pt.DataFrame(frame).select(expr)
        c = s[s.columns[0]]
        if query.startswith("statistics"):
            out[dev] = ({key: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=float)
                         for key, v in c.arrays.items() if key != "feature_names"}, None)
        else:
            out[dev] = (c.to_numpy(), None if c.validity is None else c.validity.cpu().numpy())
    if query.startswith("statistics"):
        for key in out["cpu"][0]:
            np.testing.assert_allclose(out["cuda"][0][key], out["cpu"][0][key], rtol=1e-10, atol=1e-12, err_msg=key)
        return
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-10, atol=1e-10)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [33, 100])
def test_kernel_form_above_32(cuda_device, K):
    # the Jacobi kernel's C entry takes the wide form above K = 32: a pair a
    # segment of 8 lanes up to 48 rows, 16 up to 128 (so that its rows fill
    # its lanes), 32 above; a warp a segment of pairs of the CTA's share of
    # a round, at most 16 warps where the groups are fewer than the SMs,
    # else 8; where they are fewer, a cluster of CTAs shares a group's pairs,
    # a warp a pair
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for G, cap in ((1, 16), (sms, 8)):
        ctas = jacobi.wide_ctas(K, G)
        per_warp = 1 if ctas > 1 else 32 // (8 if K <= 48 else 16)  # a cluster: a warp a pair
        pairs = -(-((K + 1) // 2) // ctas)
        warps = min(cap, -(-pairs // per_warp))
        assert jacobi.kernel_form(K, G) == ("wide", 32 * warps, 1)
    assert jacobi.wide_ctas(K, sms) == 1
    assert jacobi.kernel_form(K) == ("wide", 32 * (5 if K == 33 else 7), 1)


# --------------------------------------------------------------------------- #
# coordinate descent above K = 32: FISTA and the wide cyclic form
# --------------------------------------------------------------------------- #
def _wide_cd_moments(seed: int, G: int, K: int, device, rows=None, edges: bool = True):
    """Moments of G groups of ``rows`` (default K + 10 .. 3 K) rows with
    sparse coefficients of both signs; with ``edges`` group 0 has no rows
    and group 1 a NaN (the 'ignore' policy's)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(K + 10, 3 * K, size=G) if rows is None else np.full(G, rows)
    XtX = np.zeros((G, K, K))
    Xty = np.zeros((G, K))
    for g in range(G):
        X = rng.normal(size=(int(n[g]), K))
        y = X @ (rng.normal(size=K) * (rng.random(K) > 0.6)) + rng.normal(size=int(n[g]))
        XtX[g], Xty[g] = X.T @ X, X.T @ y
    nv = n.astype(float)
    if edges and G > 2:
        XtX[0], Xty[0], nv[0] = 0.0, 0.0, 0.0
        XtX[1, 3, 5] = XtX[1, 5, 3] = np.nan
    return tuple(torch.as_tensor(a, device=device) for a in (XtX, Xty, nv))


def _groups(G, device) -> int:
    """A case's group count: a number, or "sms-1" / "sms+1" / "sms/8" /
    "sms/8+1" of the card's SMs (the edges of the wide kernels' plans)."""
    if isinstance(G, int):
        return G
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    base, _, extra = G.partition("+") if "+" in G else G.partition("-")
    n = sms // 8 if base == "sms/8" else sms
    return n + int(extra) if "+" in G else n - int(extra or 0)


FISTA_CASES = {
    # id: (G, K, rows a group or None, settings, plan: (form, warps a CTA, CTAs a group))
    "k33_enet": (300, 33, None, dict(alpha=0.05, l1_ratio=0.5), ("team", 2, 1)),
    "k40_lasso_positive": (200, 40, None, dict(alpha=0.05, l1_ratio=1.0, positive=True), ("team", 2, 1)),
    "k64_l1_0": (100, 64, None, dict(alpha=0.05, l1_ratio=0.0), ("lone", 8, 1)),
    "k100_max_iter": (50, 100, None, dict(alpha=0.01, l1_ratio=1.0, max_iter=5), ("lone", 8, 1)),
    "k160_shared": (6, 160, None, dict(alpha=0.05, l1_ratio=0.5), ("lone", 16, 1)),
    "k200_device_memory": (4, 200, None, dict(alpha=0.05, l1_ratio=0.7, positive=True), ("lone", 16, 1)),
    "k1000_ten_rows": (1, 1_000, 10, dict(alpha=1e-6, l1_ratio=1.0, max_iter=3_000, tol=1e-8), ("cluster", 16, 8)),
    # where a team's warps change (K = 64 / 65, 128 / 129) and its XtX leaves
    # shared memory (K = 256 / 257: device memory on both sides)
    "k64_team": (300, 64, None, dict(alpha=0.05, l1_ratio=0.5), ("team", 2, 1)),
    "k65_team": (300, 65, None, dict(alpha=0.05, l1_ratio=0.5), ("team", 4, 1)),
    "k128_team": (200, 128, None, dict(alpha=0.05, l1_ratio=1.0, max_iter=200), ("team", 4, 1)),
    "k129_team": (200, 129, None, dict(alpha=0.05, l1_ratio=1.0, max_iter=200), ("team", 16, 1)),
    "k256_team": (150, 256, None, dict(alpha=0.05, l1_ratio=0.5, max_iter=50), ("team", 16, 1)),
    "k257_team": (150, 257, None, dict(alpha=0.05, l1_ratio=0.5, max_iter=50), ("team", 16, 1)),
    # group counts just below and above the SMs, and an eighth of them
    "k40_one_below_the_sms": ("sms-1", 40, None, dict(alpha=0.05, l1_ratio=0.5), ("lone", 8, 1)),
    "k40_one_above_the_sms": ("sms+1", 40, None, dict(alpha=0.05, l1_ratio=0.5), ("team", 2, 1)),
    "k129_lone": (3, 129, None, dict(alpha=0.05, l1_ratio=0.5), ("lone", 16, 1)),
    "k300_clusters": ("sms/8", 300, None, dict(alpha=0.05, l1_ratio=1.0, max_iter=100), ("cluster", 16, 8)),
    "k300_one_past_the_clusters": ("sms/8+1", 300, None, dict(alpha=0.05, l1_ratio=1.0, max_iter=100),
                                   ("team", 16, 1)),
    # lone groups: A's shape, and K = 1,000 with its zero and NaN groups
    "k100_one_group": (1, 100, 200, dict(alpha=0.05, l1_ratio=0.5), ("lone", 8, 1)),
    "k1000_cluster_edges": (3, 1_000, None, dict(alpha=0.05, l1_ratio=0.5, max_iter=20), ("cluster", 16, 8)),
    "k8192_once": (1, 8_192, 10, dict(alpha=0.05, l1_ratio=1.0, max_iter=2), ("team", 8, 1)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FISTA_CASES))
def test_fista_kernel_matches_plain_on_card(cuda_device, case):
    # the FISTA kernel makes the plain version's sums in the same tree
    # order: the same iteration counts and the same values, before the
    # polish and after it (the same torch code on the same iterate); the
    # group without rows stays at zero, the NaN group stops after one
    # iteration with NaN coefficients; each case takes the plan it names
    G, K, rows, kw, plan = FISTA_CASES[case]
    G = _groups(G, cuda_device)
    assert cd.wide_plan(G, K, True)[:3] == plan
    XtX, Xty, n = _wide_cd_moments(K + G, G, K, cuda_device, rows, edges=G > 2)
    args = (XtX, Xty, n, kw["alpha"], kw["l1_ratio"], kw.get("max_iter", 1000), kw.get("tol", 1e-5),
            kw.get("positive", False))
    w_k, it_k = cd.launch_wide(*args, False, fista=True)
    torch.cuda.synchronize()
    assert cd.fista_kernel_launches == 1 and cd.cd_kernel_launches == 0
    w_p, it_p = cd.fista_ref(*args, kernel_order=True)
    np.testing.assert_array_equal(it_k.cpu().numpy(), it_p.cpu().numpy())
    np.testing.assert_array_equal(w_k.cpu().numpy(), w_p.cpu().numpy())
    if "max_iter" in kw and K == 100:
        assert int(it_k.max()) == 4 * kw["max_iter"]
    if G > 2:
        assert float(w_k[0].abs().max()) == 0.0 and int(it_k[0]) == 1
        assert bool(torch.isnan(w_k[1]).all()) and int(it_k[1]) == 1
    full_k, _ = cd.solve_elastic_net_cov(XtX, Xty, n, **kw)
    full_p = cd.active_set_polish(XtX, Xty, *cd._strengths(n, kw["alpha"], kw["l1_ratio"]), w_p,
                                  kw.get("positive", False))
    np.testing.assert_array_equal(full_k.cpu().numpy(), full_p.cpu().numpy())
    if kw.get("positive"):
        assert float(torch.nan_to_num(full_k).min()) >= 0.0


CYCLIC_WIDE_CASES = {
    # id: (G, K, settings[, rows a group]); a warp a group at every K
    "k33_active_set": (300, 33, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k40_active_set_positive": (200, 40, dict(alpha=0.02, l1_ratio=0.6, positive=True, active_set=True)),
    "k100_active_set": (40, 100, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k40_cyclic_no_active_set": (100, 40, dict(alpha=0.05, l1_ratio=0.5)),
    "k200_device_memory": (3, 200, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=30)),
    # where a lane's leaves change (K = 64 / 65, 128 / 129) and XtX leaves
    # shared memory (K = 167 / 168)
    "k64_active_set": (100, 64, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k65_active_set": (100, 65, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k129_active_set": (30, 129, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=50)),
    "k167_shared": (10, 167, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=30)),
    "k168_device_memory": (10, 168, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=30)),
    # group counts just below and above the SMs, a lone group (A's shape),
    # K = 1,000 with its zero and NaN groups, and the largest K once
    "k40_one_below_the_sms": ("sms-1", 40, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k40_one_above_the_sms": ("sms+1", 40, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k100_one_group": (1, 100, dict(alpha=0.05, l1_ratio=1.0, active_set=True), 200),
    "k1000_edges": (3, 1_000, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=5)),
    "k8192_once": (1, 8_192, dict(alpha=0.05, l1_ratio=1.0, active_set=True, max_iter=2), 10),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CYCLIC_WIDE_CASES))
def test_cyclic_wide_kernel_matches_plain_on_card(cuda_device, case):
    # the wide cyclic kernel against its plain version: the same sweep
    # counts and values (active-set freezing is a threshold on them); the
    # group without rows stays at zero after one sweep, the NaN group stops
    # after one
    G, K, kw, *rows = CYCLIC_WIDE_CASES[case]
    G = _groups(G, cuda_device)
    assert cd.wide_plan(G, K, False)[:3] == ("warp", 1, 1)
    XtX, Xty, n = _wide_cd_moments(2 * K + G, G, K, cuda_device, *rows, edges=G > 2)
    args = (XtX, Xty, n, kw["alpha"], kw["l1_ratio"], kw.get("max_iter", 1000), 1e-5,
            kw.get("positive", False), kw.get("active_set", False))
    w_k, s_k = cd.launch_wide(*args, fista=False)
    torch.cuda.synchronize()
    assert cd.cyclic_wide_kernel_launches == 1
    w_p, s_p = cd._cyclic_wide_ref(*args)
    np.testing.assert_array_equal(s_k.cpu().numpy(), s_p.cpu().numpy())
    np.testing.assert_array_equal(w_k.cpu().numpy(), w_p.cpu().numpy())
    if G > 2:
        assert float(w_k[0].abs().max()) == 0.0 and int(s_k[0]) == 1
        assert bool(torch.isnan(w_k[1]).any()) and int(s_k[1]) == 1
    if kw.get("active_set"):
        w_api, _ = cd.solve_elastic_net_cov(XtX, Xty, n, **kw)
        assert torch.equal(torch.nan_to_num(w_api), torch.nan_to_num(w_k))


@pytest.mark.gpu
@pytest.mark.parametrize("K,fista,want", [
    (33, True, (True, 0)), (161, True, (True, 0)), (162, True, (False, 0)),
    (4_096, True, (False, 0)), (4_097, True, (False, 4 * 4_097)),
    (167, False, (True, 0)), (168, False, (False, 0)), (4_096, False, (False, 0)),
    (4_097, False, (False, 5 * 4_097 + 513)), (8_192, False, (False, 5 * 8_192 + 1_024)),
])
def test_wide_cd_layout_by_k(cuda_device, K, fista, want):
    # XtX in shared memory while it fits beside the vectors; the vectors in
    # a device-memory workspace from K = 4,097 (the widest instantiation)
    assert cd.wide_layout(K, fista) == want


@pytest.mark.gpu
def test_wide_cd_refuses_past_its_width(cuda_device):
    XtX = torch.zeros((1, 8_193, 8_193), dtype=torch.float64, device=cuda_device)
    Xty = torch.zeros((1, 8_193), dtype=torch.float64, device=cuda_device)
    n = torch.ones(1, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="K <= 8192"):
        cd.solve_elastic_net_cov(XtX, Xty, n, alpha=0.1)


WIDE_CD_QUERIES = {
    "lasso_k40": (40, lambda f, t: t.least_squares.lasso(*f, alpha=0.05, null_policy="drop").over("g")),
    "enet_k40_coefficients": (40, lambda f, t: t.least_squares.elastic_net(
        *f, alpha=0.05, l1_ratio=0.5, mode="coefficients").over("g")),
    "nnls_k40_zero": (40, lambda f, t: t.least_squares.lasso(
        *f, alpha=0.05, positive=True, null_policy="zero").over("g")),
    "active_set_k40": (40, lambda f, t: t.least_squares.lasso(
        *f, alpha=0.05, solve_method="cd_active_set", null_policy="drop").over("g")),
    "lasso_statistics_k40": (40, lambda f, t: t.least_squares.lasso(*f, alpha=0.05, mode="statistics").over("g")),
    "lasso_k100_one_group": (100, lambda f, t: t.least_squares.lasso(*f, alpha=0.05)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("query", sorted(WIDE_CD_QUERIES))
def test_wide_cd_slices_on_card_match_cpu(cuda_device, query, monkeypatch):
    # lasso / elastic net / NNLS / cd_active_set above K = 32 through the
    # public API: the card (the moment kernel's wide form, then the FISTA
    # or wide cyclic kernel) against the CPU (the plain versions) at rtol
    # 1e-9 (the moments' summation order, through the iterations), with
    # identical null masks
    k, build = WIDE_CD_QUERIES[query]
    frame = _wide_frame(n=3_000, k=k, m=1, g=5)
    expr = build([f"x{i}" for i in range(k)], col("y0"))
    monkeypatch.setattr(CONFIG, "lazy_row_order", False)
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        s = pt.DataFrame(frame).select(expr)
        c = s[s.columns[0]]
        if "statistics" in query:
            out[dev] = ({key: np.asarray(v.cpu() if torch.is_tensor(v) else v, dtype=float)
                         for key, v in c.arrays.items() if key != "feature_names"}, None)
        else:
            out[dev] = (c.to_numpy(), None if c.validity is None else c.validity.cpu().numpy())
    launched = cd.cyclic_wide_kernel_launches if "active_set" in query else cd.fista_kernel_launches
    assert launched == 1 and cd.cd_kernel_launches == 0
    if "statistics" in query:
        for key in out["cpu"][0]:
            np.testing.assert_allclose(out["cuda"][0][key], out["cpu"][0][key], rtol=1e-9, atol=1e-11, err_msg=key)
        return
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9, atol=1e-11)


@pytest.mark.gpu
def test_frame_workflow_on_card_matches_cpu(cuda_device, monkeypatch):
    # the smoke's frame workflow (chip_smoke.frame_steps: filter,
    # with_row_index, .over fits, column arithmetic, group_by agg / last,
    # unique, a left join then predict, a two-key sort, statistics
    # exploded) on the card against the same workflow on the CPU: the same
    # rows in the same order, the same keys and null masks, values at rtol
    # 1e-9 (the moment kernel's summation order, through the fits); every
    # value column on the card, and the card frames pass the smoke's numpy
    # checks
    rng = np.random.default_rng(12)
    n, k, G = 30_000, 5, 60
    x = rng.normal(size=(n, k))
    y = x @ np.arange(1.0, k + 1) + rng.normal(size=n) * 0.1
    g = rng.integers(G, size=n).astype(float)
    cols = {"y": y, **{f"x{i + 1}": x[:, i] for i in range(k)}, "group": g}
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        out[dev] = cs.run_frame_steps(pt, pt.DataFrame(cols))
    assert moments.moments_kernel_launches >= 3 and special.t_pvalue_kernel_launches >= 1
    cs._check_frame(out["cuda"], x, y, g, np.arange(G), device="cuda")
    for step, frame in out["cuda"].items():
        ref = out["cpu"][step]
        assert frame.columns == ref.columns and frame.shape == ref.shape, step
        for c in frame.columns:
            a, b = frame[c].to_numpy(), ref[c].to_numpy()
            if a.dtype == object:
                assert [repr(v) for v in a.tolist()] == [repr(v) for v in b.tolist()], (step, c)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11, equal_nan=True, err_msg=f"{step}.{c}")


def _fused_frame(n=20_000, k=5, G=37, seed=13):
    """The smoke's main frame at a small size: y, y2, w, x1..xk, their
    nulled copies (nulls in the odd groups, row 0 valid) and the group
    column, as host arrays; with x and the group keys."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    y = x.sum(axis=1) + rng.normal(size=n) * 0.1
    g = rng.integers(G, size=n).astype(float)
    valid = rng.random((n, 1 + k)) >= cs.NULL_RATE
    valid[g.astype(np.int64) % 2 == 0] = True
    valid[0] = True
    cols = {"y": y, **{f"x{i + 1}": x[:, i] for i in range(k)}}
    data = dict(cols, y2=x @ np.asarray(cs.Y2_COEFS) + rng.normal(size=n) * 0.1, w=rng.random(n) + 0.1, group=g)
    for j, (name, v) in enumerate(cols.items()):
        data[f"{name}n"] = pt.Series(f"{name}n", v, valid[:, j])
    return data, x, g


@pytest.mark.gpu
@pytest.mark.parametrize("select", ["sweep", "mixed", "flagged"])
def test_fused_select_on_card_matches_cpu(cuda_device, select, monkeypatch):
    # the smoke's fused selects (chip_smoke.fused_selects; "flagged": the
    # sweep with a collinear and an ill-conditioned group) on the card and
    # on the CPU: fused equals eager within 1e-12 on each device with one
    # flag read a select (and on the flagged frame a plan that continued:
    # the eigh solve of failed lanes or the CSNE sweeps); the card matches
    # the CPU at rtol 1e-9 / atol 1e-11 with identical nulls (the moment
    # and moving kernels' summation order; the moving columns from the
    # row on where a group holds K + 3 rows)
    from polars_ols_tpu_torch.engine import batch

    k = 5
    data, x, g = _fused_frame(k=k)
    if select == "flagged":
        data["x5"] = cs.flagged_x5(x, g)
    exprs = cs.fused_selects(pt, k)["mixed" if select == "mixed" else "sweep"]
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(CONFIG, "device", dev)
        df = pt.DataFrame(data)
        reads, flagged = batch.flag_reads, batch.flagged_plans
        fused = df.select(*exprs)
        assert batch.flag_reads == reads + 1
        assert (batch.flagged_plans > flagged) == (select == "flagged")
        monkeypatch.setattr(CONFIG, "fused_select", False)
        eager = df.select(*exprs)
        monkeypatch.setattr(CONFIG, "fused_select", True)
        assert cs.fused_diff(fused, eager) <= cs.FUSED_TOL
        out[dev] = {c: {key: (v.cpu().numpy(), m.cpu().numpy()) for key, (v, m) in cs.fused_fields(fused[c]).items()}
                    for c in fused.columns}
    rank = np.zeros(len(g), dtype=np.int64)
    for v in np.unique(g):
        rows = np.flatnonzero(g == v)
        rank[rows] = np.arange(len(rows))
    for c, fields in out["cuda"].items():
        for key, (v, m) in fields.items():
            v_cpu, m_cpu = out["cpu"][c][key]
            np.testing.assert_array_equal(m, m_cpu, err_msg=f"{c} {key}: nulls")
            shown = m & (rank >= k + 3) if c in ("rls", "rolling") else m
            np.testing.assert_allclose(v[shown], v_cpu[shown], rtol=1e-9, atol=1e-11, err_msg=f"{c} {key}")
    if select == "mixed":
        assert moving.moving_kernel_launches >= 2 and cd.cd_kernel_launches >= 1
    assert moments.moments_kernel_launches >= 2


def _sharded_data(n=20_000, k=3, g=37, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    gids = rng.integers(g, size=n)
    gids[: n // 2] = 0  # a heavy group whose rows span every shard
    y = np.einsum("nk,nk->n", X, rng.normal(size=(g, k))[gids]) + rng.normal(size=n) * 0.1
    w = rng.random(n) > 0.05
    return X, y, w, gids, g


@pytest.mark.gpu
@pytest.mark.parametrize("solve", ["chol", "qr", "lu", "cd", "statistics", "cd_statistics"])
def test_sharded_moments_on_card_match_one_shard(cuda_device, solve, monkeypatch):
    # fit_moments_sharded / statistics_moments_sharded over 4 virtual shards
    # of the card against one shard of it: rtol 1e-8 / atol 1e-10, p-values
    # rtol 1e-6 (the moments' partial sums are added in another order);
    # one moment launch a shard
    from polars_ols_tpu_torch.parallel import fit_moments_sharded, make_mesh, statistics_moments_sharded

    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(CONFIG, "virtual_devices", 4)
    X, y, w, gids, g = _sharded_data()
    args = [torch.as_tensor(a, device="cuda") for a in (X, y, w, gids)]
    cd_params = (0.5, 1000, 1e-7, False) if "cd" in solve else None
    out = {}
    for shards in (1, 4):
        mesh = make_mesh(shards)
        before = moments.moments_kernel_launches
        if solve.endswith("statistics"):
            res = statistics_moments_sharded(mesh, *args, g, alpha=0.01 if cd_params else 0.0, cd_params=cd_params)
        else:
            beta, preds = fit_moments_sharded(
                mesh, *args, g, alpha=0.01 if cd_params else 0.0, cd_params=cd_params,
                force_refine=solve == "qr", lu=solve == "lu",
            )
            res = {"beta": beta, "preds": preds}
        assert moments.moments_kernel_launches == before + shards
        out[shards] = {key: v.cpu().numpy() for key, v in res.items()}
    for key, v in out[4].items():
        tol = dict(rtol=1e-6, atol=1e-12) if key == "p_values" else dict(rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(v, out[1][key], err_msg=key, **tol)
    if "cd" in solve:
        assert cd.cd_kernel_launches >= 5
    if solve.endswith("statistics"):
        assert special.t_pvalue_kernel_launches >= 5


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["rls", "rolling"])
def test_sharded_moving_on_card_matches_one_shard(cuda_device, model, monkeypatch):
    # solve_groups_sharded over 4 virtual shards of the card against the
    # moving kernel on all groups at once (G = 37: the last shard's slice is
    # padded with groups of no rows); the same bits where the windows agree
    # (each group's rows are walked alone), NaN where the one-shard call
    # has it
    from polars_ols_tpu_torch.parallel import make_mesh, solve_groups_sharded

    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(CONFIG, "virtual_devices", 4)
    rng = np.random.default_rng(6)
    G, R, K = 37, 300, 3
    counts = rng.integers(1, R + 1, size=G)
    Zp = torch.as_tensor(rng.normal(size=(G, R, K + 1)), device="cuda")
    vp = torch.as_tensor((np.arange(R)[None, :] < counts[:, None]) & (rng.random((G, R)) > 0.05), device="cuda")
    rows = torch.as_tensor(counts, device="cuda")
    if model == "rls":
        fn, kw = moving.recursive_least_squares, dict(half_life=20.0, initial_state_covariance=10.0)
    else:
        fn, kw = moving.rolling_ols, dict(window=25, min_periods=None, alpha=0.0, positional=True)
    one = fn(Zp, vp, rows, **kw)
    before = moving.moving_kernel_launches
    out = solve_groups_sharded(make_mesh(4), fn, [Zp, vp, rows], **kw)
    assert moving.moving_kernel_launches > before
    a, b = out.cpu().numpy(), one.cpu().numpy()
    valid = np.arange(R)[None, :] < counts[:, None]
    np.testing.assert_array_equal(np.isnan(a[valid]), np.isnan(b[valid]))
    np.testing.assert_allclose(a[valid], b[valid], rtol=1e-8, atol=1e-10, equal_nan=True)
