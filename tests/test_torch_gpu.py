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
everywhere, and the same bits from two launches; chunks of 2 rows make
the prefix over a group's chunks run in segments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG, col  # noqa: E402
from polars_ols_tpu_torch.ops import cd, grid_probe, moments, moving, recursive, rolling, special  # noqa: E402


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    monkeypatch.setattr(cd, "cd_kernel_launches", 0)
    monkeypatch.setattr(special, "t_pvalue_kernel_launches", 0)
    monkeypatch.setattr(moving, "moving_kernel_launches", 0)
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
@pytest.mark.parametrize("k", [3, 9])
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
