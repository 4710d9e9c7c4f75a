"""The sharded primitives of the PyTorch port (polars_ols_tpu_torch.parallel)
on a mesh of 8 virtual CPU shards, against numpy and the JAX package.

The 15 cases of tests/test_parallel.py on the same seeded data, each held
to numpy ``lstsq`` (or the host-built group layout) at that file's
tolerances and to the JAX package's primitive on its 8-device CPU mesh
(the sharded fits at rtol 1e-10 / atol 1e-12: both merge exact moments,
only the order of their sums differs; the layouts bit for bit). The JAX
results are computed once a module. ``test_make_mesh_multiprocess_topology``
fakes a world size of 4, as the JAX test fakes ``jax.process_count``; one
more case runs two real gloo processes of two shards each
(tests/torch_dist_worker.py).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu.ops.cd import solve_elastic_net as j_solve_elastic_net  # noqa: E402
from polars_ols_tpu.ops.moving import solve_recursive_lanes  # noqa: E402
from polars_ols_tpu.ops.recursive import solve_recursive_least_squares  # noqa: E402
from polars_ols_tpu.parallel import fit_moments_sharded as j_fit_moments_sharded  # noqa: E402
from polars_ols_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from polars_ols_tpu.parallel import shuffle_rows_to_groups as j_shuffle_rows_to_groups  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops.cd import solve_elastic_net  # noqa: E402
from polars_ols_tpu_torch.ops.moving import recursive_least_squares  # noqa: E402
from polars_ols_tpu_torch.parallel import (  # noqa: E402
    fit_moments_sharded,
    make_mesh,
    shuffle_rows_to_groups,
    solve_groups_sharded,
    statistics_moments_sharded,
)
from polars_ols_tpu_torch.parallel import sharded  # noqa: E402

JAX_TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "virtual_devices", 8)
    monkeypatch.setattr(CONFIG, "auto_shard", False)


def _grouped_data(n=4_000, k=3, g=17, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    beta_g = rng.normal(size=(g, k))
    gids = rng.integers(g, size=n)
    y = np.einsum("nk,nk->n", X, beta_g[gids]) + rng.normal(size=n) * 0.1
    return X, y, gids


def _skewed_data():
    rng = np.random.default_rng(1)
    n, k = 8_192, 4
    X = rng.normal(size=(n, k))
    gids = np.zeros(n, dtype=np.int64)
    gids[: n // 64] = np.arange(n // 64) % 7 + 1  # 7 tiny groups + 1 heavy
    y = X.sum(1) + rng.normal(size=n) * 0.1
    return X, y, gids


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _port_fit(mesh, X, y, gids, g, **kw):
    beta, preds = fit_moments_sharded(
        mesh, *_t(X, y), torch.ones(len(y), dtype=torch.bool), torch.tensor(gids), num_groups=g, **kw
    )
    return beta.numpy(), preds.numpy()


def _check_lstsq(beta, X, y, gids, g, **tol):
    for gi in range(g):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(beta[gi], expected, **tol)


_JAX = {}


def _jax_fit(key, X, y, gids, g, mesh_args=(8,), row_axes=None):
    """The JAX package's fit_moments_sharded on its CPU mesh, once a module
    for each data set."""
    if key not in _JAX:
        beta, preds = j_fit_moments_sharded(
            j_make_mesh(*mesh_args), jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y), dtype=bool),
            jnp.asarray(gids), num_groups=g, row_axes=row_axes,
        )
        _JAX[key] = (np.asarray(beta), np.asarray(preds))
    return _JAX[key]


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_fit_moments_sharded_matches_lstsq(n_devices):
    X, y, gids = _grouped_data()
    g = int(gids.max()) + 1
    before = sharded.calls["fit_moments"]
    beta, preds = _port_fit(make_mesh(n_devices), X, y, gids, g)
    assert sharded.calls["fit_moments"] == before + 1
    _check_lstsq(beta, X, y, gids, g, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(preds, np.einsum("nk,nk->n", X, beta[gids]), rtol=1e-10)
    jb, jp = _jax_fit("grouped", X, y, gids, g)
    np.testing.assert_allclose(beta, jb, **JAX_TOL)
    np.testing.assert_allclose(preds, jp, **JAX_TOL)


def test_fit_moments_sharded_skewed_groups():
    """One heavy group spanning every shard merges exactly (the
    reduce-scatter of the partial moments); so do its statistics."""
    X, y, gids = _skewed_data()
    mesh = make_mesh(8)
    beta, _ = _port_fit(mesh, X, y, gids, 8)
    _check_lstsq(beta, X, y, gids, 8, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(beta, _jax_fit("skewed", X, y, gids, 8)[0], **JAX_TOL)
    args = (*_t(X, y), torch.ones(len(y), dtype=torch.bool), torch.tensor(gids), 8)
    stats = statistics_moments_sharded(mesh, *args)
    one = statistics_moments_sharded(make_mesh(1), *args)
    for key, v in stats.items():
        np.testing.assert_allclose(v.numpy(), one[key].numpy(), rtol=1e-10, atol=1e-12, err_msg=key)


def test_fit_moments_sharded_2d_mesh():
    X, y, gids = _grouped_data(n=2_048, g=12)
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    beta, _ = _port_fit(mesh, X, y, gids, 12, row_axes=("data", "model"))
    _check_lstsq(beta, X, y, gids, 12, rtol=1e-8, atol=1e-8)
    jb, _ = _jax_fit("2d", X, y, gids, 12, (8, ("data", "model"), (4, 2)), ("data", "model"))
    np.testing.assert_allclose(beta, jb, **JAX_TOL)


def test_solve_groups_sharded_cd_matches_single_device():
    rng = np.random.default_rng(2)
    G, R, K = 16, 256, 4
    Xp, yp = rng.normal(size=(G, R, K)), rng.normal(size=(G, R))
    n_valid = np.full((G,), float(R))
    kwargs = dict(alpha=0.1, l1_ratio=0.5, max_iter=500, tol=1e-7, positive=False)
    single = solve_elastic_net(*_t(Xp, yp, n_valid), **kwargs)
    out = solve_groups_sharded(make_mesh(8), solve_elastic_net, _t(Xp, yp, n_valid), **kwargs)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=1e-12)
    # the JAX row form takes the same coordinate steps on the rows
    ref = np.asarray(j_solve_elastic_net(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(n_valid), **kwargs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-8, atol=1e-10)


def _rls_layout(Xp, yp, vp):
    Zp = torch.cat([torch.tensor(yp)[..., None], torch.tensor(Xp)], dim=2).contiguous()
    rows = torch.full((Xp.shape[0],), Xp.shape[1], dtype=torch.int64)
    return Zp, torch.tensor(vp), rows


def test_solve_groups_sharded_rls_matches_single_device():
    rng = np.random.default_rng(3)
    G, R, K = 8, 128, 3
    Xp, yp = rng.normal(size=(G, R, K)), rng.normal(size=(G, R))
    vp = rng.random((G, R)) > 0.1
    kwargs = dict(half_life=20.0, initial_state_covariance=10.0, initial_state_mean=None)
    Zp, v, rows = _rls_layout(Xp, yp, vp)
    single = recursive_least_squares(Zp, v, rows, **kwargs)
    out = solve_groups_sharded(make_mesh(8), recursive_least_squares, [Zp, v, rows], **kwargs)
    np.testing.assert_allclose(out.numpy(), single.numpy(), rtol=1e-10)
    ref = np.asarray(solve_recursive_least_squares(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(vp), chunk=64, **kwargs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-7, atol=1e-9)


def test_expression_api_agrees_with_sharded_fit():
    """The port's expression engine on one device and its sharded moments
    path give the same grouped coefficients, and so does the JAX
    engine."""
    X, y, gids = _grouped_data(n=1_000, k=2, g=5)
    data = {"y": y, "x1": X[:, 0], "x2": X[:, 1], "group": gids.astype(float)}
    exprs = {
        mod: mod.col("y").least_squares.ols("x1", "x2", mode="coefficients").over("group") for mod in (pt, pj)
    }
    coef = pt.DataFrame(data).select(exprs[pt], pt.col("group"))["coefficients"].to_numpy()
    jcoef = np.asarray(pj.DataFrame(data).select(exprs[pj], pj.col("group"))["coefficients"].values)
    beta, _ = _port_fit(make_mesh(8), X, y, gids, 5)
    np.testing.assert_allclose(coef, beta[gids], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(jcoef, beta[gids], rtol=1e-7, atol=1e-9)


def test_auto_shard_expression_api(monkeypatch):
    """CONFIG.auto_shard routes grouped fits through the sharded engine with
    the single-device results."""
    X, y, gids = _grouped_data(n=2_000, k=3, g=9)
    data = {"y": y, "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2], "g": gids.astype(float)}
    df = pt.DataFrame(data)
    expr = pt.col("y").least_squares.ols("x1", "x2", "x3").over("g")
    single = df.select(expr)["y"].to_numpy()
    monkeypatch.setattr(CONFIG, "auto_shard", True)
    before = sharded.calls["fit_moments"]
    out = df.select(expr)["y"].to_numpy()
    coefs = df.select(pt.col("y").least_squares.ols("x1", "x2", "x3", mode="coefficients").over("g"))
    assert sharded.calls["fit_moments"] == before + 2
    np.testing.assert_allclose(out, single, rtol=1e-10, atol=1e-12)
    jout = pj.DataFrame(data).select(pj.col("y").least_squares.ols("x1", "x2", "x3").over("g"))["y"].to_numpy()
    np.testing.assert_allclose(out, jout, rtol=1e-8, atol=1e-10)
    cm = coefs["coefficients"].to_numpy()
    for gi in range(9):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(cm[m][0], expected, rtol=1e-8, atol=1e-9)


def test_make_mesh_multiprocess_topology(monkeypatch):
    """A world size above 1 gives the ("hosts", "chips") mesh with the
    processes on the outer axis; faked at 4 over the 8 shards (4 x 2), as
    the JAX test fakes jax.process_count()."""
    monkeypatch.setattr(sharded, "_process_count", lambda: 4)
    mesh = make_mesh()
    assert tuple(mesh.axis_names) == ("hosts", "chips")
    assert mesh.devices.shape == (4, 2)
    assert mesh.group is None  # one process stands for the four
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    X, y, gids = _grouped_data(n=1_000, k=2, g=8, seed=4)
    beta, _ = _port_fit(mesh, X, y, gids, 8, row_axes=("hosts", "chips"))
    _check_lstsq(beta, X, y, gids, 8, atol=1e-9)
    np.testing.assert_allclose(beta, _jax_fit("mp", X, y, gids, 8)[0], **JAX_TOL)


def _expected_group_layout(X, y, w, gids, G, R):
    """Host oracle: each group's rows in global row order, padding slots
    invalid."""
    K = X.shape[1]
    Xg, yg, vg = np.zeros((G, R, K)), np.zeros((G, R)), np.zeros((G, R), dtype=bool)
    for g in range(G):
        rows = np.flatnonzero(gids == g)
        Xg[g, : len(rows)] = X[rows]
        yg[g, : len(rows)] = y[rows]
        vg[g, : len(rows)] = w[rows]
    return Xg, yg, vg


def _shuffle_data():
    rng = np.random.default_rng(7)
    N, K, G = 501, 3, 13
    X = rng.normal(size=(N, K))
    y = rng.normal(size=N)
    w = rng.random(N) > 0.1
    gids = rng.integers(G, size=N)
    return X, y, w, gids, G


@pytest.mark.parametrize(
    "n_devices,axes,shape",
    [(1, None, None), (4, None, None), (8, None, None), (8, ("hosts", "chips"), (4, 2))],
)
def test_shuffle_rows_to_groups_matches_host_layout(n_devices, axes, shape):
    """The all-to-all shuffle reproduces the host-built padded layout bit
    for bit, and the JAX package's shuffle on its 8-device mesh."""
    X, y, w, gids, G = _shuffle_data()
    mesh = make_mesh(n_devices, axis_names=axes, shape=shape)
    Xg, yg, vg, g_out = shuffle_rows_to_groups(mesh, *_t(X, y, w, gids), num_groups=G)
    assert g_out == G
    Xg, yg, vg = Xg.numpy(), yg.numpy(), vg.numpy()
    Xe, ye, ve = _expected_group_layout(X, y, w, gids, G, Xg.shape[1])
    np.testing.assert_array_equal(vg[:G], ve)
    np.testing.assert_array_equal(Xg[:G], Xe)
    np.testing.assert_array_equal(yg[:G], ye)
    assert not vg[G:].any()
    if "shuffle" not in _JAX:
        jX, jy, jv, _ = j_shuffle_rows_to_groups(
            j_make_mesh(8), jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(gids), num_groups=G
        )
        _JAX["shuffle"] = (np.asarray(jX)[:G], np.asarray(jy)[:G], np.asarray(jv)[:G])
    jX, jy, jv = _JAX["shuffle"]
    np.testing.assert_array_equal(Xg[:G], jX)
    np.testing.assert_array_equal(yg[:G], jy)
    np.testing.assert_array_equal(vg[:G], jv)


def test_shuffle_rows_feed_scan_solver():
    """Rows in place -> the all-to-all shuffle -> the group-sharded RLS
    equals the single-device solve on the host-built layout, and the JAX
    lane solver there."""
    rng = np.random.default_rng(11)
    N, K, G = 640, 2, 8
    X = rng.normal(size=(N, K))
    gids = rng.integers(G, size=N)
    beta_g = rng.normal(size=(G, K))
    y = np.einsum("nk,nk->n", X, beta_g[gids]) + 0.01 * rng.normal(size=N)
    w = np.ones(N, dtype=bool)
    mesh = make_mesh(8)
    Xg, yg, vg, _ = shuffle_rows_to_groups(mesh, *_t(X, y, w, gids), num_groups=G)
    kw = dict(half_life=None, initial_state_covariance=10.0, initial_state_mean=None)
    Zp = torch.cat([yg[..., None], Xg], dim=2).contiguous()
    rows = vg.shape[1] * torch.ones(vg.shape[0], dtype=torch.int64)
    out = solve_groups_sharded(mesh, recursive_least_squares, [Zp, vg, rows], **kw).numpy()[:G]
    Xe, ye, ve = _expected_group_layout(X, y, w, gids, G, Xg.shape[1])
    Ze, v, r = _rls_layout(Xe, ye, ve)
    single = recursive_least_squares(Ze, v, r, **kw).numpy()
    np.testing.assert_allclose(out, single, rtol=1e-12, atol=1e-12)
    ref = np.asarray(solve_recursive_lanes(jnp.asarray(Xe), jnp.asarray(ye), jnp.asarray(ve), **kw))
    np.testing.assert_allclose(out, ref, rtol=1e-7, atol=1e-9)


def test_two_gloo_processes_on_a_hosts_chips_mesh(tmp_path):
    """Two processes joined by gloo, two shards each: make_mesh gives the 2 x
    2 ("hosts", "chips") mesh; fit_moments_sharded matches lstsq and
    shuffle_rows_to_groups the host layout of each process's groups."""
    import torch.multiprocessing as mp

    import torch_dist_worker

    ctx = mp.start_processes(
        torch_dist_worker.run, args=(str(tmp_path),), nprocs=2, join=False, start_method="spawn"
    )
    deadline = time.monotonic() + 60
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo processes did not finish in 60 s")
    for r in range(2):
        path = tmp_path / f"rank{r}.txt"
        assert path.exists(), f"rank {r} wrote nothing"
        msg = path.read_text()
        assert msg == "ok", msg
