"""One process of the two-process gloo check in tests/test_torch_parallel.py.

Imports torch and the PyTorch port only (the test spawns it; jax stays out
of the child). Each process drives two shards on the CPU, so the mesh is
("hosts", "chips") = 2 x 2; both pass the same global arrays. The process
writes "ok" or the failure to ``<out_dir>/rank<r>.txt``.
"""

import datetime
import os
import traceback

import numpy as np


def _grouped_data(n=1_000, k=2, g=8, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    beta_g = rng.normal(size=(g, k))
    gids = rng.integers(g, size=n)
    y = np.einsum("nk,nk->n", X, beta_g[gids]) + rng.normal(size=n) * 0.1
    return X, y, gids


def run(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from polars_ols_tpu_torch import CONFIG
        from polars_ols_tpu_torch.parallel import fit_moments_sharded, make_mesh, shuffle_rows_to_groups

        CONFIG.device = "cpu"
        CONFIG.virtual_devices = 2
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(out_dir, "pg"), rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=60),
        )
        mesh = make_mesh()
        assert mesh.axis_names == ("hosts", "chips") and mesh.devices.shape == (2, 2), mesh
        X, y, gids = _grouped_data()
        beta, preds = fit_moments_sharded(
            mesh, torch.tensor(X), torch.tensor(y), torch.ones(len(y), dtype=torch.bool),
            torch.tensor(gids), num_groups=8,
        )
        beta = beta.numpy()
        for g in range(8):
            m = gids == g
            np.testing.assert_allclose(beta[g], np.linalg.lstsq(X[m], y[m], rcond=None)[0], rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(preds.numpy(), np.einsum("nk,nk->n", X, beta[gids]), rtol=1e-10, atol=1e-12)
        # the shuffle: this process holds the groups of its two shards
        rng = np.random.default_rng(7)
        N, K, G = 501, 3, 13
        X = rng.normal(size=(N, K))
        y = rng.normal(size=N)
        w = rng.random(N) > 0.1
        gids = rng.integers(G, size=N)
        Xg, yg, vg, _ = shuffle_rows_to_groups(
            mesh, torch.tensor(X), torch.tensor(y), torch.tensor(w), torch.tensor(gids), num_groups=G
        )
        gps = -(-G // 4)
        first = rank * 2 * gps
        assert Xg.shape[0] == 2 * gps, Xg.shape
        for j in range(2 * gps):
            g = first + j
            rows = np.flatnonzero(gids == g) if g < G else np.array([], dtype=np.int64)
            np.testing.assert_array_equal(Xg[j, : len(rows)].numpy(), X[rows])
            np.testing.assert_array_equal(yg[j, : len(rows)].numpy(), y[rows])
            np.testing.assert_array_equal(vg[j, : len(rows)].numpy(), w[rows])
            assert not vg[j, len(rows):].any()
        dist.barrier()
        msg = "ok"
    except Exception:  # reported to the parent through the file
        msg = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(msg)
