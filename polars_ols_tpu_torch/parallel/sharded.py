"""Multi-device grouped least squares: a mesh of torch devices and its
collectives.

The port of the JAX package's ``parallel/sharded.py``. That engine is one
controller: a process holds the frame and reaches every device through a
``Mesh``. Here too one process drives every local device: a ``Mesh`` is a
grid of torch devices with axis names, and a sharded function runs each
shard's part on its device from the one process. ``torch.distributed``
carries only the outer axis of a multi-process ``("hosts", "chips")`` mesh.

* **Rows stay where they are, partial moments merge exactly**
  (``fit_moments_sharded``, ``statistics_moments_sharded``). Shard ``s``
  holds rows ``s L .. (s + 1) L - 1`` (``L = Np / n``, rows padded to a
  multiple ``Np`` of the n shards, padding outside the fit). Each shard
  computes the partial moments of all ``Gp`` groups from its own rows with
  the moment kernel (ops/moments.py, on the shard's own split-padded
  layout), and one reduce-scatter sums the partials of every group and
  hands shard ``s`` its groups ``s Gp / n .. (s + 1) Gp / n - 1``. Moments
  add, so a group whose rows span shards (a heavy group, skew) gets the
  moments of all of its rows: no row moves. Each shard solves its groups
  alone (Cholesky with the CSNE sweeps past a condition estimate of 1e6,
  LU, coordinate descent, the statistics' feature metrics); an all-gather
  replicates the coefficients for the row-local predictions. Only ``[G, C,
  C]`` moments, ``[G, K]`` coefficients and ``[G]`` counts move.
* **Whole-group solves run group-parallel** (``solve_groups_sharded``):
  solvers that need a group's rows together (the moving models, the SVD
  of ``svd`` and multi-target fits, row-form coordinate descent) run on
  each shard's slice of the padded ``[G, ...]`` arrays with no collective.
* **One all-to-all shuffles rows to their groups' shards**
  (``shuffle_rows_to_groups``), each group's rows in global row order.

The collectives are written once (``_Comm``): each takes a list of
per-shard tensors, one for each shard this process drives. Between CUDA
devices of one process data moves by device-to-device copies
(``Tensor.to``): transfers, not kernels. Shards that share a device
(``CONFIG.virtual_devices``) share its memory, and a copy to the same
device is none. In a multi-process mesh every process passes the same
global arrays and drives the shards of its row of the mesh; the hosts axis
goes through ``torch.distributed`` (``all_reduce``,
``all_gather_into_tensor``, ``all_to_all_single``; a gloo group takes CPU
copies).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CONFIG, F64, device
from ..engine.fit import _block_preds
from ..engine.groups import build_layout, bucket_size, split_padded_indices
from ..ops.cd import solve_elastic_net_cov
from ..ops.linalg import psd_solver, solve_lu, solve_psd, solve_psd_cond
from ..ops.moments import grouped_moments_blocks
from ..ops.statistics import feature_metrics

# cond(X'X) beyond which the sharded normal-equation solve runs the CSNE
# sweeps (engine/fit.py's gate on one device)
_COND_REFINE = 1.0e6

# calls of each sharded entry point since the last reset (the tests and the
# smoke read them to see that a query took the sharded path)
calls = {"fit_moments": 0, "statistics_moments": 0, "groups": 0, "shuffle": 0}
# fits that took the CSNE sweeps (``_refine``) since the last reset
csne_runs = 0

# shard layouts kept (``_row_shards``): the engine's repeated queries on one
# layout build them once
_SHARD_CACHE_LIMIT = 4
_SHARD_CACHE: dict = {}


class Mesh:
    """Devices in a grid, with axis names.

    Attributes:
        devices: object ndarray of ``torch.device``, one entry a shard of
            the grid (a device may appear several times: virtual shards).
        axis_names: one name per grid axis.
        group: the ``torch.distributed`` process group of the first axis
            (``"hosts"``) of a multi-process mesh, whose row ``rank`` this
            process drives; None when one process drives the whole grid.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.ravel()})})"


def _process_count() -> int:
    """Processes in the default ``torch.distributed`` group (1 where none
    is initialised)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _local_devices() -> List[torch.device]:
    """This process's shards: ``CONFIG.virtual_devices`` of them on the
    configured device where set, else every CUDA device (the device is
    CUDA) or the one CPU."""
    dev = device()
    if CONFIG.virtual_devices > 0:
        return [dev] * int(CONFIG.virtual_devices)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _grid(devs: Sequence[torch.device], shape: Sequence[int]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(tuple(shape))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Optional[Sequence[str]] = None,
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a device mesh.

    With ``torch.distributed`` at a world size above 1, the mesh is the 2-D
    ``("hosts", "chips")`` grid: the outer axis the processes (its
    collectives go through ``torch.distributed``), the inner one each
    process's local devices, so a reduction over both axes sums a host's
    shards first and sends only moments across processes. One process gets
    the flat ``("data",)`` mesh of its devices (``n_devices`` of them);
    ``shape`` with two axis names gives an explicit 2-D grid."""
    if axis_names is None:
        n_proc = _process_count()
        if n_proc > 1 and n_devices is None and shape is None:
            import torch.distributed as dist

            local = _local_devices()
            if dist.is_available() and dist.is_initialized():
                return Mesh(_grid(local * n_proc, (n_proc, len(local))), ("hosts", "chips"), dist.group.WORLD)
            # one process standing for several: its devices split by rows
            return Mesh(_grid(local, (n_proc, len(local) // n_proc)), ("hosts", "chips"))
        axis_names = ("data",)
    devs = _local_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} visible")
        devs = devs[:n_devices]
    if shape is None:
        if len(axis_names) != 1:
            raise AssertionError("2-D meshes require an explicit shape")
        shape = (len(devs),)
    return Mesh(_grid(devs, shape), axis_names)


def mesh_row_axes(mesh: Mesh):
    """The axes that shard the row or group dimension over every shard of a
    mesh: the one name of a 1-D mesh, else the tuple of its names."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _linear_axis_index(axes, mesh: Mesh, coord: Sequence[int]) -> int:
    """The flat shard index (row-major over ``axes``) of the grid position
    ``coord``."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + int(coord[mesh.axis_names.index(a)])
    return idx


def _mesh_size(mesh: Mesh, axes) -> int:
    size = 1
    for a in _axes(axes):
        size *= mesh.shape[a]
    return size


def _pad_to(x, n: int, axis: int = 0):
    """``x`` (a tensor or a host array) zero-padded along ``axis`` to ``n``."""
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    widths = [(0, 0)] * np.ndim(x)
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths)


@contextlib.contextmanager
def _on(dev: torch.device):
    """Library calls (a Cholesky, an eigh) made for a shard run on its
    device."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            yield
    else:
        yield


# --------------------------------------------------------------------------- #
# the collectives
# --------------------------------------------------------------------------- #
class _Comm:
    """The shards of ``mesh`` along ``axes`` and their collectives.

    ``local``: (flat shard index, device) of each shard this process
    drives, in shard order; every collective takes one tensor of each, in
    that order, and sums in shard order. A multi-process mesh shards over
    its hosts axis first: this process drives shards ``rank * chips ..
    (rank + 1) * chips - 1``."""

    def __init__(self, mesh: Mesh, axes=None) -> None:
        axes = _axes(mesh_row_axes(mesh) if axes is None else axes)
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(f"axis {a!r} is not an axis of the mesh {mesh.axis_names}")
        self.n = _mesh_size(mesh, axes)
        self.group = mesh.group
        self.hosts, self.rank = 1, 0
        if self.group is not None:
            import torch.distributed as dist

            if axes[0] != mesh.axis_names[0]:
                raise ValueError(
                    f"a multi-process mesh shards over its {mesh.axis_names[0]!r} axis first, got {axes}"
                )
            self.hosts, self.rank = mesh.shape[axes[0]], dist.get_rank(self.group)
            self.gloo = dist.get_backend(self.group) == "gloo"
        self.chips = self.n // self.hosts
        sizes = [mesh.shape[a] for a in axes]
        local = []
        for s in range(self.n):
            coord = [0] * mesh.devices.ndim
            for a, c in zip(axes, np.unravel_index(s, sizes)):
                coord[mesh.axis_names.index(a)] = int(c)
            if self.group is None or coord[0] == self.rank:
                local.append((s, mesh.devices[tuple(coord)]))
        self.local = local
        self.devices = [d for _, d in local]

    # -- the hosts axis ----------------------------------------------------- #
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu" if self.gloo else t.device, copy=True).contiguous()

    def _hosts_sum(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.group is None:
            return t
        import torch.distributed as dist

        buf = self._wire(t)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=self.group)
        return buf.to(t.device)

    def _hosts_gather(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return t
        import torch.distributed as dist

        buf = self._wire(t)
        out = buf.new_empty((self.hosts * buf.shape[0],) + tuple(buf.shape[1:]))
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out.to(t.device)

    # -- the collectives ---------------------------------------------------- #
    def _local_sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        d0 = self.devices[0]
        total = parts[0].to(d0)
        for p in parts[1:]:
            total = total + p.to(d0)
        return total

    def reduce_scatter(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled reduce-scatter along axis 0 (``psum_scatter(...,
        tiled=True)``): shard s gets block s of the sum of every shard's
        ``[n b, ...]`` part, ``[b, ...]`` on its device."""
        b = parts[0].shape[0] // self.n
        if self.group is None:
            outs = []
            for s, dev in self.local:
                acc = parts[0][s * b:(s + 1) * b].to(dev)
                for p in parts[1:]:
                    acc = acc + p[s * b:(s + 1) * b].to(dev)
                outs.append(acc)
            return outs
        total = self._hosts_sum(self._local_sum(parts))
        return [total[s * b:(s + 1) * b].to(dev) for s, dev in self.local]

    def psum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of every shard's part, on each shard's device."""
        total = self._hosts_sum(self._local_sum(parts))
        return [total.to(dev) for dev in self.devices]

    def pmax(self, values: List[torch.Tensor]) -> torch.Tensor:
        """The largest entry of every shard's ``values``, a [1] tensor on
        the first local device."""
        d0 = self.devices[0]
        m = torch.stack([v.to(d0).reshape(-1).amax() for v in values]).amax().reshape(1)
        return self._hosts_sum(m, op="max")

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all-gather along axis 0: every shard's ``[b, ...]`` part
        concatenated in shard order, ``[n b, ...]`` on each shard's device
        (one copy a distinct device)."""
        built = {}
        for dev in self.devices:
            if dev not in built:
                built[dev] = self._hosts_gather(torch.cat([p.to(dev) for p in parts]))
        return [built[dev] for dev in self.devices]

    def all_to_all(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all-to-all: each shard's ``[n, C, W]`` buffer sends its
        block j to shard j; shard j gets ``[n C, W]``, the blocks in source
        shard order."""
        if self.group is None:
            return [torch.cat([b[s].to(dev) for b in bufs]) for s, dev in self.local]
        import torch.distributed as dist

        d0, c = self.devices[0], self.chips
        # [hosts (dest), chips (local src), chips (dest), C, W]
        send = torch.stack([torch.stack([b[h * c:(h + 1) * c].to(d0) for b in bufs]) for h in range(self.hosts)])
        wire = self._wire(send)
        recv = torch.empty_like(wire)
        dist.all_to_all_single(recv, wire, group=self.group)
        recv = recv.to(d0)  # [hosts (src), chips (src), chips (local dest), C, W]
        W = recv.shape[-1]
        return [recv[:, :, j].reshape(-1, W).to(dev) for j, dev in enumerate(self.devices)]


# --------------------------------------------------------------------------- #
# rows in place: the shards' layouts and partial moments
# --------------------------------------------------------------------------- #
@dataclass
class _Shard:
    """One shard's rows ``lo .. lo + L - 1`` of the padded rows (``real``
    of them real), their layout of all ``Gp`` groups, uploaded to its
    device: the split-padded gather, slot mask, block groups and CSR
    offsets, and its rows' group ids."""

    s: int
    dev: torch.device
    lo: int
    real: int
    gather: torch.Tensor
    pmask: torch.Tensor
    block_group: torch.Tensor
    offsets: torch.Tensor
    gids: torch.Tensor


@dataclass
class _RowShards:
    n: int
    N: int
    L: int
    Gp: int
    shards: List[_Shard]  # this process's
    rows_of: List[Tuple[int, torch.Tensor]]  # every shard's (local index that predicts it, group ids there)

    @property
    def gps(self) -> int:
        return self.Gp // self.n


def _host_gids(gids) -> np.ndarray:
    if isinstance(gids, torch.Tensor):
        return gids.detach().cpu().numpy().astype(np.int64, copy=False)
    return np.asarray(gids, dtype=np.int64)


def _row_shards(comm: _Comm, gids, N: int, num_groups: int) -> _RowShards:
    """The shards' row blocks and layouts, built on the host from the group
    ids and kept for repeated calls on the same host ids array."""
    g_host = _host_gids(gids)
    n = comm.n
    L = -(-N // n) if N else 1
    Gp = -(-num_groups // n) * n
    key = (id(g_host), N, n, Gp, CONFIG.moment_chunk_rows, tuple(str(d) for d in comm.devices), comm.rank)
    hit = _SHARD_CACHE.get(key)
    if hit is not None and hit[0] is g_host:
        return hit[1]
    gp = _pad_to(g_host, n * L)
    shards, rows_of = [], []
    for j, (s, dev) in enumerate(comm.local):
        lo = s * L
        gl = gp[lo:lo + L]
        layout = build_layout(gl, L, num_groups=Gp)
        r_cap = min(CONFIG.moment_chunk_rows, bucket_size(max(8, int(layout.counts.max()))))
        gather, pmask, block_group, _ = split_padded_indices(layout, r_cap)
        offsets = np.zeros(Gp + 1, dtype=np.int64)
        np.cumsum(layout._blocks_per_group(r_cap), out=offsets[1:])

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        shards.append(_Shard(
            s, dev, lo, max(0, min(L, N - lo)), up(gather.reshape(-1), torch.int64), up(pmask, torch.bool),
            up(block_group, torch.int64), up(offsets, torch.int64), up(gl, torch.int64),
        ))
    by_s = {sh.s: sh for sh in shards}
    for s in range(n):
        if s in by_s:
            rows_of.append((shards.index(by_s[s]), by_s[s].gids))
        else:  # another process's rows: predicted here from the replicated coefficients
            j = s % len(shards)
            rows_of.append((j, torch.as_tensor(gp[s * L:(s + 1) * L], dtype=torch.int64, device=shards[j].dev)))
    out = _RowShards(n, N, L, Gp, shards, rows_of)
    if len(_SHARD_CACHE) >= _SHARD_CACHE_LIMIT:
        _SHARD_CACHE.pop(next(iter(_SHARD_CACHE)))
    _SHARD_CACHE[key] = (g_host, out)
    return out


def _rows(t: torch.Tensor, lo: int, L: int, dev: torch.device) -> torch.Tensor:
    """Rows ``lo .. lo + L - 1`` of ``t`` on ``dev``, zero past its end."""
    return _pad_to(t[lo:lo + L], L).to(dev)


@dataclass
class _Blocks:
    Zp: torch.Tensor  # [S, R, 1+K] the shard's split-padded blocks, target first
    wp: torch.Tensor  # [S, R] fit mask
    M: torch.Tensor  # [Gp, 1+K, 1+K] partial moments
    counts: torch.Tensor  # [Gp]


def _partial_moments(rs: _RowShards, X, y, w) -> List[_Blocks]:
    """Each local shard's blocks of its rows and their partial moments for
    all Gp groups, from the moment kernel (``grouped_moments_blocks``:
    csrc/moments.cu on the card)."""
    out = []
    for sh in rs.shards:
        Xl = _rows(X.to(F64), sh.lo, rs.L, sh.dev)
        yl = _rows(y.to(F64), sh.lo, rs.L, sh.dev)
        wl = _rows(w.to(torch.bool), sh.lo, rs.L, sh.dev)
        Z = torch.cat([yl[:, None], Xl], dim=1)
        S, R = sh.pmask.shape
        Zp = Z.index_select(0, sh.gather).reshape(S, R, Z.shape[1])
        wp = sh.pmask & wl.index_select(0, sh.gather).reshape(S, R)
        M, counts = grouped_moments_blocks(Zp, wp, sh.offsets, rs.Gp)
        out.append(_Blocks(Zp, wp, M, counts))
    return out


def _group_sums(b: _Blocks, sh: _Shard, v: torch.Tensor) -> torch.Tensor:
    """Per-group sums [Gp, ...] of the block rows' values ``v`` [S, R, ...]
    (zero outside the fit mask), the blocks of a group in block order."""
    mask = b.wp if v.dim() == 2 else b.wp[..., None]
    return torch.segment_reduce(torch.where(mask, v, 0.0).sum(dim=1), "sum", offsets=sh.offsets, axis=0)


def _residuals(b: _Blocks, sh: _Shard, beta: torch.Tensor) -> torch.Tensor:
    """The block rows' residuals ``y - X beta[group]`` [S, R], zero outside
    the fit mask (selected away: a NaN in a padding slot stays there)."""
    bb = beta.index_select(0, sh.block_group)
    return torch.where(b.wp, b.Zp[..., 0] - _block_preds(b.Zp[..., 1:], bb), 0.0)


def _predictions(comm: _Comm, rs: _RowShards, Xpred, beta_rep: List[torch.Tensor]) -> torch.Tensor:
    """Predictions [N] on the configured device: each shard's rows against
    its group's coefficients (replicated on every shard); the rows of
    another process's shards are predicted by this one's."""
    out = []
    for s, (j, gl) in enumerate(rs.rows_of):
        dev = rs.shards[j].dev
        Xl = _rows(Xpred.to(F64), s * rs.L, rs.L, dev)
        out.append(_block_preds(Xl[:, None, :], beta_rep[j].index_select(0, gl))[:, 0].to(device()))
    return torch.cat(out)[: rs.N]


def _cd_args(cd_params):
    l1_ratio, max_iter, tol, positive = cd_params[:4]
    active_set = bool(cd_params[4]) if len(cd_params) > 4 else False
    return dict(
        l1_ratio=float(l1_ratio), max_iter=int(max_iter), tol=float(tol), positive=bool(positive),
        active_set=active_set,
    )


# --------------------------------------------------------------------------- #
# the moments path: OLS / WLS / ridge / LU / CD and statistics
# --------------------------------------------------------------------------- #
def fit_moments_sharded(
    mesh: Mesh,
    X: torch.Tensor,  # [N, K] fit features (excluded rows zeroed)
    y: torch.Tensor,  # [N]
    w: torch.Tensor,  # [N] bool fit mask
    gids,  # [N] int group ids (a tensor or a host array)
    num_groups: int,
    alpha: float = 0.0,
    row_axes=None,
    cd_params: Optional[tuple] = None,
    X_pred: Optional[torch.Tensor] = None,
    force_refine: bool = False,
    lu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded grouped normal-equation (or covariance-form CD) fit.

    Returns (beta [G, K], predictions [N]) on the configured device. Rows
    may sit on any shard in any order: the reduce-scatter of the partial
    moments merges groups that span shards exactly. ``cd_params =
    (l1_ratio, max_iter, tol, positive[, active_set])`` solves each
    shard's groups by coordinate descent on the moments (lasso / elastic
    net / NNLS); ``lu`` by partial-pivot LU; otherwise the Cholesky solve,
    followed by four CSNE sweeps where the largest condition estimate on
    any shard passes 1e6, and always with ``force_refine`` (``qr``). The
    sweeps' ``X'r`` partials are reduce-scattered like the moments.
    ``X_pred`` gives the features the predictions are formed from, where
    the null policy makes them differ from the fit's."""
    calls["fit_moments"] += 1
    comm = _Comm(mesh, row_axes)
    N, K = X.shape
    rs = _row_shards(comm, gids, N, num_groups)
    blocks = _partial_moments(rs, X, y, w)
    M = comm.reduce_scatter([b.M for b in blocks])
    eye = torch.eye(K, dtype=F64, device=X.device)
    betas, As, conds = [], [], []
    if cd_params is not None:
        counts = comm.reduce_scatter([b.counts for b in blocks])
        cd = _cd_args(cd_params)
        for sh, Ms, cs in zip(rs.shards, M, counts):
            w_cd, _ = solve_elastic_net_cov(
                Ms[:, 1:, 1:].contiguous(), Ms[:, 1:, 0].contiguous(), cs.contiguous(), float(alpha), **cd
            )
            betas.append(w_cd)
    else:
        for sh, Ms in zip(rs.shards, M):
            A = Ms[:, 1:, 1:] + float(alpha) * eye.to(sh.dev)
            xty = Ms[:, 1:, 0]
            with _on(sh.dev):
                if lu:
                    betas.append(solve_lu(A, xty))
                elif force_refine:
                    betas.append(solve_psd(A, xty))
                else:
                    b, cond = solve_psd_cond(A, xty)
                    betas.append(b)
                    conds.append(cond)
            As.append(A)
        if not lu and (force_refine or float(comm.pmax(conds).item()) > _COND_REFINE):
            betas = _refine(comm, rs, blocks, As, betas, float(alpha))
    beta_rep = comm.all_gather(betas)
    preds = _predictions(comm, rs, X if X_pred is None else X_pred, beta_rep)
    return beta_rep[0][:num_groups].to(device()), preds


def _refine(comm: _Comm, rs: _RowShards, blocks: List[_Blocks], As, betas, alpha: float):
    """Four CSNE sweeps (engine/fit.py's ``_csne_refine_blocks``, sharded):
    each shard's residuals of its rows against the replicated coefficients,
    the ``X'r`` partials reduce-scattered, ``b += A^-1 (X'r - alpha b)``
    with each shard's normal matrix factored once."""
    global csne_runs
    csne_runs += 1
    solves = []
    for sh, A in zip(rs.shards, As):
        with _on(sh.dev):
            solves.append(psd_solver(A))
    for _ in range(4):
        rep = comm.all_gather(betas)
        parts = []
        for sh, b, bg in zip(rs.shards, blocks, rep):
            r = _residuals(b, sh, bg)
            parts.append(_group_sums(b, sh, b.Zp[..., 1:] * r[..., None]))
        xtr = comm.reduce_scatter(parts)
        new = []
        for sh, beta, x, solve in zip(rs.shards, betas, xtr, solves):
            with _on(sh.dev):
                new.append(beta + solve(x - alpha * beta))
        betas = new
    return betas


def statistics_moments_sharded(
    mesh: Mesh,
    X: torch.Tensor,  # [N, K] fit features (excluded rows zeroed)
    y: torch.Tensor,  # [N]
    w: torch.Tensor,  # [N] bool fit mask
    gids,  # [N]
    num_groups: int,
    alpha: float = 0.0,
    row_axes=None,
    cd_params: Optional[tuple] = None,
) -> dict:
    """Sharded ``mode="statistics"``: the moments reduce-scatter as in
    ``fit_moments_sharded``; counts and the per-group sums of y go through
    ``psum``; each shard solves its groups and computes their feature
    metrics (ops/statistics.py, the p-values by csrc/t_pvalue.cu on the
    card); RSS, SAE and SST come from the rows' residual partials, summed
    by ``psum``; the [G] and [G, K] results are gathered. Returns a dict of
    [G(, K)] tensors on the configured device.

    With ``cd_params`` the coefficients and residual metrics are coordinate
    descent's, while se / t / p keep the normal equations' RSS (the
    reference recomputes beta from them, src/statistics.rs:116)."""
    calls["statistics_moments"] += 1
    comm = _Comm(mesh, row_axes)
    N, K = X.shape
    rs = _row_shards(comm, gids, N, num_groups)
    gps = rs.gps
    blocks = _partial_moments(rs, X, y, w)
    counts = comm.psum([b.counts for b in blocks])
    sumy = comm.psum([_group_sums(b, sh, b.Zp[..., 0]) for b, sh in zip(blocks, rs.shards)])
    M = comm.reduce_scatter([b.M for b in blocks])
    cd = None if cd_params is None else _cd_args(cd_params)
    eye = torch.eye(K, dtype=F64, device=X.device)
    beta_ne, betas, mine = [], [], []
    for sh, Ms, cs in zip(rs.shards, M, counts):
        xtx, xty = Ms[:, 1:, 1:], Ms[:, 1:, 0]
        c = cs[sh.s * gps:(sh.s + 1) * gps]
        mine.append((xtx, xty, c))
        with _on(sh.dev):
            ne = solve_psd(xtx + float(alpha) * eye.to(sh.dev), xty)
        beta_ne.append(ne)
        if cd is None:
            betas.append(ne)
        else:
            betas.append(solve_elastic_net_cov(xtx.contiguous(), xty.contiguous(), c.contiguous(), float(alpha), **cd)[0])

    def residual_sums(beta_parts):
        rep = comm.all_gather(beta_parts)
        rss, sae = [], []
        for sh, b, bg in zip(rs.shards, blocks, rep):
            r = _residuals(b, sh, bg)
            rss.append(_group_sums(b, sh, r * r))
            sae.append(_group_sums(b, sh, r.abs()))
        return rep, comm.psum(rss), comm.psum(sae)

    beta_rep, rss, sae = residual_sums(betas)
    sst_parts = []
    for sh, b, cs, sy in zip(rs.shards, blocks, counts, sumy):
        mean = (sy / torch.clamp_min(cs, 1.0)).index_select(0, sh.block_group)
        dev_ = b.Zp[..., 0] - mean[:, None]
        sst_parts.append(_group_sums(b, sh, dev_ * dev_))
    sst = comm.psum(sst_parts)
    rss_ne = rss if cd is None else residual_sums(beta_ne)[1]
    se, tv, pv = [], [], []
    for sh, (xtx, xty, c), r in zip(rs.shards, mine, rss_ne):
        with _on(sh.dev):
            fm = feature_metrics(xtx, xty, r[sh.s * gps:(sh.s + 1) * gps].contiguous(), c, float(alpha))
        se.append(fm["standard_errors"])
        tv.append(fm["t_values"])
        pv.append(fm["p_values"])
    out_dev = device()
    n_safe = torch.clamp_min(counts[0], 1.0)
    sl = slice(None, num_groups)

    def gathered(parts):
        return comm.all_gather(parts)[0][sl].to(out_dev)

    return {
        "coefficients": beta_rep[0][sl].to(out_dev),
        "mse": (rss[0] / n_safe)[sl].to(out_dev),
        "mae": (sae[0] / n_safe)[sl].to(out_dev),
        "r2": (1.0 - rss[0] / sst[0])[sl].to(out_dev),
        "standard_errors": gathered(se),
        "t_values": gathered(tv),
        "p_values": gathered(pv),
    }


# --------------------------------------------------------------------------- #
# the group-parallel path: whole-group solvers
# --------------------------------------------------------------------------- #
def shard_group_axis(mesh: Mesh, arrays, group_axes=None):
    """Split ``[G, ...]`` arrays (tensors or host arrays) over the shards
    by their leading group axis, padded with zeros to a multiple ``Gp`` of
    the mesh size: shard s gets groups ``s Gp / n .. (s + 1) Gp / n - 1``,
    a tensor on its device, a host array as it is. Returns (for each shard
    this process drives, the list of its slices; the true G); callers
    slice results back to G."""
    comm = _Comm(mesh, group_axes)
    G = arrays[0].shape[0]
    Gp = -(-G // comm.n) * comm.n
    b = Gp // comm.n
    padded = [_pad_to(a, Gp) for a in arrays]
    placed = []
    for s, dev in comm.local:
        placed.append([
            a[s * b:(s + 1) * b].to(dev) if isinstance(a, torch.Tensor) else a[s * b:(s + 1) * b]
            for a in padded
        ])
    return placed, G


def solve_groups_sharded(mesh: Mesh, solver: Callable, arrays, group_axes=None, **solver_kwargs):
    """Run a batched whole-group solver with the group axis sharded.

    ``solver(*arrays, **solver_kwargs)`` must be batched over the leading
    group axis (the moving models of ops/moving.py, the SVD solves,
    ops/cd.py:solve_elastic_net qualify). Each shard runs it on its slice
    of groups with no communication; the results are concatenated in shard
    order on the configured device (across processes, gathered) and
    sliced back to the true G."""
    calls["groups"] += 1
    comm = _Comm(mesh, group_axes)
    placed, G = shard_group_axis(mesh, arrays, group_axes)
    outs = []
    for (s, dev), args in zip(comm.local, placed):
        with _on(dev):
            outs.append(solver(*args, **solver_kwargs))
    if comm.group is not None:
        return comm.all_gather(outs)[0][:G].to(device())
    return torch.cat([o.to(device()) for o in outs])[:G]


def shuffle_rows_to_groups(
    mesh: Mesh,
    X: torch.Tensor,  # [N, K]
    y: torch.Tensor,  # [N]
    w: torch.Tensor,  # [N] bool validity (invalid rows keep their position)
    gids,  # [N] int group ids
    num_groups: int,
    row_axes=None,
    rows_per_group: Optional[int] = None,
    capacity: Optional[int] = None,
):
    """All-to-all shuffle of rows to their groups' home shards.

    Rows sit on the shards in blocks of ``L`` in row order, as
    ``fit_moments_sharded`` places them. Group g's home shard is ``g //
    (Gp / n)``, the block the reduce-scatter of the moments path gives it.
    Each shard packs its rows as records ``[present, ridx, gid, w, y,
    X...]`` into ``capacity`` slots for each destination, one
    ``all_to_all`` delivers them, and each shard assembles the padded
    ``[Gp / n, R]`` layout of its groups, each group's rows in global row
    order (the scans' time order); padding slots are invalid and zero.

    Returns ``(Xg [., R, K], yg [., R], vg [., R] bool, G)`` on the
    configured device: all ``Gp`` groups in one process; in a
    multi-process mesh, the groups of this process's shards (from ``rank
    * chips * Gp / n``). ``rows_per_group`` (R) and ``capacity`` (the most
    rows one source shard sends one destination) come from the group ids
    by default; a value below what the rows need raises ``ValueError``
    (too small a bucket would drop rows)."""
    calls["shuffle"] += 1
    comm = _Comm(mesh, row_axes)
    n = comm.n
    N, K = X.shape
    L = -(-N // n) if N else 1
    Np = L * n
    Gp = -(-num_groups // n) * n
    gps = Gp // n

    g_host = _host_gids(gids)
    dest_host = g_host // gps
    src_host = np.arange(N, dtype=np.int64) // L
    pair_max = int(np.bincount(src_host * n + dest_host, minlength=n * n).max()) if N else 0
    if capacity is None:
        capacity = bucket_size(max(pair_max, 1))
    elif capacity < pair_max:
        raise ValueError(
            f"shuffle capacity {capacity} < max rows a single src->dest "
            f"shard pair exchanges ({pair_max})"
        )
    rows_max = int(np.bincount(g_host, minlength=num_groups).max()) if N else 0
    if rows_per_group is None:
        rows_per_group = bucket_size(max(rows_max, 1))
    elif rows_per_group < rows_max:
        raise ValueError(f"rows_per_group {rows_per_group} < largest group ({rows_max})")
    C, R = int(capacity), int(rows_per_group)
    W = K + 5
    gt = torch.as_tensor(g_host, dtype=F64)

    bufs = []
    for s, dev in comm.local:  # send side: bucket the rows by destination
        lo = s * L
        real = max(0, min(L, N - lo))
        present = (torch.arange(L, device=dev) < real).to(F64)
        ridx = torch.arange(lo, lo + L, dtype=F64, device=dev)
        gl = _rows(gt, lo, L, dev)
        rec = torch.cat([
            present[:, None], ridx[:, None], gl[:, None], _rows(w.to(F64), lo, L, dev)[:, None],
            _rows(y.to(F64), lo, L, dev)[:, None], _rows(X.to(F64), lo, L, dev),
        ], dim=1)
        dest = torch.where(present > 0, gl.to(torch.int64) // gps, n)
        order = torch.sort(dest, stable=True).indices
        dsort = dest.index_select(0, order)
        cnt = torch.bincount(dsort, minlength=n + 1)
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.arange(L, device=dev) - first.index_select(0, dsort)
        ok = (dsort < n) & (pos < C)
        buf = torch.zeros((n, C, W), dtype=F64, device=dev)
        buf[dsort[ok], pos[ok]] = rec.index_select(0, order)[ok]
        bufs.append(buf)

    recvs = comm.all_to_all(bufs)  # the one collective

    Xs, ys, vs = [], [], []
    for (s, dev), recv in zip(comm.local, recvs):  # receive side: the [gps, R] layout
        here = recv[:, 0] > 0
        lg = torch.where(here, recv[:, 2].to(torch.int64) - s * gps, gps)
        key = lg.to(F64) * (Np + 1) + torch.where(here, recv[:, 1], 0.0)
        r_order = torch.sort(key, stable=True).indices
        lgs = lg.index_select(0, r_order)
        rcnt = torch.bincount(lgs, minlength=gps + 1)
        rfirst = torch.cumsum(rcnt, 0) - rcnt
        rpos = torch.arange(lgs.shape[0], device=dev) - rfirst.index_select(0, lgs)
        rrec = recv.index_select(0, r_order)
        rok = (lgs < gps) & (rpos < R) & (rrec[:, 0] > 0)
        sg, sp, rr = lgs[rok], rpos[rok], rrec[rok]
        Xg = torch.zeros((gps, R, K), dtype=F64, device=dev)
        yg = torch.zeros((gps, R), dtype=F64, device=dev)
        vg = torch.zeros((gps, R), dtype=torch.bool, device=dev)
        Xg[sg, sp] = rr[:, 5:]
        yg[sg, sp] = rr[:, 4]
        vg[sg, sp] = rr[:, 3] > 0
        Xs.append(Xg.to(device()))
        ys.append(yg.to(device()))
        vs.append(vg.to(device()))
    return torch.cat(Xs), torch.cat(ys), torch.cat(vs), num_groups
