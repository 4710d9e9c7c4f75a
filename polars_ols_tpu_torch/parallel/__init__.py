"""Multi-device distribution for the grouped least-squares engine.

See ``sharded`` for the mesh and its collectives: partial moments of rows
where they are, merged exactly by a reduce-scatter; shard-local solves,
coordinate descent and statistics; group-parallel whole-group solvers (the
moving models, the SVD); and the all-to-all row shuffle. The names are
those of the JAX package's ``parallel`` package.
"""

from .sharded import (
    fit_moments_sharded,
    make_mesh,
    mesh_row_axes,
    shard_group_axis,
    shuffle_rows_to_groups,
    solve_groups_sharded,
    statistics_moments_sharded,
)

__all__ = [
    "fit_moments_sharded",
    "make_mesh",
    "mesh_row_axes",
    "shard_group_axis",
    "shuffle_rows_to_groups",
    "solve_groups_sharded",
    "statistics_moments_sharded",
]
