"""Per-layer metrics, one reader a file (``metrics/<name>.py``).

The harness loads the file named after each per-layer metric that
``BENCHMARK.json`` gives the cell and calls its ``read(ctx)`` after the
traced run: ``ctx.stretch`` (``tracing.Stretch``), ``ctx.host_ms`` (the
benchmark's own host span of each select before the stretch, ms),
``ctx.rows_per_s`` (the frame's rows times the selects completed before
the stretch, over their seconds), ``ctx.cfg``, ``ctx.mix`` and
``ctx.counts`` (rows a group, from the benchmark's own keys). A reader that finds nothing to read returns None,
and the metric is left out of the line.

A quantity split over groups of cells that move different end-to-end
metrics, ``<quantity>.<part>`` (``host_ms_per_query.host_paced``), is read
by its quantity's reader where it has no file of its own.
"""

from pathlib import Path


def reader_file(metrics_dir: Path, name: str) -> Path:
    """The reader of the per-layer metric ``name`` in ``metrics_dir``."""
    own = metrics_dir / f"{name}.py"
    return own if own.is_file() else metrics_dir / f"{name.split('.', 1)[0]}.py"
