"""Rows a second in a cell where the host paces the select, as a per-layer
reading: the frame's rows times the selects completed in the traced run's
unprofiled half-window, over its seconds. The same quantity as the
end-to-end ``rows_per_s``, over half the window, for a cell whose runs
spread too widely between processes to bound it end to end."""


def read(ctx):
    return ctx.rows_per_s if ctx.rows_per_s > 0 else None
