"""The device's idle share of the profiled stretch, in %: 1 - the union of
the device intervals over the stretch's wall time. The profiler slows the
host, so this reads higher than the untraced window would."""


def read(ctx):
    s = ctx.stretch
    return 100.0 * (1.0 - s.busy_s / s.wall_s) if s.wall_s > 0 else None
