"""Host milliseconds a select: the benchmark's own span from the
``select`` call until it returns (before the output is synchronised),
mean over the traced run's selects before the profiled stretch (the
profiler would inflate it)."""


def read(ctx):
    return sum(ctx.host_ms) / len(ctx.host_ms) if ctx.host_ms else None
