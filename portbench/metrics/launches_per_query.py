"""Kernel launches a select: the runtime's launch calls in the profiled
stretch over its selects."""


def read(ctx):
    s = ctx.stretch
    return s.launches / s.selects
