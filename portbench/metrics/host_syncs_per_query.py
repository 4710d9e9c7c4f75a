"""Host waits on the device a select: stream and device synchronisations
in the profiled stretch, less the benchmark's own one a select."""

from portbench.tracing import SYNC_CALLS


def read(ctx):
    s = ctx.stretch
    return (s.count(SYNC_CALLS) - s.selects) / s.selects
