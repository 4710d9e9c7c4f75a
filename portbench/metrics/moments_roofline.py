"""The share of its roofline that the kernels of ``rooflines/moments.py``
reach over the profiled stretch, in %."""

from portbench.rooflines import share


def read(ctx):
    return share(ctx, "moments")
