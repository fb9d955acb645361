"""Host ms to draw one subgraph and build its layout: the sampler's iterator,
then compute_layout at the loop's edge budget, timed after the window."""
from portbench.lib.readers import host


def read(ctx):
    return host(ctx, "saint_host_ms")
