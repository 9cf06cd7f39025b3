"""The share of the profiled slice's wall time the host spends in its
intentional waits on the device (`jamun.host.wait:*` spans: the batch's
synchronisation, the unbatching copies, the graph mask's read), in %.
Nothing where the program has no spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "walk")
    return 100.0 * s.wall_in("jamun.host.wait:*") / s.wall_s if s else None
