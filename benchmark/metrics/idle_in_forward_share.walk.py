"""The share of the profiled slice's idle device time spent while the host
prepares a denoiser forward: idle gaps whose midpoint lies inside a
`jamun.denoiser.xhat` span, over all idle time, in %. Nothing where the
program has no spans or the device never idles."""

from benchmark.spans import find


def read(r):
    s = find(r, "walk")
    idle = sum(b - a for a, b in s.gaps()) * 1e-6 if s else 0.0
    return 100.0 * s.idle_in("jamun.denoiser.xhat") / idle if idle > 0 else None
