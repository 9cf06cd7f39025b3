"""The device's idle share of the profiled slice: one minus the union of its
busy intervals (kernels, copies, fills) over the slice's wall time, in %."""


def read(r):
    if r["kind"] != "walk":
        return None
    s = r["slice"]
    return 100.0 * (1.0 - s.busy_s / s.wall_s)
