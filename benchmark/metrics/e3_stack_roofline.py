"""K3's share of its roofline in the profiled slice: the least time the chip
needs for the slice's K3 launches at its published peaks (the larger of
operations over the compute type's peak and bytes over 3.35 TB/s, counted
from each forward's visited pairs), over the device time of the kernels
whose names hold `e3_stack`. Nothing where no such kernel ran."""


def read(r):
    bound = r.get("bounds", {}).get("e3_stack")
    measured = r["slice"].kernel_s(lambda name: "e3_stack" in name)
    if not bound or measured <= 0:
        return None
    return 100.0 * bound / measured
