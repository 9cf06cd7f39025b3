"""K5's share of its roofline in the profiled slice: the least time the chip
needs for the slice's K5 launches (one per ConvBlock and forward) at its
published peaks, over the device time of the kernels whose names hold
`fused_block_tiled`. Nothing where no such kernel ran."""


def read(r):
    bound = r.get("bounds", {}).get("fused_block_tiled")
    measured = r["slice"].kernel_s(lambda name: "fused_block_tiled" in name)
    if not bound or measured <= 0:
        return None
    return 100.0 * bound / measured
