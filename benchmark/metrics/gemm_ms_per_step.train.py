"""Device milliseconds per training step of the kernels whose names hold
`gemm` (cuBLAS's matrix products: the uvw product's per-path radial weights
and contractions) in the profiled slice."""


def read(r):
    if r["kind"] != "train":
        return None
    return 1e3 * r["slice"].kernel_s(lambda name: "gemm" in name.lower()) / r["slice"].steps
