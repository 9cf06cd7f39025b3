"""Device milliseconds per training step of the operations launched inside
`jamun.train.backward` (autograd's backward, whose kernels its device
thread launches) in the profiled slice. Nothing where the program has no
spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "train")
    return 1e3 * s.device_s_in("jamun.train.backward") / s.steps if s else None
