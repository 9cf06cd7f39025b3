"""Device milliseconds per training step of the operations launched inside
`jamun.train.grad_norm`, `jamun.train.optimizer` and `jamun.train.ema` (the
gradient norm, the optimizer's update, the EMA) in the profiled slice.
Nothing where the program has no spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "train")
    if s is None:
        return None
    return 1e3 * s.device_s_in("jamun.train.grad_norm", "jamun.train.optimizer", "jamun.train.ema") / s.steps
