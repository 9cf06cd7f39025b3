"""Device milliseconds per training step of the operations launched inside
`jamun.train.forward` (the noise, the alignment and `training_loss`'s
forward) in the profiled slice. Nothing where the program has no spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "train")
    return 1e3 * s.device_s_in("jamun.train.forward") / s.steps if s else None
