"""The whole training step's share of the chip's peak: the model's
operations in the window (forward and backward, three times the forward,
at each step's visited pairs), over the window's time and the peak of f32
outside the tensor cores (67 TFLOP/s; the port turns TF32 off) of the chips
used, in %."""


def read(r):
    if r["kind"] != "train":
        return None
    return 100.0 * r["window_flops"] / (r["window_s"] * r["peak_flops"] * r["chips"])
