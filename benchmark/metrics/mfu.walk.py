"""The whole walk's share of the chip's peak: the model's operations in the
window (each forward counted at the visited pairs of its frame), over the
window's time and the configuration's compute peak (989 TFLOP/s in bf16) of
the chips used, in %."""


def read(r):
    if r["kind"] != "walk":
        return None
    return 100.0 * r["window_flops"] / (r["window_s"] * r["peak_flops"] * r["chips"])
