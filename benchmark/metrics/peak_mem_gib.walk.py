"""The window's peak of allocated device memory, in GiB
(`torch.cuda.max_memory_allocated` after a reset at the window's start)."""


def read(r):
    if r["kind"] != "walk" or not r.get("window_peak_bytes"):
        return None
    return r["window_peak_bytes"] / 2**30
