"""Device operations (kernels, copies, fills) per walk step in the profiled
slice of `trace_steps` walk steps, the batch's start and jumps included."""


def read(r):
    if r["kind"] != "walk":
        return None
    return len(r["slice"].device) / r["slice"].steps
