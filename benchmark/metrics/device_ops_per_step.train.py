"""Device operations (kernels, copies, fills) per optimisation step in the
profiled slice of `trace_steps` steps of `Trainer.fit`."""


def read(r):
    if r["kind"] != "train":
        return None
    return len(r["slice"].device) / r["slice"].steps
