"""Host milliseconds to enqueue one `Denoiser.score` call (no
synchronisation), the mean over a slice of walk steps run without the
profiler."""


def read(r):
    return r.get("score_host_ms")
