"""Host milliseconds of one `Denoiser.score` call inside the profiled walk,
the mean duration of the program's `jamun.denoiser.score` spans: the
inside counterpart of `score_host_ms.walk`, higher by the profiler's own
cost per operator. Nothing where the program has no spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "walk")
    d = s.span_s("jamun.denoiser.score") if s else []
    return 1e3 * sum(d) / len(d) if d else None
