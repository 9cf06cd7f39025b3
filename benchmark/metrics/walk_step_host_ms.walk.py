"""Host milliseconds of one walk update, the mean duration of the program's
`jamun.walk.step` spans in the profiled slice (the noise draw, the BAOAB
update with its denoiser call, the saved frame). Nothing where the program
has no spans."""

from benchmark.spans import find


def read(r):
    s = find(r, "walk")
    d = s.span_s("jamun.walk.step") if s else []
    return 1e3 * sum(d) / len(d) if d else None
