"""Device time of one encode of the source views, in ms: the kernels
launched inside the benchmark's range `bench::encode` around the
program's `encode`, over the encodes in the traced slice."""


def read(ctx):
    s, n = ctx["summary"], ctx["slice"]["encodes"]
    if not s or not n or "bench::encode" not in s["ranges"]:
        return None
    return 1e3 * s["ranges"]["bench::encode"][1] / n
