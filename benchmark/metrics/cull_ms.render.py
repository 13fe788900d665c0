"""Device time of the empty-ray cull a frame, in ms: the kernels launched
inside the program's span `kpnerf::render.cull` (the empty-ray scores, the
budget's overflow and the top-k of the rays marched)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "render.cull")
