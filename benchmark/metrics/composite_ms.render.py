"""Device time of the composite a frame, in ms: the kernels launched inside
the program's span `kpnerf::march.composite` (the coarse composite,
importance resampling, the fine cull's top-k, the merge, the fine
composite and its write); nothing when the slice's chunks are not the
frames' chunks."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "march.composite") if spans.chunks_whole(ctx) else None
