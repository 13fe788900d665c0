"""Device time of the query's lookups a frame, in ms: the kernels launched
inside the program's span `kpnerf::query.lookup` (the projection into the
source views and every map lookup, coarse and fine query); nothing when
the slice's chunks are not the frames' chunks."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "query.lookup") if spans.chunks_whole(ctx) else None
