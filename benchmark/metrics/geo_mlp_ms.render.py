"""Device time of the geometry MLP a frame, in ms: the kernels launched
inside the program's span `kpnerf::query.geo` (validity, border weights,
the spatial encoding and the geometry MLP, coarse and fine query);
nothing when the slice's chunks are not the frames' chunks."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "query.geo") if spans.chunks_whole(ctx) else None
