"""Device time of the IBR color head a frame, in ms: the kernels launched
inside the program's span `kpnerf::query.ibr` (the compressed geometry
latent, the ray-difference features and the head, coarse and fine
query); nothing when the slice's chunks are not the frames' chunks."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "query.ibr") if spans.chunks_whole(ctx) else None
