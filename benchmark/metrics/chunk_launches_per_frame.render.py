"""CUDA kernel launches a frame inside the program's span
`kpnerf::render.chunk` (each chunk's coarse and fine march): what a CUDA
graph of the chunk would replace; nothing when the slice's chunks are not
the frames' chunks."""
from harness import spans


def read(ctx):
    got = spans.per_item(ctx, "render.chunk")
    return got[0] if got is not None and spans.chunks_whole(ctx) else None
