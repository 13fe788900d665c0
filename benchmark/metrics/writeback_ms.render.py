"""Device time of the write-back a frame, in ms: the kernels launched inside
the program's span `kpnerf::render.writeback` (the chunks' outputs joined,
and with the cull the packed row-gather onto every ray of the frame)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "render.writeback")
