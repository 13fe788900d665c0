"""Device time of the encode a training step, in ms: the kernels launched
inside the program's span `kpnerf::encode` (the forward's encoders;
their backward lies in `step.backward`)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "encode")
