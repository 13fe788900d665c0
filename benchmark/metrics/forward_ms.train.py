"""Device time of a training step's forward, in ms: the kernels launched
inside the program's span `kpnerf::step.forward` (the model's forward and
the losses with VGG)."""
from harness import spans


def read(ctx):
    return spans.ms(ctx, "step.forward")
