"""CUDA kernel launches in one training step: the traced slice's kernels
over its steps (host dispatch pressure; CUDA graphs and fusion lower it)."""


def read(ctx):
    s = ctx["summary"]
    return s["kernels"] / ctx["slice"]["items"] if s and ctx["slice"]["items"] else None
