"""CUDA kernel launches in one frame: the traced slice's kernels over its
frames, the encode's included where the slice holds one (host dispatch
pressure; CUDA graphs and fusion lower it)."""


def read(ctx):
    s = ctx["summary"]
    return s["kernels"] / ctx["slice"]["items"] if s and ctx["slice"]["items"] else None
