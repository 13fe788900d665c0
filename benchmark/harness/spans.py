"""The program's own spans in a traced slice: the ranges `kpnerf::<name>`
that `keypointnerf_torch.utils.profiling.span` opens while a profiler
records (render.cull, render.chunk, query.geo, step.backward, ...).
`trace.reduce` gives each range the kernels whose launch it holds and
counts its calls; a program without the span has neither, and its
metric reads nothing."""
from __future__ import annotations

from . import work


def calls(ctx, name: str) -> int:
    s = ctx["summary"]
    return s["calls"].get("kpnerf::" + name, 0) if s else 0


def per_item(ctx, name: str):
    """(kernels, device seconds) inside the span, a step or a frame of the
    slice; None where the span has no call or launched no kernel."""
    s, items = ctx["summary"], ctx["slice"]["items"]
    got = s["ranges"].get("kpnerf::" + name) if s else None
    if not items or not calls(ctx, name) or got is None:
        return None
    return got[0] / items, got[1] / items


def ms(ctx, name: str):
    """Device ms a step or a frame inside the span."""
    got = per_item(ctx, name)
    return None if got is None else 1e3 * got[1]


def chunks_whole(ctx) -> bool:
    """Whether the slice's frames called `render.chunk` once a chunk that
    the configuration and the traffic give (`work.frame_chunks`)."""
    per_frame = len(work.frame_chunks(ctx["model"], ctx["mix"]["frame_size"],
                                      ctx["cfg"]["render"]["chunk"]))
    return calls(ctx, "render.chunk") == ctx["slice"]["items"] * per_frame
