"""The program's spans (`utils/profiling.span`, ranges `kpnerf::<name>`) on
the CPU at toy size, with no JAX program:

  * a fast-preset render (configs/zju_fast.json at toy geometry) under
    torch.profiler records exactly the render's spans, as many times as
    its chunks and queries give, with the query's spans and the composite
    inside a chunk;
  * a toy zju step records each `step.*` span once, and K1's span once a
    map gradient;
  * with no profiler recording, `span` is one shared no-op context, and a
    profiler started inside it records no span;
  * a render gives the same bits with the profiler on and off.

The serving export's graph holds no profiler op: tests/test_torch_export.py.
"""
import copy
import dataclasses
import math
import os

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch  # noqa: E402
from keypointnerf_torch.ops import onehot_dmap as k1  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402
from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn  # noqa
from keypointnerf_torch.utils import load_config, span  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 8, "model.patch_w": 8,
       "model.geo_n_downsample": 2, "model.tex_ngf": 16, "data.image_size": 32}
SIZE, CHUNK = 16, 32


@pytest.fixture(scope="module")
def vb():
    return ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), "cpu")


@pytest.fixture(scope="module")
def zju():
    """configs/zju.json's recipe at toy geometry and its model."""
    cfg = load_config(os.path.join(ROOT, "configs", "zju.json"),
                      {**TOY, "data.dataset": "synthetic"})
    model = KeypointNeRF(cfg.model, device="cpu", seed=0)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0     # radiance > 0
    return cfg, model


@pytest.fixture(scope="module")
def fast(zju):
    """The same weights under configs/zju_fast.json's model block."""
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json"), TOY)
    return zju[1].with_config(**dataclasses.asdict(cfg.model))


def _render(model, vb):
    return render_image(model, vb, height=SIZE, width=SIZE, chunk=CHUNK)


def _profiled(fn):
    """fn()'s result and the program's spans under the profiler: the
    `kpnerf::` ranges the program opens (user annotations), not the events
    of the registered ops it calls (`kpnerf::dense_act`, ...)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [e for e in prof.events() if e.name.startswith("kpnerf::") and e.is_user_annotation]
    return out, spans


def _calls(spans):
    calls = {}
    for e in spans:
        calls[e.name[len("kpnerf::"):]] = calls.get(e.name[len("kpnerf::"):], 0) + 1
    return calls


@pytest.fixture(scope="module")
def rendered(fast, vb):
    """The toy render with the profiler off, and on with its spans."""
    off = _render(fast, vb)
    on, spans = _profiled(lambda: _render(fast, vb))
    return off, on, spans


def test_render_spans_and_their_counts(fast, rendered):
    ratio = fast.cfg.cull_empty_rays_ratio
    assert ratio < 1.0
    chunks = math.ceil(math.ceil(SIZE * SIZE * ratio) / CHUNK)
    assert chunks == 2
    # two queries a chunk, coarse and fine; the chunks' outputs joined, then
    # the culled write-back
    assert _calls(rendered[2]) == {"encode": 1, "render.cull": 1, "render.chunk": chunks,
                                   "render.writeback": 2, "query.lookup": 2 * chunks,
                                   "query.geo": 2 * chunks, "query.ibr": 2 * chunks,
                                   "march.composite": 2 * chunks}


def test_query_and_composite_spans_lie_in_a_chunk(rendered):
    spans = rendered[2]
    chunk_ranges = [e.time_range for e in spans if e.name == "kpnerf::render.chunk"]
    for e in spans:
        inside = any(r.start <= e.time_range.start and e.time_range.end <= r.end
                     for r in chunk_ranges)
        assert inside == (e.name.startswith(("kpnerf::query.", "kpnerf::march.")) or
                          e.name == "kpnerf::render.chunk"), e.name


def test_render_bit_equal_with_profiler_on_and_off(rendered):
    off, on, _ = rendered
    assert off.keys() == on.keys() and all(torch.equal(off[k], on[k]) for k in off)
    assert bool(torch.isfinite(on["rgb_fine"]).all()) and float(on["acc_fine"].max()) > 0.0


def test_step_spans_and_k1_once_a_map_gradient(zju, vb, monkeypatch):
    cfg, model = zju
    assert cfg.model.train_matmul_gather_vjp
    model = copy.deepcopy(model)
    state = create_train_state(model, cfg.optim, VGG19Features(device="cpu", seed=42))
    draws = TrainDraws.sample(cfg.model, vb, torch.Generator().manual_seed(0))
    gradients = []
    plain = k1.onehot_dmap_plain

    def counting(*args, **kwargs):
        gradients.append(args[1].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(k1, "onehot_dmap_plain", counting)
    _, spans = _profiled(lambda: train_step_fn(model, cfg.loss, state, vb, draws))
    # the coarse, hires and texture maps' gradients of the coarse and the fine query
    assert len(gradients) == 6
    calls = _calls(spans)
    assert {k: calls.pop(k) for k in ("step.forward", "step.backward", "step.optimizer",
                                      "encode", "onehot_dmap")} == {
        "step.forward": 1, "step.backward": 1, "step.optimizer": 1, "encode": 1,
        "onehot_dmap": len(gradients)}
    assert set(calls) == {"query.lookup", "query.geo", "query.ibr", "march.composite"}


def test_span_without_profiler_is_one_shared_noop():
    a, b = span("render.chunk"), span("step.forward")
    assert a is b
    with a:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).add_(1.0)
    assert not [e for e in prof.events() if e.name.startswith("kpnerf::")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("render.chunk"):
            torch.ones(4).add_(1.0)
    assert [e.name for e in prof.events() if e.name.startswith("kpnerf::")] == [
        "kpnerf::render.chunk"]


def test_span_in_an_export_trace_is_the_noop():
    """Inside torch.export's trace a recording profiler gets the no-op too."""
    seen = []

    class Traced(torch.nn.Module):
        def forward(self, x):
            seen.append(span("render.chunk") is span("step.forward"))
            with span("render.chunk"):
                return x + 1.0

    with profile(activities=[ProfilerActivity.CPU]):
        torch.export.export(Traced(), (torch.ones(3),), strict=False)
        seen.append(span("render.chunk") is span("step.forward"))
    assert seen == [True, False]
