"""The per-layer metrics that read the program's spans (`harness/spans.py`),
on toy traced runs on the CPU: the slice holds each span as often as the
frames' chunks or the steps give, and each metric reads its span's
kernels a frame or a step. A CPU trace has no kernels, so each span is
given some here, as a card's trace would."""
import time

import pytest
from bench_toy import shrink

import run as runmod
from harness import spec, work

RENDER = {"cull_ms.render": "render.cull", "writeback_ms.render": "render.writeback",
          "lookup_ms.render": "query.lookup", "geo_mlp_ms.render": "query.geo",
          "ibr_ms.render": "query.ibr", "composite_ms.render": "march.composite"}
TRAIN = {"encode_ms.train": "encode", "forward_ms.train": "step.forward",
         "backward_ms.train": "step.backward", "optimizer_ms.train": "step.optimizer",
         "k1_ms.train": "onehot_dmap"}


def traced(name):
    from harness import cell

    return cell.run(name, 2**31 + 11, 0.5, True, time.perf_counter(), device="cpu",
                    shrink=shrink)


def with_kernels(rec, names):
    """The record with each span given 7 kernels and 3 ms a call."""
    s = rec["summary"]
    for n in names:
        c = s["calls"]["kpnerf::" + n]
        s["ranges"]["kpnerf::" + n] = (7 * c, 3e-3 * c)
    return rec


def layers(rec, workload):
    got = runmod.per_layer(rec, spec.cell_metrics(spec.manifest(), workload)[1])
    return {k: v for k, (v, _) in got.items()}


@pytest.fixture(scope="module")
def orbit():
    return traced("zju_fast.orbit256")


def test_render_spans_in_the_slice(orbit):
    cell, sl, s = orbit["cell"], orbit["slice"], orbit["summary"]
    chunks = len(work.frame_chunks(cell.m, cell.mix["frame_size"], cell.cfg["render"]["chunk"]))
    frames = sl["items"]
    assert frames == 1 and chunks >= 1
    calls = {k[len("kpnerf::"):]: v for k, v in s["calls"].items() if k.startswith("kpnerf::")}
    assert calls == {"encode": sl["encodes"], "render.cull": frames,
                     "render.chunk": frames * chunks, "render.writeback": 2 * frames,
                     **{n: 2 * frames * chunks for n in ("query.lookup", "query.geo",
                                                          "query.ibr", "march.composite")}}


def test_render_metrics_read_their_spans(orbit):
    names = ["render.chunk", *RENDER.values()]
    got = layers(with_kernels(orbit, names), "zju_fast.orbit256")
    calls = orbit["summary"]["calls"]
    for metric, span in RENDER.items():
        assert got[metric] == pytest.approx(3.0 * calls["kpnerf::" + span]), metric
    assert got["chunk_launches_per_frame.render"] == 7 * calls["kpnerf::render.chunk"]
    # a slice whose chunks are not the frames' reads no chunk metric
    calls["kpnerf::render.chunk"] += 1
    got = layers(orbit, "zju_fast.orbit256")
    assert not {"chunk_launches_per_frame.render", "lookup_ms.render",
                "composite_ms.render"} & set(got)
    assert "cull_ms.render" in got


def test_train_metrics_read_their_spans():
    rec = traced("zju.train")
    calls = rec["summary"]["calls"]
    assert {n: calls["kpnerf::" + n] for n in ("step.forward", "step.backward",
                                               "step.optimizer", "encode")} == dict.fromkeys(
        ("step.forward", "step.backward", "step.optimizer", "encode"), rec["slice"]["items"])
    # the CPU's map gradients are the plain version: no launch is counted
    assert calls["kpnerf::onehot_dmap"] == 6 * rec["slice"]["items"]
    assert rec["slice"]["counters"]["k1"] == 0
    got = layers(with_kernels(rec, TRAIN.values()), "zju.train")
    assert "k1_ms.train" not in got
    rec["slice"]["counters"]["k1"] = calls["kpnerf::onehot_dmap"]
    got = layers(rec, "zju.train")
    for metric, span in TRAIN.items():
        assert got[metric] == pytest.approx(3.0 * calls["kpnerf::" + span]), metric
    assert got["optimizer_launches_per_step.train"] == 7
