"""BENCHMARK.json and every file it names parse and keep the contract's
forms: names, units, keys, one file per configuration, mix, cell and
metric, and each per-layer metric's cells reporting what it moves."""
import json

from harness import spec

NAMES = ("name", "config", "traffic")


def bench():
    return spec.manifest()


def test_manifest_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            for k in NAMES:
                if k in e:
                    assert spec.NAME.match(e[k]), e[k]
            if "unit" in e:
                assert spec.UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
            key = (group if group in ("configs", "workloads") else "metric", e["name"])
            assert key not in seen
            seen.add(key)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_file_parses():
    b = bench()
    for c in b["configs"]:
        d = json.loads((spec.ROOT / c["file"]).read_text())
        assert d["name"] == c["name"] and d["source"] == c["source"]
        assert d["reduced"] == c["reduced"] == []
    for w in b["workloads"]:
        d = spec.data("workloads", w["name"])
        assert {k: d[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        spec.data("traffic", w["traffic"])
        assert set(d["limits"]) <= {"enc_gap", "grad_gap", "grad_med", "change_gap",
                                    "frame_ratio"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in b["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_per_layer_cells_report_what_they_move():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert all("setup_s" in e2e and c in e2e["setup_s"] for c in cells)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]] & cells
    for c in cells:
        got_e2e, got_layer = spec.cell_metrics(b, c)
        assert len(got_e2e) >= 2 and got_layer


def test_bounds():
    for m in bench()["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_at_published_widths():
    from reference.params import model_spec, n_params

    for name in ("zju", "zju_strict", "zju_fast"):
        m = spec.data("configs", name)["model"]
        assert n_params(model_spec(m)[0]) == 28_354_417
