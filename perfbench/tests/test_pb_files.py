"""BENCHMARK.json and the files it names keep to the benchmark's rules."""

import json
import re

import pytest

from perfbench import bench
from perfbench.tests.pb_tiny import ROOT

PB_FILE = ROOT / "BENCHMARK.json"


def benchmark():
    return bench.load_json(PB_FILE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "perfbench"


def test_top_level_keys():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in b["command"])
    assert len(json.dumps(b).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = benchmark()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer" or key in ("why", "layer"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells_and_metrics_resolve():
    b = benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        cell = bench.Cell.find(b, w["name"])
        assert w["chips"] == 1
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        reported = {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in b["end_to_end"] + b["per_layer"]:
        spec = bench.load_json(PB / "metrics" / f"{m['name']}.json")
        assert (PB / "readers" / f"{spec['reader']}.py").exists()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_metric_files_and_names_use_allowed_characters():
    for path in PB.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
    for path in (PB / "metrics").glob("*.json"):
        assert NAME.match(path.stem)


# text2vec-base-chinese's published config.json, its numbers and names
PUBLISHED = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "vocab_size": 21128, "max_position_embeddings": 512,
             "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
             "initializer_range": 0.02, "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1, "hidden_act": "gelu", "model_type": "bert"}


def test_config_files_hold_the_source_but_for_reduced():
    b = benchmark()
    for c in b["configs"]:
        cfg = bench.load_json(ROOT / c["file"])
        changed = {k for k, v in PUBLISHED.items() if cfg.get(k) != v}
        assert changed == set(c["reduced"]), (c["name"], changed)
        assert not {k for k in changed if k.endswith(("_size", "_dim", "_rank", "_heads"))}
